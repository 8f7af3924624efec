"""The environment rule of ``repro.analysis.recompile``; the file keeps
that module's name, and of its three rules ports only this one.

``env-read-at-import``
    ``os.environ``/``os.getenv`` *read* at module import time (module
    or class body, outside any function).  An import-frozen env read
    breaks the fleet: it sets per-replica env right before the child
    imports the module, and an import-time read freezes the value for
    the process lifetime.  The sanctioned shape is a call-time read or a
    PEP 562 module ``__getattr__``.  Writes
    (``setdefault``/``update``/``pop``/subscript store) are fine, as are
    reads feeding an ``os.environ`` write in the same statement.

The reference's other two rules in this module, ``unhashable-static-arg``
and ``traced-branch``, are about ``jax.jit``'s static arguments and
traced control flow; an eager port has neither, so they are left out
(``ROADMAP.md`` §3).
"""
from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.analysis.core import Finding, Module, Project

__all__ = ["run"]


def run(project: Project, findings: List[Finding]) -> None:
    for mod in project.modules:
        if mod.tree is None:
            continue
        _env_reads(mod, findings)


# --- env-read-at-import --------------------------------------------------

def _is_environ(node: ast.AST) -> bool:
    """Matches ``os.environ`` (and bare ``environ`` from-imports)."""
    if isinstance(node, ast.Attribute) and node.attr == "environ":
        return isinstance(node.value, ast.Name) and node.value.id == "os"
    return isinstance(node, ast.Name) and node.id == "environ"


def _env_read(node: ast.AST) -> Optional[ast.AST]:
    """Return the offending node if ``node`` reads the environment."""
    if isinstance(node, ast.Call):
        f = node.func
        # os.environ.get(...) / os.getenv(...)
        if isinstance(f, ast.Attribute):
            if f.attr == "get" and _is_environ(f.value):
                return node
            if f.attr == "getenv" and isinstance(f.value, ast.Name) \
                    and f.value.id == "os":
                return node
        if isinstance(f, ast.Name) and f.id == "getenv":
            return node
    if isinstance(node, ast.Subscript) and _is_environ(node.value) \
            and isinstance(node.ctx, ast.Load):
        return node
    return None


def _env_reads(mod: Module, findings: List[Finding]) -> None:
    # walk only import-time code: module body + class bodies, skipping
    # function/lambda bodies (those are call-time by definition)
    def visit_stmts(stmts):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(stmt, ast.ClassDef):
                visit_stmts(stmt.body)
                continue
            # reads that feed an os.environ write in the same statement
            # are the sanctioned append-to-XLA_FLAGS shape
            writes_env = any(
                isinstance(t, ast.Subscript) and _is_environ(t.value)
                for t in getattr(stmt, "targets", []))
            for node in ast.walk(stmt):
                if isinstance(node, ast.Lambda):
                    continue
                hit = _env_read(node)
                if hit is None:
                    continue
                if writes_env:
                    continue
                mod.flag(
                    hit, "env-read-at-import",
                    "os.environ read at module import time freezes the "
                    "value for the process; read it at call time "
                    "(an accessor function or a module __getattr__)",
                    findings)

    visit_stmts(mod.tree.body)  # type: ignore[union-attr]
