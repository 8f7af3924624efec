"""Linter core: file discovery, AST parsing, suppressions, reporting
(counterpart of ``repro.analysis.core``; stdlib only).

The unit of work is a :class:`Module` (path + source + AST + suppression
table); a :class:`Project` parses every module once and hands the whole
set to each rule pass, so repo-aware passes (the lock graph) can see
across files without re-parsing.

Suppressions: ``# repro: allow[rule-name]: justification``.  The
justification is mandatory — a bare ``allow[rule]`` is itself reported
(``bad-suppression``), as is an unknown rule name, so suppressions
can't silently rot.  A suppression covers the statement it sits on
(its full ``lineno..end_lineno`` extent when it sits on the first
line); a comment-only line covers the following line.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

__all__ = [
    "Finding", "Module", "Project", "RULES", "analyze_paths",
]

# every rule a pass can emit; suppressions naming anything else are
# flagged as bad-suppression.  The reference's ``unhashable-static-arg``,
# ``traced-branch`` (both about ``jax.jit``) and ``donated-reuse`` (JAX
# buffer donation) mean nothing to an eager port and are left out.
RULES = (
    "env-read-at-import",
    "lock-order",
    "future-guard",
    "bad-suppression",
    "parse-error",
)

_ALLOW_RE = re.compile(
    r"#\s*repro:\s*allow\[([A-Za-z0-9_-]+)\]\s*(?::\s*(\S.*))?$")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One reported violation, formatted ``path:line: [rule] message``."""
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclasses.dataclass
class _Suppression:
    rule: str
    line: int            # line the comment sits on
    justification: str
    used: bool = False


class Module:
    """One parsed source file plus its suppression table."""

    def __init__(self, path: Path, root: Path):
        self.path = path
        # report paths relative to the lint root so CI output is stable
        try:
            self.rel = str(path.relative_to(root))
        except ValueError:
            self.rel = str(path)
        self.source = path.read_text(encoding="utf-8")
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[str] = None
        try:
            self.tree = ast.parse(self.source, filename=self.rel)
        except SyntaxError as e:
            self.parse_error = f"syntax error: {e.msg} (line {e.lineno})"
        self.suppressions: List[_Suppression] = []
        self._comment_only: Dict[int, bool] = {}
        self._scan_comments()

    def _scan_comments(self) -> None:
        try:
            tokens = tokenize.generate_tokens(
                io.StringIO(self.source).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _ALLOW_RE.search(tok.string)
                if not m:
                    continue
                rule, why = m.group(1), (m.group(2) or "").strip()
                line = tok.start[0]
                # comment-only line: nothing but whitespace before the #
                only = tok.line[:tok.start[1]].strip() == ""
                self._comment_only[line] = only
                self.suppressions.append(_Suppression(rule, line, why))
        except tokenize.TokenError:
            pass  # parse-error finding already covers a broken file

    def suppressed(self, rule: str, first: int, last: int) -> bool:
        """True if ``rule`` is allowed anywhere on lines first..last,
        or by a comment-only ``allow`` on the line just above."""
        for s in self.suppressions:
            if s.rule != rule:
                continue
            covered = first <= s.line <= last
            if not covered and self._comment_only.get(s.line):
                covered = s.line == first - 1
            if covered:
                s.used = True
                return True
        return False

    def flag(self, node: ast.AST, rule: str, message: str,
             out: List[Finding]) -> None:
        """Report ``rule`` at ``node`` unless a suppression covers it."""
        first = getattr(node, "lineno", 1)
        last = getattr(node, "end_lineno", None) or first
        if not self.suppressed(rule, first, last):
            out.append(Finding(self.rel, first, rule, message))


class Project:
    """All modules under the lint roots, parsed once."""

    def __init__(self, paths: Sequence[Path], root: Path):
        self.root = root
        self.modules: List[Module] = [
            Module(p, root) for p in _discover(paths)]

    def by_name(self, suffix: str) -> Optional[Module]:
        for m in self.modules:
            if m.rel.endswith(suffix):
                return m
        return None


_SKIP_DIRS = {".git", "__pycache__", ".ruff_cache", "results",
              ".hypothesis", "build", "dist"}


def _discover(paths: Sequence[Path]) -> List[Path]:
    out: List[Path] = []
    seen = set()
    for p in paths:
        if p.is_file() and p.suffix == ".py":
            files: Iterable[Path] = [p]
        elif p.is_dir():
            files = sorted(
                f for f in p.rglob("*.py")
                if not any(part in _SKIP_DIRS for part in f.parts))
        else:
            files = []
        for f in files:
            key = f.resolve()
            if key not in seen:
                seen.add(key)
                out.append(f)
    return out


def analyze_paths(paths: Sequence[Path],
                  root: Optional[Path] = None) -> List[Finding]:
    """Run every pass over ``paths``; returns sorted findings."""
    # local imports keep `import repro_torch.analysis` free of ast
    # machinery
    from repro_torch.analysis import locks, recompile

    root = root or Path.cwd()
    project = Project(paths, root)
    findings: List[Finding] = []
    for mod in project.modules:
        if mod.parse_error:
            findings.append(
                Finding(mod.rel, 1, "parse-error", mod.parse_error))
    recompile.run(project, findings)
    locks.run(project, findings)
    _check_suppressions(project, findings)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def _check_suppressions(project: Project,
                        findings: List[Finding]) -> None:
    for mod in project.modules:
        for s in mod.suppressions:
            if s.rule not in RULES:
                findings.append(Finding(
                    mod.rel, s.line, "bad-suppression",
                    f"unknown rule {s.rule!r}; known rules: "
                    + ", ".join(RULES[:-2])))
            elif not s.justification:
                findings.append(Finding(
                    mod.rel, s.line, "bad-suppression",
                    f"allow[{s.rule}] needs a justification: "
                    f"`# repro: allow[{s.rule}]: why`"))


def summarize(findings: Sequence[Finding]) -> str:
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    parts = [f"{n} {r}" for r, n in sorted(counts.items())]
    return f"{len(findings)} finding(s): " + ", ".join(parts)
