"""Lock-discipline rules (counterpart of ``repro.analysis.locks``).

``lock-order``
    The serving stack's threads (async-engine worker, fleet receiver /
    monitor threads, client submitters) share a handful of class-level
    locks: ``Scheduler.cv``, ``ServeMetrics._lock``,
    ``FleetRouter._lock``, the per-replica send locks.  A deadlock
    needs two threads acquiring two of them in opposite orders, so the
    invariant is: the *static* lock-acquisition graph (edge ``H -> N``
    whenever ``N`` can be acquired while ``H`` is held, including
    through calls) stays acyclic.  This pass rebuilds that graph from
    the AST with light repo-aware type inference — constructor
    assignments (``self.scheduler = Scheduler(...)``), parameter
    annotations (``engine: DiffusionEngine``), and attribute
    propagation (``self.metrics = engine.metrics``) — and reports any
    directed cycle.  ``Condition(self._lock)`` aliases to the
    underlying lock's node; re-acquiring the same node is ignored
    (RLock reentrancy / Condition methods).

``future-guard``
    ``Future.set_result`` / ``set_exception`` resolve a future exactly
    once; a second call raises ``InvalidStateError`` *in the worker
    thread*, killing it silently.  The fleet makes double resolution a
    real event (a replica dies after sending a result whose request
    was already requeued), so the router's ``_finish`` absorbs it with
    ``try/except InvalidStateError`` and counts ``duplicate_results``.
    This rule flags any ``set_result``/``set_exception`` call not
    lexically inside that pattern or an ``if ... fut.done() ...`` /
    ``set_running_or_notify_cancel`` guard.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.core import Finding, Module, Project
from repro_torch.analysis.graphs import find_cycle

__all__ = ["run"]

_LOCK_CTORS = {"Lock", "RLock", "make_lock", "make_rlock"}
_COND_CTORS = {"Condition", "make_condition"}


def run(project: Project, findings: List[Finding]) -> None:
    classes = _collect_classes(project)
    _propagate_attr_types(classes)
    _lock_order(project, classes, findings)
    _future_guard(project, findings)


# --- class model ---------------------------------------------------------

class _ClassInfo:
    def __init__(self, name: str, node: ast.ClassDef, mod: Module):
        self.name = name
        self.node = node
        self.mod = mod
        self.lock_attrs: Dict[str, str] = {}   # attr -> graph node name
        self.attr_types: Dict[str, str] = {}   # attr -> class name
        # attr -> element class for List[T]/Dict[_, T]-annotated attrs
        # (so `for r in self.replicas:` types r as Replica)
        self.attr_elem: Dict[str, str] = {}
        # attr -> (param, sub-attr) pending annotation-based resolution
        self.attr_from: Dict[str, Tuple[str, Optional[str]]] = {}
        self.methods: Dict[str, ast.FunctionDef] = {}
        self.param_ann: Dict[str, Dict[str, str]] = {}  # method -> {p: T}


def _ctor_name(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _ann_name(ann: Optional[ast.AST]) -> Optional[str]:
    if isinstance(ann, ast.Name):
        return ann.id
    if isinstance(ann, ast.Attribute):
        return ann.attr
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.split(".")[-1].strip("\"' ")
    if isinstance(ann, ast.Subscript):      # Optional[T] / List[T]
        return _ann_name(ann.slice)
    return None


def _collect_classes(project: Project) -> Dict[str, _ClassInfo]:
    classes: Dict[str, _ClassInfo] = {}
    for mod in project.modules:
        if mod.tree is None:
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            info = classes.setdefault(
                node.name, _ClassInfo(node.name, node, mod))
            for item in node.body:
                if isinstance(item, ast.FunctionDef):
                    info.methods[item.name] = item
                    anns: Dict[str, str] = {}
                    for a in (item.args.posonlyargs + item.args.args
                              + item.args.kwonlyargs):
                        t = _ann_name(a.annotation)
                        if t:
                            anns[a.arg] = t
                    info.param_ann[item.name] = anns
                # dataclass-style lock field:
                #   _lock: threading.Lock = field(default_factory=...)
                if isinstance(item, ast.AnnAssign) and \
                        isinstance(item.target, ast.Name):
                    t = _ann_name(item.annotation)
                    if t in ("Lock", "RLock"):
                        info.lock_attrs[item.target.id] = \
                            f"{node.name}.{item.target.id}"
            _collect_self_assigns(info)
    return classes


def _collect_self_assigns(info: _ClassInfo) -> None:
    plain: List[Tuple[str, ast.Call]] = []
    conds: List[Tuple[str, ast.Call]] = []
    for fn in info.methods.values():
        for stmt in ast.walk(fn):
            # self.replicas: List[Replica] = [] — remember the element
            # type so loop variables over the container resolve
            if isinstance(stmt, ast.AnnAssign) and \
                    isinstance(stmt.target, ast.Attribute) and \
                    isinstance(stmt.target.value, ast.Name) and \
                    stmt.target.value.id == "self":
                if isinstance(stmt.annotation, ast.Subscript):
                    t = _ann_name(stmt.annotation)
                    if t:
                        info.attr_elem.setdefault(stmt.target.attr, t)
                else:
                    t = _ann_name(stmt.annotation)
                    if t:
                        info.attr_types.setdefault(stmt.target.attr, t)
                continue
            if not (isinstance(stmt, ast.Assign)
                    and len(stmt.targets) == 1):
                continue
            tgt = stmt.targets[0]
            if not (isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"):
                continue
            val = stmt.value
            if isinstance(val, ast.Call):
                ctor = _ctor_name(val.func)
                if ctor in _LOCK_CTORS:
                    plain.append((tgt.attr, val))
                    continue
                if ctor in _COND_CTORS:
                    conds.append((tgt.attr, val))
                    continue
            _record_attr_source(info, tgt.attr, val)
    for attr, _call in plain:
        info.lock_attrs[attr] = f"{info.name}.{attr}"
    for attr, call in conds:
        # Condition(self.X) / make_condition(name, lock=self.X) share
        # X's node; a Condition over its own (R)Lock gets its own
        node = f"{info.name}.{attr}"
        inner = None
        for cand in list(call.args[:2]) + [
                kw.value for kw in call.keywords if kw.arg == "lock"]:
            if isinstance(cand, ast.Attribute) and \
                    isinstance(cand.value, ast.Name) and \
                    cand.value.id == "self" and \
                    cand.attr in info.lock_attrs:
                inner = info.lock_attrs[cand.attr]
        info.lock_attrs[attr] = inner or node


def _record_attr_source(info: _ClassInfo, attr: str,
                        val: ast.AST) -> None:
    # self.X = ClassName(...)  -> type known immediately (validated
    # against the project class table during propagation)
    if isinstance(val, ast.Call):
        ctor = _ctor_name(val.func)
        if ctor:
            info.attr_types.setdefault(attr, ctor)
        return
    # self.X = param  /  self.X = param.attr  -> resolve via annotation
    if isinstance(val, ast.Name):
        info.attr_from.setdefault(attr, (val.id, None))
    elif isinstance(val, ast.Attribute) and \
            isinstance(val.value, ast.Name):
        info.attr_from.setdefault(attr, (val.value.id, val.attr))


def _propagate_attr_types(classes: Dict[str, _ClassInfo]) -> None:
    # drop ctor "types" that aren't project classes (e.g. dict(), Event())
    for info in classes.values():
        info.attr_types = {a: t for a, t in info.attr_types.items()
                           if t in classes}
        info.attr_elem = {a: t for a, t in info.attr_elem.items()
                          if t in classes}
    changed = True
    while changed:
        changed = False
        for info in classes.values():
            for attr, (param, sub) in info.attr_from.items():
                if attr in info.attr_types or attr in info.lock_attrs:
                    continue
                anns = info.param_ann.get("__init__", {})
                ptype = anns.get(param)
                if ptype is None or ptype not in classes:
                    continue
                if sub is None:
                    info.attr_types[attr] = ptype
                    changed = True
                else:
                    src = classes[ptype]
                    if sub in src.lock_attrs:
                        info.lock_attrs[attr] = src.lock_attrs[sub]
                        changed = True
                    elif sub in src.attr_types:
                        info.attr_types[attr] = src.attr_types[sub]
                        changed = True


# --- lock-order graph ----------------------------------------------------

class _FnScan:
    """One method's acquisitions, edges, and guarded call sites."""

    def __init__(self, cls: _ClassInfo, fn: ast.FunctionDef,
                 classes: Dict[str, _ClassInfo]):
        self.cls = cls
        self.fn = fn
        self.classes = classes
        self.env: Dict[str, str] = dict(
            cls.param_ann.get(fn.name, {}))
        self.env["self"] = cls.name
        self.acquires: Set[str] = set()
        # (held, lock) pairs with a representative source location
        self.edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
        # calls made while holding >= 1 lock: (callee, held, loc)
        self.calls: List[Tuple[Tuple[str, str], Tuple[str, ...],
                               Tuple[str, int]]] = []
        for stmt in fn.body:
            self._scan(stmt, ())

    # -- resolution -------------------------------------------------------
    def _lock_node(self, expr: ast.AST) -> Optional[str]:
        if not isinstance(expr, ast.Attribute):
            return None
        base_t = self._expr_type(expr.value)
        if base_t is None:
            return None
        info = self.classes.get(base_t)
        if info is None:
            return None
        return info.lock_attrs.get(expr.attr)

    def _expr_type(self, expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Name):
            return self.env.get(expr.id)
        if isinstance(expr, ast.Attribute):
            base_t = self._expr_type(expr.value)
            if base_t and base_t in self.classes:
                return self.classes[base_t].attr_types.get(expr.attr)
        return None

    def _elem_type(self, expr: ast.AST) -> Optional[str]:
        """Element type of a container expression (List[T] attrs)."""
        if isinstance(expr, ast.Attribute):
            base_t = self._expr_type(expr.value)
            if base_t and base_t in self.classes:
                return self.classes[base_t].attr_elem.get(expr.attr)
        return None

    def _callee(self, call: ast.Call) -> Optional[Tuple[str, str]]:
        f = call.func
        if isinstance(f, ast.Attribute):
            base_t = self._expr_type(f.value)
            if base_t and base_t in self.classes and \
                    f.attr in self.classes[base_t].methods:
                return (base_t, f.attr)
        return None

    # -- walk -------------------------------------------------------------
    def _scan(self, node: ast.AST, held: Tuple[str, ...]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return   # nested scope: different env; conservatively skip
        if isinstance(node, ast.With):
            newheld = held
            for item in node.items:
                self._scan(item.context_expr, newheld)
                lock = self._lock_node(item.context_expr)
                if lock is None:
                    continue
                if lock not in newheld:   # reentrant re-acquire is a no-op
                    for h in newheld:
                        self.edges.setdefault(
                            (h, lock),
                            (self.cls.mod.rel, item.context_expr.lineno))
                    self.acquires.add(lock)
                    newheld = newheld + (lock,)
            for stmt in node.body:
                self._scan(stmt, newheld)
            return
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            # track `sched = self.scheduler`-style local aliases
            t = self._expr_type(node.value)
            if t is not None:
                self.env[node.targets[0].id] = t
        if isinstance(node, (ast.For, ast.comprehension)) and \
                isinstance(node.target, ast.Name):
            # `for r in self.replicas:` — element type from List[T]
            elem = self._elem_type(node.iter)
            if elem is not None:
                self.env[node.target.id] = elem
        if isinstance(node, ast.Call):
            callee = self._callee(node)
            if callee is not None:
                self.calls.append(
                    (callee, held,
                     (self.cls.mod.rel, node.lineno)))
            # explicit .acquire() outside a with-statement
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "acquire":
                lock = self._lock_node(node.func.value)
                if lock is not None and lock not in held:
                    for h in held:
                        self.edges.setdefault(
                            (h, lock), (self.cls.mod.rel, node.lineno))
                    self.acquires.add(lock)
        for child in ast.iter_child_nodes(node):
            self._scan(child, held)


def _lock_order(project: Project, classes: Dict[str, _ClassInfo],
                findings: List[Finding]) -> None:
    scans: Dict[Tuple[str, str], _FnScan] = {}
    for info in classes.values():
        for name, fn in info.methods.items():
            scans[(info.name, name)] = _FnScan(info, fn, classes)

    # transitive closure: every lock a method may acquire, through calls
    closure: Dict[Tuple[str, str], Set[str]] = {
        k: set(s.acquires) for k, s in scans.items()}
    changed = True
    while changed:
        changed = False
        for key, scan in scans.items():
            acc = closure[key]
            for callee, _held, _loc in scan.calls:
                extra = closure.get(callee, set()) - acc
                if extra:
                    acc.update(extra)
                    changed = True

    # edge set: direct nesting plus held-across-call acquisitions
    edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
    for scan in scans.values():
        for edge, loc in scan.edges.items():
            edges.setdefault(edge, loc)
        for callee, held, loc in scan.calls:
            if not held:
                continue
            for lock in closure.get(callee, ()):
                for h in held:
                    if h != lock:
                        edges.setdefault((h, lock), loc)

    graph: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
    # deterministic order for stable cycle reports
    graph = {a: sorted(bs) for a, bs in sorted(graph.items())}

    cycle = find_cycle(graph)
    while cycle is not None:
        loc = edges.get((cycle[0], cycle[1]))
        path, line = loc if loc else ("<project>", 1)
        findings.append(Finding(
            path, line, "lock-order",
            "lock-acquisition cycle: " + " -> ".join(cycle)
            + " (two threads taking these in opposite orders deadlock)"))
        # remove one edge of the reported cycle and look for more
        graph[cycle[0]] = [b for b in graph[cycle[0]] if b != cycle[1]]
        cycle = find_cycle(graph)


# --- future-guard --------------------------------------------------------

def _catches_invalid_state(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    cands = t.elts if isinstance(t, ast.Tuple) else [t]
    for c in cands:
        if isinstance(c, ast.Name) and c.id in (
                "InvalidStateError", "Exception", "BaseException"):
            return True
        if isinstance(c, ast.Attribute) and c.attr == "InvalidStateError":
            return True
    return False


def _test_is_guard(test: ast.AST) -> bool:
    for sub in ast.walk(test):
        if isinstance(sub, ast.Call) and \
                isinstance(sub.func, ast.Attribute) and \
                sub.func.attr in ("done", "set_running_or_notify_cancel",
                                  "cancelled"):
            return True
    return False


class _FutureScan(ast.NodeVisitor):
    def __init__(self, mod: Module, findings: List[Finding]):
        self.mod = mod
        self.findings = findings
        self.guard_depth = 0

    def visit_Try(self, node: ast.Try) -> None:
        guarded = any(_catches_invalid_state(h) for h in node.handlers
                      if h.type is not None)
        if guarded:
            self.guard_depth += 1
        for stmt in node.body:
            self.visit(stmt)
        if guarded:
            self.guard_depth -= 1
        for part in (node.handlers, node.orelse, node.finalbody):
            for stmt in part:
                self.visit(stmt)

    def visit_If(self, node: ast.If) -> None:
        guarded = _test_is_guard(node.test)
        if guarded:
            self.guard_depth += 1
        for stmt in node.body:
            self.visit(stmt)
        if guarded:
            self.guard_depth -= 1
        for stmt in node.orelse:
            self.visit(stmt)

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Attribute) and \
                f.attr in ("set_result", "set_exception") and \
                self.guard_depth == 0:
            self.mod.flag(
                node, "future-guard",
                f"unguarded {f.attr}(): a requeue race can resolve the "
                "future twice and InvalidStateError kills the calling "
                "thread; wrap in try/except InvalidStateError and count "
                "duplicate_results (see FleetRouter._finish) or guard "
                "with `if not fut.done()`",
                self.findings)
        self.generic_visit(node)


def _future_guard(project: Project, findings: List[Finding]) -> None:
    for mod in project.modules:
        if mod.tree is None:
            continue
        _FutureScan(mod, findings).visit(mod.tree)
