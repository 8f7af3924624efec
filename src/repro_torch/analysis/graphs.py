"""Tiny directed-graph helpers of the runtime lock sanitizer (a copy of
``repro.analysis.graphs``, which the reference's static lock-order pass
shares).

A graph is a ``dict[node, set[node] | iterable[node]]``; nodes absent
from the dict are sinks.  Everything here is iterative (no recursion)
so adversarial inputs from the property tests can't hit the
interpreter's recursion limit.
"""
from __future__ import annotations

from typing import Dict, Hashable, Iterable, List, Optional, Set

Node = Hashable
Graph = Dict[Node, Iterable[Node]]

__all__ = ["find_cycle", "has_path", "would_close_cycle"]


def find_cycle(graph: Graph) -> Optional[List[Node]]:
    """Return one directed cycle as ``[n0, n1, ..., n0]``, or None.

    Deterministic: nodes and successors are visited in the order the
    mapping yields them, so the same graph always reports the same
    cycle (CI output is stable).
    """
    WHITE, GREY, BLACK = 0, 1, 2
    color: Dict[Node, int] = {}
    for root in graph:
        if color.get(root, WHITE) != WHITE:
            continue
        # stack of (node, iterator over successors); path mirrors the
        # grey chain so we can slice the cycle out when we hit it
        stack = [(root, iter(graph.get(root, ())))]
        color[root] = GREY
        path: List[Node] = [root]
        while stack:
            node, it = stack[-1]
            advanced = False
            for succ in it:
                c = color.get(succ, WHITE)
                if c == GREY:
                    return path[path.index(succ):] + [succ]
                if c == WHITE:
                    color[succ] = GREY
                    stack.append((succ, iter(graph.get(succ, ()))))
                    path.append(succ)
                    advanced = True
                    break
            if not advanced:
                color[node] = BLACK
                stack.pop()
                path.pop()
    return None


def has_path(graph: Graph, src: Node, dst: Node) -> bool:
    """True if ``dst`` is reachable from ``src`` (0 edges counts:
    ``has_path(g, x, x)`` is always True)."""
    if src == dst:
        return True
    seen: Set[Node] = {src}
    frontier = [src]
    while frontier:
        node = frontier.pop()
        for succ in graph.get(node, ()):
            if succ == dst:
                return True
            if succ not in seen:
                seen.add(succ)
                frontier.append(succ)
    return False


def would_close_cycle(graph: Graph, src: Node, dst: Node) -> bool:
    """True if adding edge ``src -> dst`` would create a cycle.

    The runtime sanitizer calls this *before* recording an acquisition
    edge, so the offending ``acquire`` can be refused while the graph
    still describes only orders that actually happened.
    """
    return has_path(graph, dst, src)
