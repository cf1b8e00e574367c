"""matUtils fix: repair grandparent-reversion artifacts.

Parity with reference src/matUtils/fix.cpp:43-98: a node whose single
mutation exactly reverts its grandparent's single mutation (N > A > B >
revA, parent also single-mutation) is moved to be a child of its
great-grandparent carrying the parent's mutation instead.
"""

from __future__ import annotations

import sys

from ..core.tree import Tree


def _err(*a):
    print(*a, file=sys.stderr)


def _fix_r(T: Tree, node, ggp, gp, p, min_descendents: int) -> int:
    descendent_count = 0
    for child_id in [c.identifier for c in node.children]:
        child = T.get_node(child_id)
        if child is not None:
            descendent_count += _fix_r(T, child, gp, p, node, min_descendents)
    if (ggp is not None and len(node.mutations) == 1
            and len(gp.mutations) == 1 and len(p.mutations) == 1):
        nm = node.mutations[0]
        gm = gp.mutations[0]
        if (nm.position == gm.position and nm.chrom == gm.chrom
                and nm.mut_nuc == gm.par_nuc and nm.par_nuc == gm.mut_nuc
                and descendent_count >= min_descendents):
            _err(f"Node {node.identifier} mutation {nm.get_string()} reverts "
                 f"grandparent {gp.identifier}'s {gm.get_string()}, moving "
                 f"to {ggp.identifier} with "
                 f"{p.mutations[0].get_string()} ({descendent_count} "
                 f"descendents)")
            node.mutations = [m.copy() for m in p.mutations]
            T.move_node(node.identifier, ggp.identifier)
    return descendent_count + 1


def fix_grandparent_reversions(T: Tree, iterations: int = 1,
                               min_descendent_count: int = 1) -> None:
    import sys as _sys
    old = _sys.getrecursionlimit()
    _sys.setrecursionlimit(max(old, 4 * T.get_max_level() + 1000))
    try:
        for _ in range(iterations):
            _fix_r(T, T.root, None, None, None, min_descendent_count)
    finally:
        _sys.setrecursionlimit(old)
