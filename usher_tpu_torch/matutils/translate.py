"""Display rotation of a tree (the one piece of matUtils translate that the
subtree writers need; codon translation and the Taxodium export are not
ported yet)."""

from __future__ import annotations

from ..core.tree import Tree


def rotate_for_display(T: Tree, reverse: bool = False) -> None:
    """Sort children by descendant count (reference
    mutation_annotated_tree.cpp:1426-1453)."""
    dfs = T.depth_first_expansion()
    # the reference counts all descendants (not just leaves)
    counts: dict[str, int] = {}
    for n in reversed(dfs):
        counts[n.identifier] = 1 + sum(counts[c.identifier]
                                       for c in n.children)
    for n in dfs:
        n.children.sort(key=lambda c: counts[c.identifier],
                        reverse=not reverse)
