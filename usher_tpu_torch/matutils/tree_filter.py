"""Subtree extraction.

Parity: reference get_subtree (src/mutation_annotated_tree.cpp:1577-1660).
The pruning, polytomy and rerooting helpers of matUtils are not ported yet.
"""

from __future__ import annotations

import sys

from ..core.tree import Node, Tree


def _err(*a):
    print(*a, file=sys.stderr)


def _lca(a: Node, b: Node) -> Node:
    while a.level > b.level:
        a = a.parent
    while b.level > a.level:
        b = b.parent
    while a is not b:
        a = a.parent
        b = b.parent
    return a


def get_subtree(T: Tree, samples: list[str],
                keep_clade_annotations: bool = False) -> Tree:
    """Compressed induced subtree over the samples: kept nodes are the sample
    leaves plus all pairwise LCAs; edges compress intervening branches with
    add_mutation merging (reference mutation_annotated_tree.cpp:1577-1660).
    """
    sample_nodes = []
    for s in samples:
        n = T.get_node(s)
        if n is None:
            _err(f"ERROR: Sample {s} not found in the tree!")
        else:
            sample_nodes.append(n)
    T.depth_first_expansion()  # refresh dfs_idx
    sample_nodes.sort(key=lambda n: n.dfs_idx)
    keep: set[int] = {id(n) for n in sample_nodes}
    keep_nodes: dict[int, Node] = {id(n): n for n in sample_nodes}
    # pairwise LCAs = LCAs of DFS-consecutive selected leaves
    for a, b in zip(sample_nodes, sample_nodes[1:]):
        l = _lca(a, b)
        if id(l) not in keep:
            keep.add(id(l))
            keep_nodes[id(l)] = l

    num_annotations = T.get_num_annotations() if keep_clade_annotations else 0
    subtree = Tree()
    stack: list[tuple[Node, Node]] = []  # (orig kept node, new node)

    for n in T.depth_first_expansion():
        if id(n) not in keep:
            continue
        while stack and not (stack[-1][0].dfs_idx <= n.dfs_idx
                             < stack[-1][0].dfs_end_idx):
            stack.pop()
        if not stack:
            new_node = subtree.create_node(n.identifier, None, -1.0,
                                           num_annotations)
            # accumulate mutations from the original root down to n
            path = []
            cur = n
            while cur is not None:
                path.append(cur)
                cur = cur.parent
            for cur in reversed(path):
                for m in cur.mutations:
                    new_node.add_mutation(m.copy())
        else:
            parent_orig, parent_new = stack[-1]
            new_node = subtree.create_node(n.identifier,
                                           parent_new.identifier, -1.0,
                                           num_annotations)
            path = []
            cur = n
            while cur is not parent_orig:
                path.append(cur)
                cur = cur.parent
            for cur in reversed(path):
                for m in cur.mutations:
                    new_node.add_mutation(m.copy())
        if keep_clade_annotations:
            for k in range(min(num_annotations, len(n.clade_annotations))):
                if n.clade_annotations[k]:
                    new_node.clade_annotations[k] = n.clade_annotations[k]
        stack.append((n, new_node))
    return subtree
