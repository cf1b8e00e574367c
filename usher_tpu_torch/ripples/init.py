"""ripplesInit: pre-ripples run sizing + Chronumental node-id map.

Parity with reference src/ripples/init/{main.cpp,init_pipeline.cpp}:
count the long branches the recombination scan will consider (printed to
stdout for GCP job partitioning, scripts/recombination/run.py:29-40) and
write ripples_to_chron_ids.txt mapping the MAT's depth-first ids to
Chronumental's stack-preorder ids.
"""

from __future__ import annotations

from ..core.tree import Tree


def write_chronumental_id_map(T: Tree,
                              path: str = "ripples_to_chron_ids.txt") -> None:
    """Chronumental traverses with a stack pushing children in order (so it
    visits the LAST child first); the MAT's depth_first_expansion visits the
    first child first.  The map pairs the two orders positionally
    (init_pipeline.cpp:8-46)."""
    root = T.root
    if root is None:
        raise ValueError("ERROR: Empty tree!")
    preorder = []
    stack = [root]
    while stack:
        node = stack.pop()
        preorder.append(node)
        for child in node.children:
            stack.append(child)
    dfs = T.depth_first_expansion()
    if len(dfs) != len(preorder):
        raise ValueError("ERROR: Traversal sizes not matching.")
    with open(path, "w") as f:
        f.write("MAT_node_id\tchronumental_node_id\n")
        for a, b in zip(dfs, preorder):
            f.write(f"{a.identifier}\t{b.identifier}\n")


def count_long_branches(T: Tree, branch_len: int = 3,
                        num_descendants: int = 2) -> int:
    """Number of candidate recombinant nodes (branch >= branch_len mutations
    and >= num_descendants leaves; init_pipeline.cpp:48-80)."""
    count = 0
    for n in T.breadth_first_expansion():
        if n.parent is None:
            continue
        if len(n.mutations) >= branch_len and \
                T.get_num_leaves(n) >= num_descendants:
            count += 1
    return count
