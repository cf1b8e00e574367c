"""Sample / clade mutation path strings (reference src/matUtils/describe.cpp)."""

from __future__ import annotations

from ..core.tree import Tree


def mutation_paths(T: Tree, samples: list[str]) -> list[str]:
    """Per sample: 'name\\tnode:muts node:muts ...' root->leaf
    (reference describe.cpp:3-26)."""
    out = []
    for sample in samples:
        node = T.get_node(sample)
        if node is None:
            continue
        chain = []
        cur = node
        while cur is not None:
            if cur.mutations:
                chain.append(cur.identifier + ":"
                             + ",".join(m.get_string() for m in cur.mutations))
            cur = cur.parent
        out.append(sample + "\t" + " ".join(reversed(chain)))
    return out


def clade_paths(T: Tree, clades: list[str] | None = None) -> list[str]:
    """Per clade root: 'clade\\troot_id\\tpath' (reference describe.cpp:28-80);
    only the first (deepest-rooted, BFS-first) node per clade is reported."""
    out = []
    wanted = set(clades) if clades else None
    seen: set[str] = set()
    for node in T.breadth_first_expansion():
        for ann in node.clade_annotations:
            if not ann or ann in seen:
                continue
            if wanted is not None and ann not in wanted:
                continue
            seen.add(ann)
            chain = []
            cur = node
            while cur is not None:
                if cur.mutations:
                    chain.append(cur.identifier + ":"
                                 + ",".join(m.get_string()
                                            for m in cur.mutations))
                cur = cur.parent
            out.append(ann + "\t" + node.identifier + "\t"
                       + " ".join(reversed(chain)))
    return out


def all_paths(T: Tree) -> list[str]:
    """Every node's own mutations in DFS order (reference extract -A,
    describe.cpp)."""
    out = []
    for node in T.depth_first_expansion():
        muts = ",".join(m.get_string() for m in node.mutations)
        out.append(f"{node.identifier}: {muts}")
    return out
