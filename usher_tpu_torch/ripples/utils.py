"""ripplesUtils: post-filter helpers for the recombination pipeline.

Parity with reference src/ripples/util/ (ripplesUtils.cpp, parse_data.cpp,
extract_formats.cpp): read combinedCatOnlyBestWithPVals.txt trios, emit
sample_paths.txt, allRelevantNodeNames.txt, nodeToParent.txt (+ the
no-underscore variant), and leaves.txt — the inputs of the 3SEQ-based
filtering scripts (scripts/recombination/filtering/).
"""

from __future__ import annotations

import os

from ..core.tree import Tree


def _strip_node(node_id: str) -> str:
    return node_id[5:] if node_id.startswith("node_") else node_id


def mutation_paths_no_label(T: Tree, samples) -> list[str]:
    """Root->sample mutation paths with '(N)' internal labels
    (extract_formats.cpp:62-88)."""
    out = ["sample_id\tpath_from_root"]
    for sample in samples:
        node = T.get_node(sample)
        if node is None:
            continue
        chain = list(reversed(T.rsearch(sample, True)))
        cpath = sample + "\t"
        for n in chain:
            cpath += ",".join(m.get_string() for m in n.mutations)
            if n is not chain[-1]:
                cpath += " (" + _strip_node(n.identifier)[0:] + ") > "
        out.append(cpath)
    return out


def generate_sample_paths(T: Tree, out_path: str) -> None:
    with open(out_path, "w") as f:
        for line in mutation_paths_no_label(T, T.get_leaves_ids()):
            f.write(line + "\n")


def leaves_per_node(T: Tree, out_path: str) -> None:
    """node_id (underscore-stripped) -> leaf count per DFS node
    (extract_formats.cpp:108-125)."""
    with open(out_path, "w") as f:
        for n in T.depth_first_expansion():
            f.write(f"{_strip_node(n.identifier)}\t{T.get_num_leaves(n)}\n")


def get_trios(T: Tree, pvals_path: str, data_dir: str) -> None:
    """Parse the recomb/donor/acceptor trios and write
    allRelevantNodeNames.txt + nodeToParent[_no_underscore].txt
    (parse_data.cpp:13-69, extract_formats.cpp:8-59)."""
    all_nodes: list[str] = []
    seen = set()
    need_parents: list[str] = []
    seen_parents = set()

    def _norm(v: str) -> str:
        return "node_" + v if v and v[0].isdigit() else v

    def _add(v: str):
        if v not in seen:
            seen.add(v)
            all_nodes.append(v)

    with open(pvals_path) as f:
        first = True
        for line in f:
            if first:
                first = False
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 8:
                continue
            recomb = _norm(fields[0])
            donor = _norm(fields[3])
            acceptor = _norm(fields[6])
            for v in (recomb, donor, acceptor):
                _add(v)
            if fields[4] == "y" and donor not in seen_parents:
                seen_parents.add(donor)
                need_parents.append(donor)
            if fields[7] == "y" and acceptor not in seen_parents:
                seen_parents.add(acceptor)
                need_parents.append(acceptor)

    with open(os.path.join(data_dir, "nodeToParent.txt"), "w") as fp, \
            open(os.path.join(data_dir, "nodeToParent_no_underscore.txt"),
                 "w") as fnu:
        fp.write("node\tparent\n")
        for nid in need_parents:
            node = T.get_node(nid)
            if node is None or node.parent is None:
                continue
            parent_id = node.parent.identifier
            _add(parent_id)
            fp.write(f"{node.identifier}\t{parent_id}\n")
            fnu.write(f"{_strip_node(node.identifier)}\t"
                      f"{_strip_node(parent_id)}\n")

    with open(os.path.join(data_dir, "allRelevantNodeNames.txt"), "w") as f:
        for nid in all_nodes:
            f.write(nid + "\n")


def ripples_utils_main(input_mat: str,
                       pvals_path: str = "filtering/data/"
                                         "combinedCatOnlyBestWithPVals.txt",
                       data_dir: str = "filtering/data") -> None:
    """Full ripplesUtils flow (ripplesUtils.cpp:6-45)."""
    from ..io.pbio import load_mat_pb
    os.makedirs(data_dir, exist_ok=True)
    T = load_mat_pb(input_mat)
    T.uncondense_leaves()
    generate_sample_paths(T, os.path.join(data_dir, "sample_paths.txt"))
    get_trios(T, pvals_path, data_dir)
    leaves_per_node(T, os.path.join(data_dir, "leaves.txt"))
