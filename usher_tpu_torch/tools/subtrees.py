"""Subtree extraction around newly placed samples (-k / -K outputs).

Reference: get_random_single_subtree / get_random_sample_subtrees
(mutation_annotated_tree.cpp:1693-1990): a single context subtree with
`subtree_size` random extra leaves (-K), or one subtree per not-yet-displayed
sample built from its nearest leaves by mutation distance plus a random
remainder (-k).  Each subtree gets a newick file, a per-node mutation list,
and (if any kept leaf is condensed) an expansion file.
"""

from __future__ import annotations

import os
import random
import sys

from ..core.tree import Tree
from ..io.newick import write_newick
from ..matutils.tree_filter import get_subtree
from ..matutils.translate import rotate_for_display


def _err(*a):
    print(*a, file=sys.stderr)


def _write_subtree_files(T: Tree, new_T: Tree, path_base: str,
                         retain_original_branch_len: bool) -> None:
    """newick + mutations (+ expanded condensed leaves) for one subtree
    (mutation_annotated_tree.cpp:1740-1783, 1932-1989)."""
    with open(path_base + ".nh", "w") as f:
        f.write(write_newick(new_T, print_internal=True, print_branch_len=True,
                             retain_original_branch_len=retain_original_branch_len))
    mut_path = path_base + "-mutations.txt"
    _err(f"Writing list of mutations at the nodes of the subtree to file "
         f"{mut_path}")
    with open(mut_path, "w") as f:
        for n in new_T.depth_first_expansion():
            f.write(f"{n.identifier}: ")
            f.write(",".join(m.get_string() for m in n.mutations))
            f.write("\n")
    expanded_lines = []
    for leaf in new_T.get_leaves():
        names = T.condensed_nodes.get(leaf.identifier)
        if names:
            expanded_lines.append(f"{leaf.identifier}: "
                                  + "".join(s + " " for s in names))
    if expanded_lines:
        exp_path = path_base + "-expanded.txt"
        _err(f"Subtree has condensed nodes.\nExpanding the condensed nodes "
             f"in file {exp_path}")
        with open(exp_path, "w") as f:
            f.write("\n".join(expanded_lines) + "\n")


def write_single_subtree(T: Tree, samples, outdir, subtree_size, tree_idx=0,
                         use_tree_idx=False,
                         retain_original_branch_len=False,
                         anchor_samples=()) -> None:
    """-K: one subtree containing every placed sample plus `subtree_size`
    random context leaves (mutation_annotated_tree.cpp:1693-1783).
    anchor_samples: always included for larger-scale context
    (reference --usher-anchor-samples, extract.cpp:105-106)."""
    preid = f"tree-{tree_idx}-" if use_tree_idx else ""
    keep = {n.identifier for s in samples
            for n in (T.get_node(s),) if n is not None}
    keep |= {n.identifier for s in anchor_samples
             for n in (T.get_node(s),) if n is not None}
    n_samples = len(keep)
    all_leaves = T.get_leaves()
    rng = random.Random(0)
    for _ in range(len(all_leaves)):
        keep.add(rng.choice(all_leaves).identifier)
        if len(keep) >= subtree_size + n_samples:
            break
    new_T = get_subtree(T, sorted(keep), keep_clade_annotations=False)
    rotate_for_display(new_T)
    path = os.path.join(outdir, preid + "single-subtree")
    _err(f"Writing single subtree with {subtree_size} randomly added leaves "
         f"to file {path}.nh.")
    _write_subtree_files(T, new_T, path, retain_original_branch_len)


def write_sample_subtrees(T: Tree, samples, outdir, subtree_size, tree_idx=0,
                          use_tree_idx=False,
                          retain_original_branch_len=False,
                          anchor_samples=()) -> None:
    """-k: per not-yet-displayed sample, a subtree of ~subtree_size leaves —
    4/5 nearest by mutation distance below the smallest ancestor with enough
    leaves, 1/5 random (mutation_annotated_tree.cpp:1785-1990)."""
    preid = f"tree-{tree_idx}-" if use_tree_idx else ""
    random_subtree_size = subtree_size // 5
    nearest_subtree_size = subtree_size - random_subtree_size
    rng = random.Random(0)

    displayed = [T.get_node(s) is None for s in samples]
    num_subtrees = 0
    for i, sample in enumerate(samples):
        if displayed[i]:
            continue
        last_anc = T.get_node(sample)
        leaves_to_keep: list[str] = []
        for anc in T.rsearch(sample, include_self=True):
            num_leaves = T.get_num_leaves(anc)
            if num_leaves < subtree_size:
                last_anc = anc
                continue
            if num_leaves > subtree_size:
                # all leaves under the last (too-small) ancestor, then the
                # nearest remaining leaves under anc by mutation distance
                leaves_to_keep = [l.identifier
                                  for l in T.get_leaves(last_anc.identifier)]
                in_last = set(leaves_to_keep)
                node_distances = []
                for order, l in enumerate(T.get_leaves(anc.identifier)):
                    if l.identifier in in_last:
                        continue
                    dist = 0
                    cur = l
                    while cur is not None and cur is not anc:
                        dist += len(cur.mutations)
                        cur = cur.parent
                    node_distances.append((dist, order, l.identifier))
                node_distances.sort(key=lambda t: (t[0], t[1]))
                for _, _, lid in node_distances[:max(
                        0, nearest_subtree_size - len(leaves_to_keep))]:
                    leaves_to_keep.append(lid)
                if (nearest_subtree_size < subtree_size
                        and nearest_subtree_size < len(node_distances)):
                    remaining = node_distances[nearest_subtree_size:]
                    rng.shuffle(remaining)
                    for _, _, lid in remaining:
                        if len(leaves_to_keep) >= subtree_size:
                            break
                        leaves_to_keep.append(lid)
            else:
                leaves_to_keep = [l.identifier
                                  for l in T.get_leaves(anc.identifier)
                                  ][:subtree_size]

            for aid in anchor_samples:
                if T.get_node(aid) is not None and aid not in leaves_to_keep:
                    leaves_to_keep.append(aid)
            new_T = get_subtree(T, leaves_to_keep,
                                keep_clade_annotations=False)
            rotate_for_display(new_T)
            for j in range(i + 1, len(samples)):
                if not displayed[j] and new_T.get_node(samples[j]) is not None:
                    displayed[j] = True
            num_subtrees += 1
            path = os.path.join(outdir, f"{preid}subtree-{num_subtrees}")
            _err(f"Writing subtree {num_subtrees} to file {path}.nh.")
            _write_subtree_files(T, new_T, path, retain_original_branch_len)
            break
