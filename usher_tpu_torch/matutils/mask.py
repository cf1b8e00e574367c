"""matUtils mask: sample restriction, renaming, mutation masking, simplify,
node moving.

Parity with reference src/matUtils/mask.cpp (function file:line cited).
"""

from __future__ import annotations

import random
import sys
from collections import defaultdict

from ..core.tree import Mutation, Tree


def _err(*a):
    print(*a, file=sys.stderr)


def restrict_samples(T: Tree, samples_filename: str) -> None:
    """Mask mutations found only in subtrees made entirely of restricted
    samples (mask.cpp:802-905): such mutations become MASKED placeholders."""
    from .select import read_sample_names
    restricted = set(read_sample_names(samples_filename))
    for s in restricted:
        if T.get_node(s) is None:
            raise KeyError(f"ERROR: Sample missing in input MAT! ({s})")

    visited: set[str] = set()
    restricted_roots = []
    for cn in T.breadth_first_expansion():
        s = cn.identifier
        if s not in restricted or s in visited:
            continue
        curr = cn
        node = cn.parent
        while node is not None:
            leaves = T.get_leaves_ids(node.identifier)
            if any(l not in restricted for l in leaves):
                break
            visited.update(leaves)
            curr = node
            node = node.parent
        restricted_roots.append(curr)

    counts: dict[str, int] = defaultdict(int)
    for n in T.depth_first_expansion():
        for m in n.mutations:
            if not m.is_masked():
                counts[m.get_string()] += 1
    for r in restricted_roots:
        for n in T.depth_first_expansion(r):
            for m in n.mutations:
                if not m.is_masked():
                    counts[m.get_string()] -= 1
    for r in restricted_roots:
        for n in T.depth_first_expansion(r):
            for m in n.mutations:
                if not m.is_masked() and counts[m.get_string()] == 0:
                    _err(f"Masking mutation {m.get_string()} at node "
                         f"{n.identifier}")
                    m.position = -1
                    m.ref_nuc = 0
                    m.par_nuc = 0
                    m.mut_nuc = 0


def rename_samples(T: Tree, rename_filename: str) -> None:
    """old\\tnew per line (mask.cpp:679-705)."""
    with open(rename_filename) as f:
        for line in f:
            words = line.rstrip("\n").split("\t")
            if len(words) != 2:
                raise ValueError(
                    f"ERROR: Incorrect format for the renaming file: "
                    f"{rename_filename}!")
            if T.get_node(words[0]) is None:
                _err(f"WARNING: Node {words[0]} not found in the MAT.")
            else:
                T.rename_node(words[0], words[1])


def simplify_tree(T: Tree) -> None:
    """Strip identifying data: rename leaves to l<k> (shuffled, seed 0),
    clear leaf mutations, deduplicate resulting identical polytomy leaves
    (mask.cpp:635-677)."""
    leaves = T.get_leaves()
    rng = random.Random(0)
    rng.shuffle(leaves)
    for rid, l in enumerate(leaves):
        l.mutations = []
        T.rename_node(l.identifier, f"l{rid}")
    for l1_id in T.get_leaves_ids():
        l1 = T.get_node(l1_id)
        if l1 is None or l1.mutations:
            continue
        polytomy = [l2 for l2 in l1.parent.children
                    if l2.is_leaf() and T.get_node(l2.identifier) is not None
                    and not l2.mutations]
        for extra in polytomy[1:]:
            T.remove_node(extra.identifier, False)


def _match_mutations(target: Mutation, query: Mutation) -> bool:
    """N in the target matches anything (mask.cpp:707-726)."""
    if target.position != query.position:
        return False
    if target.ref_nuc != 0b1111 and target.par_nuc != query.par_nuc:
        return False
    if target.mut_nuc != 0b1111 and target.mut_nuc != query.mut_nuc:
        return False
    return True


def parse_mutation_string(s: str) -> Mutation:
    """'A123G' / 'N123N' style; N wildcards either side."""
    from ..core.nuc import nuc_id_from_char
    par = nuc_id_from_char(s[0])
    mut = nuc_id_from_char(s[-1])
    pos = int(s[1:-1])
    return Mutation(chrom="", position=pos, ref_nuc=par, par_nuc=par,
                    mut_nuc=mut)


def mask_mutations(T: Tree, mutations_filename: str) -> int:
    """Remove matching mutations everywhere (mask.cpp:746-800,
    restrictMutationsLocally global mode).  Returns #instances masked."""
    targets = []
    with open(mutations_filename) as f:
        for line in f:
            line = line.strip().split("\t")[0]
            if line:
                targets.append(parse_mutation_string(line))
    masked = 0
    for n in T.depth_first_expansion():
        keep = []
        for m in n.mutations:
            if any(_match_mutations(t, m) for t in targets):
                masked += 1
            else:
                keep.append(m)
        n.mutations = keep
    return masked


def move_nodes(T: Tree, node_filename: str) -> None:
    """node_id\\tnew_parent_id per line: re-graft (mask.cpp:967+)."""
    with open(node_filename) as f:
        for line in f:
            words = line.rstrip("\n").split("\t")
            if len(words) != 2:
                raise ValueError("ERROR: Incorrect format for the move "
                                 "nodes file")
            nid, pid = words
            if T.get_node(nid) is None or T.get_node(pid) is None:
                _err(f"WARNING: node {nid} or {pid} not found; skipping")
                continue
            T.move_node(nid, pid)


# --- local masking by SNP distance (reference mask.cpp:549-632) -------------

def read_diff_missing(diff_file: str) -> dict[str, list[tuple[int, int]]]:
    """Per-sample missing-data intervals (position, length) from a MAPLE
    diff file ('-' lines only; reference readDiff, mask.cpp:161-219)."""
    data: dict[str, list[tuple[int, int]]] = {}
    current = ""
    with open(diff_file) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            if line[0] == ">":
                current = line[1:]
                if current in data:
                    raise ValueError(
                        f"Duplicate samples detected, inspect diff file for "
                        f"sample: {current}")
                data[current] = []
            elif line[0] == "-":
                fields = line.split("\t")
                data[current].append((int(fields[1]), int(fields[2])))
    for v in data.values():
        v.sort()
    return data


def get_closest_samples(T: Tree, nid: str, max_dist: int) -> list[str]:
    """Leaves within `max_dist` SNP (path mutation-count) distance of the
    target leaf, excluding the target's own branch (reference
    get_closest_samples, select.cpp:577-660)."""
    import heapq
    target = T.get_node(nid)
    if target is None or target.parent is None:
        return []
    # Dijkstra over the undirected tree; edge (X, X.parent) costs
    # len(X.mutations)
    dist = {id(target.parent): 0}
    heap = [(0, 0, target.parent)]
    counter = 1
    out = []
    while heap:
        d, _, node = heapq.heappop(heap)
        if d > dist.get(id(node), 1 << 60):
            continue
        for ch in node.children:
            if ch is target:
                continue
            nd = d + len(ch.mutations)
            if nd <= max_dist and nd < dist.get(id(ch), 1 << 60):
                dist[id(ch)] = nd
                if ch.is_leaf():
                    out.append((nd, ch.identifier))
                else:
                    counter += 1
                    heapq.heappush(heap, (nd, counter, ch))
        p = node.parent
        if p is not None:
            nd = d + len(node.mutations)
            if nd <= max_dist and nd < dist.get(id(p), 1 << 60):
                dist[id(p)] = nd
                counter += 1
                heapq.heappush(heap, (nd, counter, p))
    out.sort()
    return [name for _, name in out]


def _merge_intervals(a: list[tuple[int, int]],
                     b: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Union of missing intervals (combine_missing, mask.cpp:329-450)."""
    merged = []
    for start, length in sorted(a + b):
        end = start + length
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(s, e) for s, e in merged]


def _mask_node_mutations(node, intervals: list[tuple[int, int]]) -> int:
    """Delete mutations inside any [start, end] interval (nodeComp,
    mask.cpp:220-328; bounds inclusive)."""
    if not node.mutations or not intervals:
        return 0
    import bisect
    starts = [s for s, _ in intervals]
    kept = []
    removed = 0
    for m in node.mutations:
        i = bisect.bisect_right(starts, m.position) - 1
        if i >= 0 and intervals[i][0] <= m.position <= intervals[i][1]:
            removed += 1
        else:
            kept.append(m)
    node.mutations = kept
    return removed


def local_mask(T: Tree, max_snp_distance: int, diff_file: str) -> int:
    """Post-placement local masking: for each leaf with missing data and a
    short terminal branch, delete mutations on paths to nearby samples that
    fall inside either sample's missing regions (localMask,
    mask.cpp:593-632).  Returns the number of masked mutations."""
    diff_data = read_diff_missing(diff_file)
    compared: dict[str, set[str]] = {}
    removed = 0
    for leaf in T.get_leaves():
        samp = leaf.identifier
        if len(leaf.mutations) >= max_snp_distance or samp not in diff_data:
            continue
        for neigh in get_closest_samples(T, samp, max_snp_distance):
            if neigh in compared.get(samp, ()):
                continue
            compared.setdefault(samp, set()).add(neigh)
            compared.setdefault(neigh, set()).add(samp)
            intervals = _merge_intervals(diff_data.get(samp, []),
                                         diff_data.get(neigh, []))
            if not intervals:
                continue
            neigh_node = T.get_node(neigh)
            if neigh_node is None:
                continue
            from .tree_filter import _lca
            mrca = _lca(leaf, neigh_node)
            cur = neigh_node
            while cur is not None and cur is not mrca:
                removed += _mask_node_mutations(cur, intervals)
                cur = cur.parent
            cur = leaf
            while cur is not None and cur is not mrca:
                removed += _mask_node_mutations(cur, intervals)
                cur = cur.parent
            if mrca is not None:
                removed += _mask_node_mutations(mrca, intervals)
    return removed
