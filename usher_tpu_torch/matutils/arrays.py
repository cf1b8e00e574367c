"""matUtils over MatArrays: pandemic-scale queries without host Node
objects.

The Tree-backed matUtils modules build a full Python Tree (~minutes and
GBs at the reference's >2M-leaf public MAT).  These functions answer the
common summary queries straight off the flat arrays loaded by
io/pb_arrays.py, byte-identical to the Tree path (which uncondenses
before reporting — the expansion is replayed here over index lists, in
Tree.uncondense_leaves' exact order, core/tree.py:467-497).

Reference schemas: src/matUtils/summary.cpp (cited per writer in
matutils/summary.py).
"""

from __future__ import annotations

import os
import sys
from collections import defaultdict

import numpy as np

from ..core.nuc import char_from_nuc_id, nt_from_nuc_id


def _children_lists(ma):
    """(names, mut_idx ranges, parent list, children lists, root) with the
    loaded condensed nodes expanded (Tree.uncondense_leaves semantics:
    with-mutations groups keep the node as a fresh internal; plain groups
    rename in place and append the rest under the parent)."""
    n = ma.n
    parent = ma.parent.astype(np.int64).tolist()
    names = ma.names()
    # slots are DFS preorder: children in slot order == host child order
    nr = np.nonzero(np.arange(n) != ma.parent)[0]
    order = nr[np.argsort(ma.parent[nr], kind="stable")]
    children: list[list[int]] = [[] for _ in range(n)]
    for s in order.tolist():
        children[int(ma.parent[s])].append(s)
    root = int(np.nonzero(ma.parent == np.arange(
        n, dtype=ma.parent.dtype))[0][0])
    nmut = np.diff(ma.mut_ptr).astype(np.int64).tolist()
    muts_of = list(range(n))        # index into ma CSR; -1 = no mutations
    counter = sum(1 for i in range(n) if children[i])

    def on_new(_j):
        nmut.append(0)
        muts_of.append(-1)

    from ..io.pb_arrays import expand_condensed
    expand_condensed(names, parent, children, lambda i: bool(nmut[i]),
                     ma.condensed, counter, on_new)
    return names, nmut, muts_of, parent, children, root


def print_summary(ma, out=None) -> None:
    """Default console summary over arrays (summary.py print_summary)."""
    out = out if out is not None else sys.stdout
    names, nmut, _muts_of, _parent, children, _root = _children_lists(ma)
    total = len(names)
    leaves = sum(1 for c in children if not c)
    score = int(len(ma.mut_col))
    out.write(f"Total Nodes in Tree: {total}\n")
    out.write(f"Total Samples in Tree: {leaves}\n")
    out.write(f"Total Tree Parsimony: {score}\n")
    ncols = 0
    clades: set[str] = set()
    if ma.ann_counts is not None and len(ma.ann_counts):
        ncols = int(ma.ann_counts.max())
        for a in ma.ann_blob.decode().split("\0")[:-1]:
            if a:
                clades.add(a)
    out.write(f"Number of Annotated Clade Sets: {ncols}\n")
    out.write(f"Total Number of Clades: {len(clades)}\n")


def write_sample_table(ma, filename: str) -> None:
    """sample\\tparsimony\\tparent_id per leaf, DFS order of the expanded
    tree (summary.cpp:70-86)."""
    names, nmut, _muts_of, parent, children, root = _children_lists(ma)
    with open(filename, "w") as f:
        f.write("sample\tparsimony\tparent_id\n")
        stack = [root]
        while stack:
            x = stack.pop()
            if children[x]:
                stack.extend(reversed(children[x]))
            else:
                f.write(f"{names[x]}\t{nmut[x]}\t{names[parent[x]]}\n")


def write_clade_table(ma, filename: str) -> None:
    """clade\\tinclusive_count\\texclusive_count (summary.cpp:88-137) over
    arrays; annotations walked up from each expanded leaf's parent."""
    names, _nmut, _muts_of, parent, children, root = _children_lists(ma)
    from ..io.pb_arrays import ann_lists
    anns, _ncols = ann_lists(ma)
    if anns is None:
        anns = []
    incl: dict[str, int] = defaultdict(int)
    excl: dict[str, int] = defaultdict(int)
    for x in range(len(names)):
        if children[x]:
            continue
        first1 = first2 = True
        node = parent[x]
        while True:
            a = anns[node] if node < len(anns) else []
            if len(a) >= 1 and a[0]:
                incl[a[0]] += 1
                if first1:
                    excl[a[0]] += 1
                    first1 = False
            if len(a) >= 2 and a[1]:
                incl[a[1]] += 1
                if first2:
                    excl[a[1]] += 1
                    first2 = False
            if node == parent[node]:
                break
            node = parent[node]
    with open(filename, "w") as f:
        f.write("clade\tinclusive_count\texclusive_count\n")
        for clade in sorted(incl):
            f.write(f"{clade}\t{incl[clade]}\t{excl[clade]}\n")


def write_mutation_table(ma, filename: str) -> None:
    """ID\\toccurrence (summary.cpp:139-175) — one vectorized pass over
    the CSR (condensation does not change the mutation multiset)."""
    trip = np.stack([ma.mut_par.astype(np.int64),
                     ma.mut_col.astype(np.int64),
                     ma.mut_mut.astype(np.int64)])
    keys, cnts = np.unique(trip.T, axis=0, return_counts=True)
    rows = []
    for (par, col, mut), c in zip(keys.tolist(), cnts.tolist()):
        if mut == 0 or par == 0:
            continue   # masked
        rows.append((char_from_nuc_id(par) + str(int(ma.positions[col]))
                     + char_from_nuc_id(mut), int(c)))
    rows.sort()
    with open(filename, "w") as f:
        f.write("ID\toccurrence\n")
        for name, c in rows:
            f.write(f"{name}\t{c}\n")


def print_mutation_type_counts(ma, out=None) -> None:
    """4x4 from->to counts (summary.cpp:224-243), vectorized."""
    out = out if out is not None else sys.stdout
    a = np.array([nt_from_nuc_id(int(x)) for x in range(16)])
    fr = a[ma.mut_par]
    to = a[ma.mut_mut]
    ok = (fr >= 0) & (to >= 0)
    freq = np.zeros((4, 4), np.int64)
    np.add.at(freq, (fr[ok], to[ok]), 1)
    for i in range(4):
        for j in range(4):
            if i != j:
                out.write(f"{char_from_nuc_id(1 << i)}->"
                          f"{char_from_nuc_id(1 << j)}\t{freq[i][j]}\n")


# --- extract: selection + compressed induced subtree over arrays ------------
#
# The Tree-backed extract builds the FULL host tree first (minutes + GBs at
# the reference's >2M-leaf public MAT) even though its output is usually a
# small subtree.  Here selection and the induced-subtree construction
# (tree_filter.get_subtree semantics, reference
# mutation_annotated_tree.cpp:1577-1660) run over the flat arrays, and only
# the extracted subtree is materialized as a host Tree — every downstream
# writer (newick/VCF/JSON/paths/taxodium) then runs unchanged.

def _dfs_arrays(children, root, n):
    """(dfs_idx, subtree_size, level, preorder) over index lists."""
    dfs = [0] * n
    level = [0] * n
    pre = []
    stack = [root]
    while stack:
        x = stack.pop()
        dfs[x] = len(pre)
        pre.append(x)
        for c in reversed(children[x]):
            level[c] = level[x] + 1
            stack.append(c)
    size = [1] * n
    for x in reversed(pre):
        for c in children[x]:
            size[x] += size[c]
    return dfs, size, level, pre


def select_sample_indices(ma, lists, samples_file="", clade="",
                          mutation="", max_epps=0, max_parsimony=-1,
                          max_branch_length=-1, max_path_length=-1,
                          match="", internal_descendents="",
                          from_mrca=False, max_mutation_density=0.0,
                          nearest_k="", set_size=0, add_random=0,
                          limit_to_lca=False, seed=0, select_nearest=0):
    """Array-native -s/-c/-m selection (select.cpp:8-111 semantics);
    multiple criteria intersect like the Tree path.  Returns sample NAME
    list (expanded-tree leaves)."""
    names, _nmut, _muts_of, parent, children, root = lists
    n = len(names)
    dfs, size, _level, pre = _dfs_arrays(children, root, n)
    leaf_names = {names[x] for x in pre if not children[x]}
    picked: list[list[str]] = []
    if samples_file:
        from .select import read_sample_names
        present = []
        for s in read_sample_names(samples_file):
            if s in leaf_names:
                present.append(s)
            else:
                print(f"WARNING: sample {s} not found in the tree; "
                      f"ignoring", file=sys.stderr)
        picked.append(present)

    def leaves_under(carriers):
        # per-carrier BFS leaf order (T.get_leaves(node), select.cpp:38-65)
        got: list[str] = []
        for x in pre:
            if x in carriers:
                got.extend(_bfs_leaf_names_under(names, children, x))
        return got

    def global_bfs_filtered(carriers):
        # global BFS leaf order filtered to carrier subtrees (the order of
        # get_mutation_samples / get_parsimony_samples, which loop
        # T.get_leaves())
        inside = np.zeros(n, bool)
        for x in carriers:
            lo, hi = dfs[x], dfs[x] + size[x]
            for y in pre[lo:hi]:
                inside[y] = True
        return [nm for nm, y in zip(
            _bfs_leaf_names(names, children, parent, root),
            _bfs_leaf_idx(children, parent, root, n))
            if inside[y]]

    if clade:
        from ..io.pb_arrays import ann_lists
        ann, _ncols = ann_lists(ma)
        got = []
        for c in clade.split(","):
            c = c.strip()
            carriers = {x for x in range(min(n, len(ann or [])))
                        if ann is not None and c in ann[x]}
            cs = leaves_under(carriers)
            if not cs:
                print(f"ERROR: clade {c} not found in tree",
                      file=sys.stderr)
            got.extend(cs)
        picked.append(got)
    if mutation:
        node_of_row = np.repeat(np.arange(ma.n),
                                np.diff(ma.mut_ptr).astype(np.int64))
        got = []
        for mstr in mutation.split(","):
            mstr = mstr.strip()
            if mstr.isdigit():
                hit = ma.positions[ma.mut_col] == int(mstr)
            else:
                # "A23403G": parse once, compare components vectorized
                from ..core.nuc import nuc_id_from_char
                try:
                    par = nuc_id_from_char(mstr[0])
                    mut = nuc_id_from_char(mstr[-1])
                    posn = int(mstr[1:-1])
                except (ValueError, KeyError, IndexError):
                    hit = np.zeros(len(ma.mut_col), bool)
                else:
                    hit = ((ma.mut_par == par) & (ma.mut_mut == mut)
                           & (ma.positions[ma.mut_col] == posn))
            carriers = set(node_of_row[np.nonzero(hit)[0]].tolist())
            got.extend(global_bfs_filtered(carriers))
        picked.append(got)
    if match:
        # leaves whose identifier matches the regex (select.cpp:506-520;
        # BFS leaf order like the Tree path)
        import re
        rx = re.compile(match)
        picked.append([nm for nm in _bfs_leaf_names(names, children,
                                                    parent, root)
                       if rx.search(nm)])
    if max_epps > 0:
        # extract -e: EPP count per leaf via the batched placement engine
        # (select order = BFS leaves, get_samples_under_max_epps)
        bfs_leaves = _bfs_leaf_names(names, children, parent, root)
        epps = find_epps(ma, bfs_leaves, want_neighborhood=False,
                         want_placements=False, lists=lists)
        picked.append([nm for nm in bfs_leaves
                       if epps[nm][0] <= max_epps])
    if max_parsimony >= 0:
        # terminal branch length <= max, BFS leaf order (select.cpp:113-127)
        nmut_l = lists[1]
        picked.append([names[y] for y in _bfs_leaf_idx(children, parent,
                                                       root, n)
                       if nmut_l[y] <= max_parsimony])
    if nearest_k:
        sample_id, _, k = nearest_k.rpartition(":")
        picked.append(_nearby_names(lists, sample_id, int(k)))
    if internal_descendents:
        # leaves under a named internal node (extract -I)
        idx_any = {nm: i for i, nm in enumerate(names)}
        i = idx_any.get(internal_descendents)
        if i is None:
            print(f"ERROR: node {internal_descendents} not found in tree",
                  file=sys.stderr)
            picked.append([])
        else:
            picked.append(_bfs_leaf_names_under(names, children, i))
    if not picked:
        out = _bfs_leaf_names(names, children, parent, root)
    else:
        out = picked[0]
        for other in picked[1:]:
            o = set(other)
            out = [s for s in out if s in o]
    out = list(dict.fromkeys(out))
    # post-filters (select_samples tail, extract.cpp:429-450 region)
    if max_branch_length >= 0 or max_path_length >= 0:
        nmut_l = lists[1]
        leaf_idx = {names[x]: x for x in pre if not children[x]}
        kept = []
        for nm in out:
            x = leaf_idx.get(nm)
            if x is None:
                continue
            ok = True
            total = 0
            mx = 0
            while True:
                total += nmut_l[x]
                mx = max(mx, nmut_l[x])
                if x == parent[x]:
                    break
                x = parent[x]
            if max_branch_length >= 0 and mx > max_branch_length:
                ok = False
            if max_path_length >= 0 and total > max_path_length:
                ok = False
            if ok:
                kept.append(nm)
        out = kept
    if max_mutation_density > 0 and out:
        # drop samples under internal nodes whose mean descendant mutation
        # count exceeds the bound (filter_mut_density, select.cpp:337-466)
        nmut_l = lists[1]
        n = len(names)
        tot = [int(v) for v in nmut_l]
        cnt = [0 if children[x] else 1 for x in range(n)]
        for x in reversed(pre):
            p = parent[x]
            if p != x:
                tot[p] += tot[x]
                cnt[p] += cnt[x]
        dropped = np.zeros(n, bool)
        for x in pre:
            if children[x] and cnt[x] > 0 \
                    and tot[x] / cnt[x] > max_mutation_density:
                lo, hi = dfs[x], dfs[x] + size[x]
                for y in pre[lo:hi]:
                    if not children[y]:
                        dropped[y] = True
        leaf_idx = {names[x]: x for x in pre if not children[x]}
        out = [nm for nm in out
               if not dropped[leaf_idx.get(nm, 0)]]
    if from_mrca and out:
        # all leaves under the selection's MRCA (select.cpp:570-596)
        leaf_idx = {names[x]: x for x in pre if not children[x]}
        cur = leaf_idx[out[0]]
        for nm in out[1:]:
            a, b = cur, leaf_idx.get(nm)
            if b is None:
                continue
            # LCA by dfs-interval walk (level via parent chains)
            while not (dfs[a] <= dfs[b] < dfs[a] + size[a]):
                a = parent[a]
            cur = a
        out = _bfs_leaf_names_under(names, children, cur)
    if select_nearest > 0:
        # -Y: add the y nearest samples to each selected sample
        # (extract.cpp:429-441)
        extra = []
        have = set(out)
        for nm in out:
            for nb in _nearby_names(lists, nm, select_nearest):
                if nb not in have:
                    have.add(nb)
                    extra.append(nb)
        out = out + extra
    if set_size > 0 or add_random > 0:
        target = set_size if set_size > 0 else add_random + len(out)
        out = _fill_random(lists, dfs, size, pre, out, target,
                           limit_to_lca, seed)
    return out


def _nearby_names(lists, sample_id: str, k: int):
    """The sample plus its k nearest leaves by mutation path distance
    (select.get_nearby / select.cpp:206-276) over index lists."""
    names, nmut, _mo, parent, children, root = lists
    leaf_idx = {names[x]: x for x in range(len(names)) if not children[x]}
    node = leaf_idx.get(sample_id)
    if node is None:
        print(f"ERROR: sample {sample_id} not found in tree",
              file=sys.stderr)
        return []
    dists = {sample_id: 0}

    def descend(start, base):
        stack = [(start, base + nmut[start])]
        while stack:
            cur, d = stack.pop()
            if not children[cur]:
                prev = dists.get(names[cur])
                if prev is None or d < prev:
                    dists[names[cur]] = d
            for ch in children[cur]:
                stack.append((ch, d + nmut[ch]))

    prev = node
    up = nmut[node]
    cur = parent[node]
    while True:
        for ch in children[cur]:
            if ch != prev:
                descend(ch, up)
        if cur == parent[cur]:
            break
        prev = cur
        up += nmut[cur]
        cur = parent[cur]
    ranked = sorted((d, nm) for nm, d in dists.items() if nm != sample_id)
    return [sample_id] + [nm for _, nm in ranked[:k]]


def _fill_random(lists, dfs, size, pre, samples, target_size,
                 lca_limit, seed):
    """select.fill_random_samples over index lists — the random pool is
    BFS leaf order (Tree.get_leaves_ids), so draws match the Tree path
    seed-for-seed."""
    names, _nm, _mo, parent, children, root = lists
    rng = np.random.default_rng(seed)
    current = list(dict.fromkeys(samples))
    if len(current) > target_size:
        idx = rng.choice(len(current), size=target_size, replace=False)
        return [current[i] for i in sorted(idx)]
    if lca_limit and current:
        leaf_idx = {names[x]: x for x in pre if not children[x]}
        cur = leaf_idx[current[0]]
        for nm in current[1:]:
            b = leaf_idx.get(nm)
            if b is None:
                continue
            while not (dfs[cur] <= dfs[b] < dfs[cur] + size[cur]):
                cur = parent[cur]
        pool_source = _bfs_leaf_names_under(names, children, cur)
    else:
        pool_source = _bfs_leaf_names(names, children, parent, root)
    have = set(current)
    pool = [s for s in pool_source if s not in have]
    need = target_size - len(current)
    if need >= len(pool):
        current.extend(pool)
    elif need > 0:
        idx = rng.choice(len(pool), size=need, replace=False)
        current.extend(pool[i] for i in sorted(idx))
    return current


def _bfs_leaf_idx(children, parent, root, n):
    from collections import deque
    out = []
    dq = deque([root])
    while dq:
        x = dq.popleft()
        if children[x]:
            dq.extend(children[x])
        else:
            out.append(x)
    return out


def _bfs_leaf_names_under(names, children, start):
    from collections import deque
    out = []
    dq = deque([start])
    while dq:
        x = dq.popleft()
        if children[x]:
            dq.extend(children[x])
        else:
            out.append(names[x])
    return out


def _bfs_leaf_names(names, children, parent, root):
    return _bfs_leaf_names_under(names, children, root)


def extract_subtree(ma, samples, lists=None):
    """Compressed induced subtree as a host Tree — get_subtree
    (tree_filter.py:30-95) replayed over the expanded arrays: kept nodes
    are the sample leaves plus DFS-consecutive LCAs; each new edge
    accumulates the original mutations root-down via add_mutation."""
    from ..core.tree import Mutation, Tree
    from ..io.pb_arrays import ann_lists
    if lists is None:
        lists = _children_lists(ma)
    names, _nmut, muts_of, parent, children, root = lists
    n = len(names)
    dfs, size, level, pre = _dfs_arrays(children, root, n)
    ann, ncols = ann_lists(ma)

    leaf_of = {names[x]: x for x in pre if not children[x]}
    sample_idx = []
    for s in samples:
        i = leaf_of.get(s)
        if i is None:
            print(f"ERROR: Sample {s} not found in the tree!",
                  file=sys.stderr)
        else:
            sample_idx.append(i)
    sample_idx.sort(key=lambda i: dfs[i])

    def lca(a, b):
        while level[a] > level[b]:
            a = parent[a]
        while level[b] > level[a]:
            b = parent[b]
        while a != b:
            a = parent[a]
            b = parent[b]
        return a

    keep = set(sample_idx)
    for a, b in zip(sample_idx, sample_idx[1:]):
        keep.add(lca(a, b))

    def muts_of_idx(x):
        k = muts_of[x]
        if k < 0 or k >= ma.n:
            return []
        out = []
        for j in range(int(ma.mut_ptr[k]), int(ma.mut_ptr[k + 1])):
            col = int(ma.mut_col[j])
            out.append(Mutation(ma.chrom, int(ma.positions[col]),
                                int(ma.ref[col]), int(ma.mut_par[j]),
                                int(ma.mut_mut[j])))
        return out

    subtree = Tree()
    stack = []   # (orig idx, new Node)
    for x in pre:
        if x not in keep:
            continue
        while stack and not (dfs[stack[-1][0]] <= dfs[x]
                             < dfs[stack[-1][0]] + size[stack[-1][0]]):
            stack.pop()
        if not stack:
            new_node = subtree.create_node(names[x], None, -1.0, ncols)
            path = []
            cur = x
            while True:
                path.append(cur)
                if cur == parent[cur]:
                    break
                cur = parent[cur]
            for cur in reversed(path):
                for m in muts_of_idx(cur):
                    new_node.add_mutation(m)
        else:
            top, top_new = stack[-1]
            new_node = subtree.create_node(names[x], top_new.identifier,
                                           -1.0, ncols)
            path = []
            cur = x
            while cur != top:
                path.append(cur)
                cur = parent[cur]
            for cur in reversed(path):
                for m in muts_of_idx(cur):
                    new_node.add_mutation(m)
        if ann is not None and x < len(ann):
            a = ann[x]
            for k in range(min(ncols, len(a))):
                if a[k]:
                    new_node.clade_annotations[k] = a[k]
        stack.append((x, new_node))
    return subtree


def verbatim_subtree(ma, samples, lists=None):
    """Prune-semantics induced subtree: sample leaves plus ALL their
    ancestors with original names, per-edge mutations, and unary chains
    retained — get_sample_prune / remove_node(move_level=False)
    (tree_filter.py:108-120, filter.cpp:55-85).  Used for selections of
    >= 10000 samples and whole-tree selections, matching filter_master's
    dispatch exactly."""
    from ..core.tree import Mutation, Tree
    from ..io.pb_arrays import ann_lists
    if lists is None:
        lists = _children_lists(ma)
    names, _nmut, muts_of, parent, children, root = lists
    n = len(names)
    _dfs, _size, _level, pre = _dfs_arrays(children, root, n)
    ann, ncols = ann_lists(ma)

    leaf_of = {names[x]: x for x in pre if not children[x]}
    keep = [False] * n
    for s in samples:
        i = leaf_of.get(s)
        if i is None:
            print(f"ERROR: Sample {s} not found in the tree!",
                  file=sys.stderr)
            continue
        while not keep[i]:
            keep[i] = True
            if i == parent[i]:
                break
            i = parent[i]

    subtree = Tree()
    new_of: dict[int, str] = {}
    for x in pre:
        if not keep[x]:
            continue
        par_id = new_of.get(parent[x]) if x != parent[x] else None
        node = subtree.create_node(names[x], par_id, -1.0, ncols)
        k = muts_of[x]
        if 0 <= k < ma.n:
            for j in range(int(ma.mut_ptr[k]), int(ma.mut_ptr[k + 1])):
                col = int(ma.mut_col[j])
                node.add_mutation(Mutation(
                    ma.chrom, int(ma.positions[col]), int(ma.ref[col]),
                    int(ma.mut_par[j]), int(ma.mut_mut[j])))
        if ann is not None and x < len(ann):
            a = ann[x]
            for kk in range(min(ncols, len(a))):
                if a[kk]:
                    node.clade_annotations[kk] = a[kk]
        new_of[x] = node.identifier
    return subtree


def rename_samples(ma, rename_filename: str) -> None:
    """old\\tnew per line over the names blob (mask.cpp:679-705 semantics:
    tree nodes only — condensed member names are not nodes and warn, like
    the Tree path's rename_node lookup)."""
    names = ma.names()
    idx = {nm: i for i, nm in enumerate(names)}
    with open(rename_filename) as f:
        for line in f:
            words = line.rstrip("\n").split("\t")
            if len(words) != 2:
                raise ValueError(
                    f"ERROR: Incorrect format for the renaming file: "
                    f"{rename_filename}!")
            i = idx.get(words[0])
            if i is None:
                print(f"WARNING: Node {words[0]} not found in the MAT.",
                      file=sys.stderr)
            elif words[1] in idx:
                # Tree.rename_node's collision rule (core/tree.py:210)
                raise ValueError(
                    f"rename_node: node {words[1]} already exists")
            else:
                names[i] = words[1]
                del idx[words[0]]
                idx[words[1]] = i
    from ..io.pb_arrays import set_names
    set_names(ma, names)


def annotate_by_nid(ma, clade_to_nid_file: str,
                    clear_current: bool = False) -> None:
    """clade\\tnode_id per line over the annotation blob
    (assign_lineages_by_nid / annotate.cpp:170-205 semantics: one new
    annotation column appended — or the vector reset with
    clear_current — and the clade written into the LAST column of the
    named node)."""
    from ..io.pb_arrays import ann_lists
    n = ma.n
    anns, ncols = ann_lists(ma)
    if anns is None:
        anns = [[] for _ in range(n)]
        ncols = 0
    if clear_current:
        anns = [[""] for _ in range(n)]
        ncols = 1
    else:
        for a in anns:
            a.extend([""] * (ncols - len(a)))
            a.append("")
        ncols += 1
    idx = {nm: i for i, nm in enumerate(ma.names())}
    with open(clade_to_nid_file) as f:
        for line in f:
            words = line.rstrip("\n").split("\t")
            if len(words) != 2:
                raise ValueError(
                    "ERROR: Incorrect format for clade to node id "
                    f"assignment file: {clade_to_nid_file}!")
            clade, nid = words
            i = idx.get(nid)
            if i is None:
                raise KeyError(f"ERROR: Node id {nid} not found!")
            if anns[i][ncols - 1] != "":
                print(f"WARNING: Assigning clade {clade} to node {nid} "
                      f"failed as the node is already assigned to clade "
                      f"{anns[i][ncols-1]}!", file=sys.stderr)
            else:
                anns[i][ncols - 1] = clade
    ma.ann_counts = np.full(n, ncols, np.int32)
    ma.ann_blob = ("\0".join(a for row in anns for a in row)
                   + "\0").encode() if n else b""


# --- uncertainty: per-sample EPP + neighborhood over arrays -----------------

def _expanded_bigmat(ma, lists):
    """BigMAT over the condensed-expanded index lists (uncertainty runs
    against the UNCONDENSED tree, like the Tree path).  Expansion leaves
    carry no mutations; index order reproduces the host uncondense order
    so the recomputed BFS tie-break ranks match from_tree's exactly."""
    from ..core.bigmat import BigMAT
    names, _nmut, muts_of, parent, children, _root = lists
    n2 = len(names)
    counts = np.zeros(n2, np.int64)
    for i, k in enumerate(muts_of):
        if 0 <= k < ma.n:
            counts[i] = ma.mut_ptr[k + 1] - ma.mut_ptr[k]
    ptr2 = np.zeros(n2 + 1, np.int64)
    ptr2[1:] = np.cumsum(counts)
    src = np.concatenate([
        np.arange(int(ma.mut_ptr[k]), int(ma.mut_ptr[k + 1]))
        for k in muts_of if 0 <= k < ma.n] or
        [np.zeros(0, np.int64)]).astype(np.int64)
    big = BigMAT(np.asarray(parent, np.int32), ptr2,
                 ma.mut_col[src], ma.mut_par[src], ma.mut_mut[src],
                 ma.positions, ma.ref)
    big._recompute_ranks()
    return big


def _ancestral_set_triplets(big, slot):
    """The leaf's genotype as (position-sorted) mutations-from-reference
    (uncertainty.ancestral_mutation_set over the CSR: nearest entry per
    position, net-reference entries dropped)."""
    seen = {}
    x = int(slot)
    while True:
        for j in range(int(big.mut_ptr[x]), int(big.mut_ptr[x + 1])):
            col = int(big.mut_col[j])
            if col not in seen:
                seen[col] = int(big.mut_mut[j])
        p = int(big.parent[x])
        if p == x:
            break
        x = p
    return sorted((c, v) for c, v in seen.items()
                  if v != int(big.ref[c]))


def _host_tie_slots(big, pos, gval, kmiss, excl_slot):
    """Valid tied slots at the excluded-best score, BFS order (the host
    mirror of place_one_host's score/validity arrays)."""
    big._flush()
    *ev, add0 = big._events(pos, gval, kmiss, spr=False)
    ev_idx, ev_b, ev_val, nc_idx, nc_b, nc_val = ev
    n_pad = big.N   # the dump row of the port's exact-N DFS rows
    diff = np.zeros(n_pad + 1, np.int32)
    np.add.at(diff, ev_idx, ev_val)
    run = np.cumsum(diff[:n_pad], dtype=np.int32)
    score = big.base + np.int32(add0[0]) + run[big.dfs_of]
    ncv = np.zeros(n_pad + 1, np.int32)
    np.add.at(ncv, nc_idx, nc_val)
    nc = big.nc_base + ncv[big.dfs_of]
    hu = nc < big.node_num_mut
    leaf = big.is_leaf
    valid = (big.is_root_mask
             | (leaf & (nc > 0))
             | (~leaf & hu & (nc > 0))
             | (~leaf & ~hu)) & big.active
    valid[excl_slot] = False
    s = np.where(valid, score, 1 << 30)
    best = int(s.min())
    ties = np.nonzero(valid & (score == best))[0]
    return [int(t) for t in ties[np.argsort(big.bfs_rank[ties],
                                            kind="stable")]]


def find_epps(ma, sample_names, batch_size: int = 256,
              want_neighborhood: bool = True,
              want_placements: bool = True, lists=None):
    """Array-native uncertainty.find_epps: {sample: (num_best,
    neighborhood_size, [placement slots])} with self-mapping excluded.

    Exclusion needs no kernel change: a mutation-carrying leaf is always
    a valid 0-score tie for its own genotype, so the excluded result is
    the device's winner-row-masked RUNNER-UP when the snapshot winner is
    the sample itself, and (best, winner, num_best - 1) otherwise."""
    if lists is None:
        lists = _children_lists(ma)
    names = lists[0]
    big = _expanded_bigmat(ma, lists)
    parent = big.parent.astype(np.int64)
    slot_of = {nm: i for i, nm in enumerate(names)}
    nmut = np.diff(big.mut_ptr)
    results = {}
    todo = [s for s in sample_names if s in slot_of]
    for start in range(0, len(todo), batch_size):
        chunk = todo[start:start + batch_size]
        muts = []
        for nm in chunk:
            trips = _ancestral_set_triplets(big, slot_of[nm])
            from ..core.tree import Mutation
            muts.append([Mutation(ma.chrom, int(big.positions[c]),
                                  int(big.ref[c]), int(big.ref[c]), v)
                         for c, v in trips])
        pos, gval, kmiss = big.sparsify(muts)
        res = None
        if os.environ.get("USHER_TPU_GROUPED", "1") != "0":
            # shared-ancestry grouped scoring (X6): the batch IS existing
            # leaves, the workload the decomposition targets; equal to
            # place_arrays (core/bigmat.py place_arrays_grouped)
            try:
                grouped = big.group_ancestral_batch(
                    [slot_of[nm] for nm in chunk])
                res = big.place_arrays_grouped(*grouped,
                                               with_second=True)
            except ValueError:   # occupancy bound / mesh: plain path
                res = None
        if res is None:
            res = big.place_arrays(pos, gval, kmiss, with_second=True)
        (bs, slot, nb, hu), (bs2, slot2, nb2, hu2) = res
        for i, nm in enumerate(chunk):
            self_slot = slot_of[nm]
            self_valid = nmut[self_slot] > 0
            if not self_valid:
                best, win, n_best = int(bs[i]), int(slot[i]), int(nb[i])
            elif int(slot[i]) == self_slot:
                best, win, n_best = int(bs2[i]), int(slot2[i]), int(nb2[i])
            else:
                best, win, n_best = int(bs[i]), int(slot[i]), int(nb[i]) - 1
            if n_best > 1 and (want_neighborhood or want_placements):
                p1, g1, k1 = big.sparsify([muts[i]])
                ties = _host_tie_slots(big, p1, g1, k1, self_slot)
                nsize = (_neighborhood_size(big, parent, ties)
                         if want_neighborhood else 0)
            elif n_best > 1:
                ties, nsize = [], 0
            else:
                ties = [int(parent[self_slot])]
                nsize = 0
            results[nm] = (n_best, nsize, ties)
    return results


def _neighborhood_size(big, parent, slots) -> int:
    """uncertainty.get_neighborhood_size over slots: longest direct path
    between any two placements through the min-total-distance common
    ancestor; distances are per-branch mutation counts."""
    if len(slots) < 2:
        return 0
    nmut = np.diff(big.mut_ptr).astype(np.int64)

    def path(x):
        out = [x]
        while out[-1] != parent[out[-1]]:
            out.append(int(parent[out[-1]]))
        return out

    paths = [path(int(s)) for s in slots]
    common = set(paths[0])
    for p in paths[1:]:
        common &= set(p)
    best_anc, best_total = None, None
    for anc in paths[0]:
        if anc not in common:
            continue
        total = 0
        for p in paths:
            d = 0
            for x in p:
                if x == anc:
                    break
                d += int(nmut[x])
            total += d
        if best_total is None or total < best_total:
            best_total, best_anc = total, anc
    dists = []
    for p in paths:
        d = 0
        for x in p:
            if x == best_anc:
                break
            d += int(nmut[x])
        dists.append(d)
    dists.sort()
    return int(dists[-1] + dists[-2])


def uncertainty_main(ma, sample_file: str, epps_out: str = "",
                     locs_out: str = "") -> int:
    """Array-native uncertainty subcommand (uncertainty.cpp:259-340)."""
    from .select import read_sample_names
    samples = read_sample_names(sample_file)
    lists = _children_lists(ma)
    names = lists[0]
    results = find_epps(ma, samples, lists=lists)
    if epps_out:
        with open(epps_out, "w") as f:
            f.write("sample\tequally_parsimonious_placements\t"
                    "neighborhood_size\n")
            for s in samples:
                if s not in results:
                    print(f"WARNING: sample {s} not found in tree",
                          file=sys.stderr)
                    continue
                nb, ns, _ = results[s]
                f.write(f"{s}\t{nb}\t{ns}\n")
    if locs_out:
        with open(locs_out, "w") as f:
            f.write("placement\tsample\n")
            for s in samples:
                if s not in results:
                    continue
                nb, _ns, slots = results[s]
                if nb == 1:
                    f.write(f"{s}\t{s}\n")
                else:
                    for sl in slots:
                        f.write(f"{names[sl]}\t{s}\n")
    return 0
