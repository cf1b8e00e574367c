"""matUtils merge over MatArrays: pandemic-scale MAT union without host
Node objects.

The Tree path (matutils/merge.py) mirrors reference src/matUtils/merge.cpp
but pays a full Python Tree build for BOTH inputs — minutes and GBs when
the base is the >2M-leaf public MAT.  Here every per-tree structure is an
index array: condensed nodes expand over lists (io/pb_arrays.
expand_condensed), the common-leaf consistency check walks the CSR
directly, the consistent-node backbone (merge.cpp:52-122) is a virtual
compressed tree over DFS-sorted common leaves (no pruned copy of the
base), the per-sample search bound (merge.cpp:238,254-258) is one
dfs-interval + level mask, and placement/apply/save run on the BigMAT
direct machinery (placement/direct.py) that is byte-parity-proven
against the Tree driver.

Output parity with the Tree path is asserted by tests/test_matutils.py
(same inputs -> byte-identical merged pb)."""

from __future__ import annotations

import sys

import numpy as np

from ..core.tree import Mutation

BIG_SCORE = 1 << 30


def _err(*a):
    print(*a, file=sys.stderr)


class _SideArrays:
    """One input MAT as uncondensed index lists + CSR accessors."""

    def __init__(self, ma):
        from ..io.pb_arrays import expand_condensed
        self.ma = ma
        n = ma.n
        parent = ma.parent.astype(np.int64).tolist()
        names = ma.names()
        nr = np.nonzero(np.arange(n) != ma.parent)[0]
        order = nr[np.argsort(ma.parent[nr], kind="stable")]
        children: list[list[int]] = [[] for _ in range(n)]
        for s in order.tolist():
            children[int(ma.parent[s])].append(s)
        root = int(np.nonzero(ma.parent == np.arange(
            n, dtype=ma.parent.dtype))[0][0])
        nmut = np.diff(ma.mut_ptr).astype(np.int64).tolist()
        muts_of = list(range(n))
        counter = sum(1 for c in children if c)

        def on_new(_j):
            nmut.append(0)
            muts_of.append(-1)

        counter = expand_condensed(names, parent, children,
                                   lambda i: bool(nmut[i]), ma.condensed,
                                   counter, on_new)
        self.names = names
        self.parent = parent
        self.children = children
        self.root = root
        self.muts_of = muts_of
        self.counter = counter
        self.n = len(names)
        self.slot_of = {nm: i for i, nm in enumerate(names)}
        # DFS/level arrays (leaf order, LCA walks, subtree intervals)
        from .arrays import _dfs_arrays
        dfs, size, level, _pre = _dfs_arrays(children, root, self.n)
        self.dfs = dfs
        self.size = size
        self.level = level

    def leaves_bfs(self) -> list[str]:
        """Leaf names in BFS order (Tree.get_leaves_ids)."""
        from collections import deque
        out = []
        dq = deque([self.root])
        while dq:
            x = dq.popleft()
            if not self.children[x]:
                out.append(self.names[x])
            else:
                dq.extend(self.children[x])
        return out

    def genotype(self, slot: int) -> list[Mutation]:
        """Sample's net mutations from the reference: nearest CSR entry
        per position along the root path, reference-matching entries
        dropped (merge.py sample_genotype_mutations / merge.cpp
        consistency check)."""
        ma = self.ma
        seen: dict[int, tuple[int, int]] = {}
        x = slot
        while True:
            k = self.muts_of[x]
            if 0 <= k < ma.n:
                for j in range(int(ma.mut_ptr[k]), int(ma.mut_ptr[k + 1])):
                    c = int(ma.mut_col[j])
                    if c not in seen:
                        seen[c] = (int(ma.mut_par[j]), int(ma.mut_mut[j]))
            p = self.parent[x]
            if p == x or p < 0:
                break
            x = p
        out = []
        for c, (pn, mn) in seen.items():
            if mn != int(ma.ref[c]):
                out.append(Mutation(ma.chrom, int(ma.positions[c]),
                                    int(ma.ref[c]), pn, mn))
        out.sort(key=lambda m: m.position)
        return out

    def lca(self, a: int, b: int) -> int:
        while self.level[a] > self.level[b]:
            a = self.parent[a]
        while self.level[b] > self.level[a]:
            b = self.parent[b]
        while a != b:
            a = self.parent[a]
            b = self.parent[b]
        return a


def _expanded_matarrays(side: _SideArrays):
    """Uncondensed MatArrays from the expanded lists (slot order encodes
    child order: expansion appends members exactly where the Tree path's
    uncondense_leaves puts them)."""
    from ..io.pb_arrays import MatArrays
    ma = side.ma
    n2 = side.n
    counts = np.zeros(n2, np.int64)
    src_parts = []
    for i, k in enumerate(side.muts_of):
        if 0 <= k < ma.n:
            lo, hi = int(ma.mut_ptr[k]), int(ma.mut_ptr[k + 1])
            counts[i] = hi - lo
            if hi > lo:
                src_parts.append(np.arange(lo, hi, dtype=np.int64))
    ptr2 = np.zeros(n2 + 1, np.int64)
    ptr2[1:] = np.cumsum(counts)
    src = (np.concatenate(src_parts) if src_parts
           else np.zeros(0, np.int64))
    parent2 = np.asarray(side.parent, np.int64).copy()
    parent2[side.root] = side.root
    blob = ("\0".join(side.names) + "\0").encode()
    off = np.zeros(n2 + 1, np.int64)
    off[1:] = np.nonzero(np.frombuffer(blob, np.uint8) == 0)[0] + 1
    return MatArrays(
        parent=parent2.astype(np.int32), names_blob=blob, name_off=off,
        blen=np.full(n2, -1.0),
        mut_ptr=ptr2, mut_col=ma.mut_col[src].astype(np.int32),
        mut_par=ma.mut_par[src], mut_mut=ma.mut_mut[src],
        positions=np.asarray(ma.positions), ref=np.asarray(ma.ref),
        chrom=ma.chrom, condensed=[],
        ann_counts=np.zeros(n2, np.int32), ann_blob=b"")


def _consistent_nodes_arr(base: _SideArrays, other: _SideArrays,
                          common: list[str]) -> dict[str, str]:
    """other-name -> base-name over the common-leaf backbone
    (merge.cpp:52-122; merge.py consistent_nodes): branching nodes of the
    base pruned to the common leaves are exactly the pairwise LCAs of
    DFS-adjacent common leaves; for each, map LCA(other) of its first two
    pruned children's first leaves to LCA(base) of the same pair."""
    out: dict[str, str] = {}
    if not common:
        return out
    for s in common:
        out[s] = s
    leaf_slots = sorted((base.slot_of[s] for s in common),
                        key=lambda i: base.dfs[i])
    leaf_dfs = [base.dfs[i] for i in leaf_slots]
    kept: dict[int, None] = {}
    for a, b in zip(leaf_slots, leaf_slots[1:]):
        kept.setdefault(base.lca(a, b))
    vnodes = sorted(set(kept) | set(leaf_slots), key=lambda i: base.dfs[i])
    # stack sweep -> per-branching-vnode ordered virtual children
    import bisect
    vchildren: dict[int, list[int]] = {}
    stack: list[int] = []
    for x in vnodes:
        dx = base.dfs[x]
        while stack and not (base.dfs[stack[-1]] <= dx
                             < base.dfs[stack[-1]] + base.size[stack[-1]]):
            stack.pop()
        if stack:
            vchildren.setdefault(stack[-1], []).append(x)
        stack.append(x)

    def first_common_leaf(v: int) -> str:
        """DFS-first common leaf inside v's subtree (= what repeatedly
        descending child[0] of the pruned tree reaches)."""
        k = bisect.bisect_left(leaf_dfs, base.dfs[v])
        return base.names[leaf_slots[k]]

    for v, ch in vchildren.items():
        if len(ch) < 2:
            continue
        l1 = first_common_leaf(ch[0])
        l2 = first_common_leaf(ch[1])
        o1, o2 = other.slot_of.get(l1), other.slot_of.get(l2)
        if o1 is None or o2 is None:
            continue
        lca_base = base.lca(base.slot_of[l1], base.slot_of[l2])
        lca_other = other.lca(o1, o2)
        out[other.names[lca_other]] = base.names[lca_base]
    return out


def _host_restricted_score(big, muts, allow_mask):
    """(best_score, winner_slot, num_best, hu_winner) over the CURRENT
    flushed state restricted to allow_mask — the host mirror of
    PlacementEngine.score_samples(restrict_slots=...) incl. its winner
    rule (max leaves among min-score ties, then max BFS rank).  None when
    every allowed candidate is invalid (num_best == 0)."""
    if getattr(big, "_ranks_dirty", False):
        big._recompute_ranks()
    pos, gval, kmiss = big.sparsify([muts])
    *ev, add0 = big._events(pos, gval, kmiss, spr=False)
    ev_idx, _ev_b, ev_val, nc_idx, _nc_b, nc_val = ev
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
             | (~leaf & ~hu)) & big.active & allow_mask
    s = np.where(valid, score, BIG_SCORE)
    best = int(s.min())
    if best >= BIG_SCORE:
        return None
    ties = np.nonzero(valid & (score == best))[0]
    nl = big.num_leaves[ties]
    cand = ties[nl == nl.max()]
    w = int(cand[np.argmax(big.bfs_rank[cand])])
    return best, w, int(len(ties)), bool(hu[w])


def _allow_mask(big, anchor_slot: int, max_depth: int) -> np.ndarray:
    """Slots within max_depth levels below the anchor (merge.py
    _restricted_ids / merge.cpp:238,254-258 bounded BFS) as one
    dfs-interval + level mask over the flushed arrays."""
    dfs = big.dfs_of
    mask = ((dfs >= dfs[anchor_slot]) & (dfs < big.dfs_end_of[anchor_slot])
            & (big.level <= big.level[anchor_slot] + max_depth))
    return mask


def merge_mats_arrays(ma1, ma2, max_uncertainty: int = 1_000_000,
                      max_depth: int = 20):
    """Merge ma2 into ma1 (caller orders by size, like the Tree path);
    returns the DirectPlacer holding the merged state (save via
    .save_pb).  Mirrors matutils/merge.merge_mats stage for stage."""
    from ..placement.direct import DirectPlacer
    from ..placement.mapper import score_placement

    s1 = _SideArrays(ma1)
    s2 = _SideArrays(ma2)
    leaves1 = {s1.names[i] for i in range(s1.n) if not s1.children[i]}
    leaves2 = s2.leaves_bfs()

    common = [s for s in leaves2 if s in leaves1]
    new = [s for s in leaves2 if s not in leaves1]
    _err(f"{len(common)} shared samples, {len(new)} samples to place.")

    bad = []
    for s in common:
        ga = {m.position: m.mut_nuc for m in s1.genotype(s1.slot_of[s])}
        gb = {m.position: m.mut_nuc for m in s2.genotype(s2.slot_of[s])}
        if set(ga) != set(gb) or not all(ga[p] & gb[p] for p in ga):
            bad.append(s)
    if bad:
        raise ValueError(
            f"ERROR: {len(bad)} shared samples have inconsistent genotypes "
            f"(e.g. {bad[0]}); trees do not share a common base")

    ma1x = _expanded_matarrays(s1)
    if not new:
        placer = DirectPlacer("", ma=ma1x, counter=s1.counter)
        return placer

    consist = _consistent_nodes_arr(s1, s2, common)
    root_name = s1.names[s1.root]
    anchors: dict[str, str] = {}
    genos: dict[str, list[Mutation]] = {}
    extra_pos_ref: dict[int, int] = {}
    base_positions = set(int(p) for p in ma1.positions.tolist())
    for name in new:
        anchor = root_name
        x = s2.slot_of[name]
        while True:
            got = consist.get(s2.names[x])
            if got is not None:
                anchor = got
                break
            p = s2.parent[x]
            if p == x or p < 0:
                break
            x = p
        anchors[name] = anchor
        muts = s2.genotype(s2.slot_of[name])
        genos[name] = muts
        for m in muts:
            if m.position not in base_positions:
                extra_pos_ref[m.position] = m.ref_nuc

    placer = DirectPlacer("", ma=ma1x, extra_pos_ref=extra_pos_ref,
                          counter=s1.counter)
    big = placer.big
    present = set(s1.names)
    placed = retried = 0
    bsz = 256
    for start in range(0, len(new), bsz):
        chunk = [nm for nm in new[start:start + bsz] if nm not in present]
        if not chunk:
            continue
        big._flush()
        pos, gval, kmiss = big.sparsify([genos[nm] for nm in chunk])
        bs, slot, nb, hu = big.place_arrays(pos, gval, kmiss)
        touched: set[str] = set()
        for i, nm in enumerate(chunk):
            if big._pending:
                big._flush()
            anchor_slot = _slot_by_name(placer, anchors[nm])
            allow = _allow_mask(big, anchor_slot, max_depth)
            best_slot = int(slot[i])
            best_score = int(bs[i])
            num_best = int(nb[i])
            hu_best = bool(hu[i])
            w_name = placer.name_of(best_slot)
            w_par = placer.name_of(placer.parent_slot_of(best_slot))
            stale = (not allow[best_slot] or w_name in touched
                     or w_par in touched)
            if stale:
                got = _host_restricted_score(big, genos[nm], allow)
                retried += 1
                if got is None:
                    num_best = 0
                else:
                    best_score, best_slot, num_best, hu_best = got
            if num_best == 0 or num_best > max_uncertainty:
                # no valid candidate in range: the reference's default
                # placement target is the anchor itself
                # (merge.cpp:243-247 best_node = bfs[0])
                best_slot = anchor_slot
                detail = score_placement(placer.node(best_slot),
                                         genos[nm])
                hu_best = False
            else:
                detail = score_placement(placer.node(best_slot),
                                         genos[nm])
                if detail.set_difference != best_score:
                    got = _host_restricted_score(big, genos[nm], allow)
                    retried += 1
                    if got is None:
                        best_slot = anchor_slot
                        hu_best = False
                    else:
                        best_score, best_slot, _nb2, hu_best = got
                    detail = score_placement(placer.node(best_slot),
                                             genos[nm])
            parent_before = placer.name_of(
                placer.parent_slot_of(best_slot))
            w_name = placer.name_of(best_slot)
            changed = placer.apply_placement(nm, best_slot, hu_best,
                                             detail.excess)
            placed += 1
            present.add(nm)
            touched.add(w_name)
            touched.add(nm)
            touched.add(parent_before)
            if len(changed) == 3:   # split: new internal above the winner
                touched.add(placer.name_of(changed[1]))
    _err(f"Placed {placed} samples ({retried} bounded/stale re-scores).")
    return placer


def _slot_by_name(placer, name: str) -> int:
    idx = getattr(placer, "_merge_name_idx", None)
    if idx is None:
        idx = placer._merge_name_idx = {
            nm: i for i, nm in enumerate(placer._names)}
    got = idx.get(name)
    if got is not None:
        return got
    try:
        return len(placer._names) + placer._extra_names.index(name)
    except ValueError:
        return int(placer.big.root_slot)


def merge_main_arrays(mat1: str, mat2: str, output_mat: str,
                      max_depth: int = 20) -> int:
    """CLI flow (cmd_merge over arrays): load both, clear clade
    annotations (merge.cpp:142-153), larger tree is the base, merge,
    condense, save."""
    from ..io.pb_arrays import load_mat_arrays
    ma1 = load_mat_arrays(mat1)
    ma2 = load_mat_arrays(mat2)
    for ma in (ma1, ma2):
        ma.ann_counts = np.zeros(0, np.int32)
        ma.ann_blob = b""

    def leaf_count(ma):
        par = set(ma.parent.tolist())
        return sum(1 for i in range(ma.n) if i not in par)

    if leaf_count(ma2) > leaf_count(ma1):
        ma1, ma2 = ma2, ma1
    placer = merge_mats_arrays(ma1, ma2, max_depth=max_depth)
    placer.save_pb(output_mat)
    return 0
