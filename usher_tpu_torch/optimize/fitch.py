"""Whole-tree Fitch-Sankoff over all segregating positions, as torch ops
(counterpart of usher_tpu/optimize/fitch.py; the derivation is in its
docstring).

X3: all positions of a chunk are lanes of one [N, S, 4] score tensor and
the tree is walked level by level over the BFS-flattened parent array:
leaf -> root, each level's child rows are summed into its unique parents
(an int32 ``index_add_``, so polytomies of any width are safe) and
renormalized at once; root -> leaf, each level picks its states from its
parents'.  ``_fs_chunk`` is the normalized unit-cost DP (uint8 scores in
{0, 1}), ``_min_back_chunk`` the (parsimony, back-mutation) lexicographic
DP.  Both run on the device of their inputs.

The JAX programs padded every level to one width (a jit-static shape) and
dropped the padding's writes with ``mode="drop"``; here a level is its real
index list, so no write leaves its range and nothing is dropped.  What the
padding did to the root's row is kept as an explicit rule
(``_root_row_kept``).  Positions are chunked to bound device memory; the
last chunk is simply narrower (each position is its own DP).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.tree import Mutation, Tree
from ..utils.device import apply_platform_env

_BITS = (1, 2, 4, 8)


def flatten_bfs(T: Tree):
    """BFS arrays: (bfs nodes, parent idx int32, is_leaf bool, levels) where
    levels is a list of int32 index arrays per tree level (ascending)."""
    bfs = T.breadth_first_expansion()
    n = len(bfs)
    idx = {id(node): i for i, node in enumerate(bfs)}
    parent = np.zeros(n, dtype=np.int32)
    is_leaf = np.zeros(n, dtype=bool)
    levels: dict[int, list[int]] = {}
    for i, node in enumerate(bfs):
        parent[i] = idx[id(node.parent)] if node.parent is not None else 0
        is_leaf[i] = node.is_leaf()
        levels.setdefault(node.level, []).append(i)
    keys = sorted(levels)
    level_arrays = [np.asarray(levels[k], dtype=np.int32) for k in keys]
    return bfs, parent, is_leaf, level_arrays


def leaf_masks_from_tree(T: Tree, positions: np.ndarray, bfs=None):
    """Reconstruct every leaf's genotype mask by root->leaf mutation
    accumulation over the segregating positions (the Original_State_t of the
    reference, check_samples.cpp:35-41).  Returns [n_bfs, P] uint8 with
    nonzero rows only at leaves; internal rows hold the recorded path state
    (useful as an FS warm reference)."""
    if bfs is None:
        bfs = T.breadth_first_expansion()
    pos_index = {int(p): i for i, p in enumerate(positions)}
    P = len(positions)
    n = len(bfs)
    idx = {id(node): i for i, node in enumerate(bfs)}
    ref_row = np.zeros(P, dtype=np.uint8)
    # reference alleles from recorded ref_nuc
    for node in bfs:
        for m in node.mutations:
            if m.position in pos_index:
                ref_row[pos_index[m.position]] = m.ref_nuc
    state = np.zeros((n, P), dtype=np.uint8)
    for i, node in enumerate(bfs):
        row = state[idx[id(node.parent)]] if node.parent is not None else ref_row
        if node.mutations:
            row = row.copy()
            for m in node.mutations:
                j = pos_index.get(m.position)
                if j is not None:
                    row[j] = m.mut_nuc
        state[i] = row
    return state, ref_row


class _Levels:
    """The per-level index tensors of one tree snapshot on one device:
    ``lev[li]`` the level's BFS rows, ``slot[li]`` each row's parent's slot
    in ``up[li]``, the level's sorted unique parent rows, and ``par[li]``
    the parent rows themselves; ``is_leaf`` [N] bool.  ``max_u`` is the
    most unique parents of any level below the root's."""

    def __init__(self, levels, parent, is_leaf, uparents, max_u: int,
                 device):
        def t(a):
            return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device)
        self.is_leaf = torch.from_numpy(is_leaf).to(device)
        self.lev = [t(a) for a in levels]
        self.par = [t(parent[a]) for a in levels]
        self.up = [t(u) for u in uparents]
        self.slot = [t(np.searchsorted(u, parent[a])) if i else None
                     for i, (a, u) in enumerate(zip(levels, uparents))]
        self.max_u = max_u


def _root_row_kept(lv: _Levels, li: int) -> bool:
    """Whether level li's pass writes its unique parents' new rows.

    The root-row rule (usher_tpu/optimize/fitch.py:116-120, ROADMAP queue C,
    reproduced, not fixed): JAX padded every level's unique-parent list to
    max_u with slot 0, the root, carrying the root's old row, and its
    scatter kept the last of the duplicate writes.  So at level 1, whose
    only unique parent is the root, the root's new row was overwritten by
    its old one whenever some level has more than one unique parent.  The
    root's score row is updated only when every level has at most one."""
    return li != 1 or lv.max_u == 1


def _leaf_bits(leaf_mask):
    k = torch.tensor(_BITS, dtype=torch.uint8, device=leaf_mask.device)
    return (leaf_mask[:, :, None] & k) != 0, k


def _masks_of(scores, k):
    """Major-allele masks [N, S] uint8: the bits of the zero-score states."""
    return ((scores == 0).to(torch.uint8) * k).sum(-1, dtype=torch.uint8)


def _fs_chunk(leaf_mask, lv: _Levels, ref_nt):
    """One position chunk of the normalized-cost Fitch-Sankoff DP.

    leaf_mask [N, S] uint8 and ref_nt [S] int64 on the device of lv.
    Returns (states [N, S] int64, masks [N, S] uint8); scores are
    normalized, so a node's score row is 0 at its subtree-optimal
    (Fitch-set) states."""
    N, S = leaf_mask.shape
    in_mask, k = _leaf_bits(leaf_mask)
    scores = torch.where(lv.is_leaf[:, None, None] & ~in_mask,
                         torch.ones((), dtype=torch.uint8,
                                    device=leaf_mask.device),
                         torch.zeros((), dtype=torch.uint8,
                                     device=leaf_mask.device))

    # backward (leaf -> root), level by level, deepest first
    for li in range(len(lv.lev) - 1, 0, -1):
        up = lv.up[li]
        # normalized child rows are already the contributions (0/1)
        acc = torch.zeros((up.shape[0], S, 4), dtype=torch.int32,
                          device=scores.device)
        acc.index_add_(0, lv.slot[li], scores[lv.lev[li]].to(torch.int32))
        acc -= acc.amin(-1, keepdim=True)
        if _root_row_kept(lv, li):
            scores[up] = acc.clamp_(max=1).to(torch.uint8)

    masks = _masks_of(scores, k)

    # forward (root -> leaf): normalized rows have min 0
    def pick(sc, par_state):
        first = torch.argmin(sc, dim=-1)
        par_sc = torch.gather(sc, -1, par_state[..., None])[..., 0]
        return torch.where(par_sc == 0, par_state, first)

    states = torch.empty((N, S), dtype=torch.int64, device=scores.device)
    states[0] = pick(scores[0], ref_nt)
    for li in range(1, len(lv.lev)):
        states[lv.lev[li]] = pick(scores[lv.lev[li]], states[lv.par[li]])
    return states, masks


_BACK_K = 1 << 12  # parsimony weight; back-mutation counts stay below this


def _min_back_chunk(leaf_mask, lv: _Levels, ref_nt):
    """Min-back-mutation Fitch-Sankoff: lexicographically minimize
    (parsimony, #back-mutations) -- a mutation a->b is "back" when b is the
    reference base (reference src/usher-sampled/Min_back_FS.cpp:55-192, a
    4x4 DP per node per position).

    Weighted-cost DP: edge cost(a->b) = 0 if a==b else K + (b==ref), K
    large.  Scores are normalized per row and clipped to 2K+3: transitions
    add at most K+1, so a value above that bound can never win or tie a
    comparison, keeping the DP exact.  Same arguments and results as
    _fs_chunk."""
    N, S = leaf_mask.shape
    dev = leaf_mask.device
    K = _BACK_K
    big = 2 * K + 3
    in_mask, k = _leaf_bits(leaf_mask)
    scores = torch.where(lv.is_leaf[:, None, None] & ~in_mask,
                         torch.full((), big, dtype=torch.int32, device=dev),
                         torch.zeros((), dtype=torch.int32, device=dev))

    # cost[s, a, b] = 0 if a == b else K + (b == ref[s])
    ab = torch.arange(4, device=dev)
    cost = torch.where(ab[None, :, None] == ab[None, None, :], 0,
                       K + (ab[None, None, :] == ref_nt[:, None, None]
                            ).to(torch.int32)).to(torch.int32)

    for li in range(len(lv.lev) - 1, 0, -1):
        up = lv.up[li]
        # child rows [L, S, 4(b)] -> contribution [L, S, 4(a)]
        contrib = (scores[lv.lev[li]][:, :, None, :] + cost[None]).amin(-1)
        acc = torch.zeros((up.shape[0], S, 4), dtype=torch.int32, device=dev)
        acc.index_add_(0, lv.slot[li], contrib)
        acc -= acc.amin(-1, keepdim=True)
        if _root_row_kept(lv, li):
            scores[up] = acc.clamp_(max=big)

    # forward: child picks argmin_b(score[b] + cost(par->b)), parent-
    # following on ties
    s_idx = torch.arange(S, device=dev)

    def pick(sc, par_state):
        tot = sc + cost[s_idx[None, :], par_state]            # [L, S, 4]
        mn = tot.amin(-1)
        first = torch.argmin(tot, dim=-1)
        par_tot = torch.gather(tot, -1, par_state[..., None])[..., 0]
        return torch.where(par_tot == mn, par_state, first)

    states = torch.empty((N, S), dtype=torch.int64, device=dev)
    # root: prefer ref when tied for min
    root_sc = scores[0]
    ref_sc = torch.gather(root_sc, -1, ref_nt[:, None])[:, 0]
    states[0] = torch.where(ref_sc == root_sc.amin(-1), ref_nt,
                            torch.argmin(root_sc, dim=-1))
    for li in range(1, len(lv.lev)):
        states[lv.lev[li]] = pick(scores[lv.lev[li]], states[lv.par[li]])
    return states, _masks_of(scores, k)


class FitchEngine:
    """Caches the flattened topology and its per-level index tensors for
    repeated FS passes over the same tree snapshot."""

    def __init__(self, T: Tree, positions: np.ndarray, chunk: int = 512,
                 mesh=None, device=None):
        """mesh: optional 1-D parallel.mesh.Mesh -- shards the position axis
        of each DP chunk over its devices (the analog of the reference's MPI
        position sharding, src/usher-sampled/utils.cpp:113-481).  device:
        where the DP runs without a mesh (default: from USHER_TPU_PLATFORM,
        utils/device.py)."""
        self.T = T
        self.positions = positions
        self.bfs, self.parent, self.is_leaf, self.levels = flatten_bfs(T)
        self.n = len(self.bfs)
        self.mesh = mesh
        self.device = (torch.device(device) if device is not None
                       else mesh.lead if mesh is not None
                       else apply_platform_env())
        # with a mesh, each device works a `chunk`-wide position slice
        self.chunk = int(chunk) * (mesh.size if mesh is not None else 1)
        self.uparents = [np.unique(self.parent[a]) for a in self.levels]
        self.max_u = max((len(u) for u in self.uparents[1:]), default=1) or 1
        self._lv = {}

    def _levels_on(self, device) -> _Levels:
        device = torch.device(device)
        if device not in self._lv:
            self._lv[device] = _Levels(self.levels, self.parent,
                                       self.is_leaf, self.uparents,
                                       self.max_u, device)
        return self._lv[device]

    def _solve(self, lm: np.ndarray, rn: np.ndarray, min_back: bool):
        """One position chunk (leaf masks [n, S] uint8, ref state index [S])
        on the engine's device or split over the mesh; returns host
        (states int8, masks uint8) [n, S]."""
        fn = _min_back_chunk if min_back else _fs_chunk
        if self.mesh is None:
            devs = [(self.device, 0, lm.shape[1])]
        else:
            from ..parallel.mesh import split_bounds
            devs = [(d, lo, hi) for d, (lo, hi) in zip(
                self.mesh.devices.reshape(-1).tolist(),
                split_bounds(lm.shape[1], self.mesh.size)) if hi > lo]
        st_parts, mk_parts = [], []
        # positions are independent DP problems: each shard solves its own
        # column slice, no collectives
        for device, lo, hi in devs:
            st, mk = fn(torch.from_numpy(np.ascontiguousarray(
                            lm[:, lo:hi])).to(device),
                        self._levels_on(device),
                        torch.from_numpy(rn[lo:hi]).to(device))
            st_parts.append(st.to(torch.int8))
            mk_parts.append(mk)
        states = np.concatenate([s.cpu().numpy() for s in st_parts], axis=1)
        masks = np.concatenate([m.cpu().numpy() for m in mk_parts], axis=1)
        return states, masks

    @staticmethod
    def _ref_nt(ref_row):
        ref_nt = np.zeros(len(ref_row), dtype=np.int64)
        nz = ref_row > 0
        ref_nt[nz] = np.log2(ref_row[nz]).astype(np.int64)
        return ref_nt

    def run(self, leaf_masks, ref_row: np.ndarray,
            min_back: bool = False):
        """leaf_masks: [n,P] uint8 (rows meaningful at leaves) OR a
        SparseLeafStore (optimize/leafstore.py) materialized per chunk —
        the pandemic-scale path that never holds the dense matrix.
        ref_row [P].  min_back selects the (parsimony, #back-mutations)
        lexicographic DP (reference Min_back_FS.cpp).
        Returns (states [n,P] int8 0..3, masks [n,P] uint8)."""
        store = None
        if not isinstance(leaf_masks, np.ndarray):
            store = leaf_masks
        P = len(ref_row)
        ref_nt = self._ref_nt(ref_row)
        states = np.empty((self.n, P), dtype=np.int8)
        masks = np.empty((self.n, P), dtype=np.uint8)
        for c0 in range(0, P, self.chunk):
            c1 = min(c0 + self.chunk, P)
            if store is not None:
                lm = store.materialize(self.bfs, self.is_leaf, c0, c1)
            else:
                lm = leaf_masks[:, c0:c1]
            states[:, c0:c1], masks[:, c0:c1] = self._solve(
                lm, ref_nt[c0:c1], min_back)
        return states, masks

    def run_rewrite_streamed(self, store, ref_row: np.ndarray, chrom: str,
                             min_back: bool = False):
        """Fused streamed pass: per position chunk, solve the DP, rewrite
        that chunk's branch mutations, and record the Fitch-mask deviations
        from ref — WITHOUT ever retaining the [n, P] states/masks matrices.
        The pandemic-scale optimizer path (each iteration re-runs this full
        pass instead of the local patch, the discipline of the reference's
        MPI FS rounds, utils.cpp:113-481).

        Returns (parsimony_score, MaskDeviations)."""
        P = len(ref_row)
        ref_nt = self._ref_nt(ref_row)
        devs = MaskDeviations(self.n)
        per_node: list[list] = [[] for _ in range(self.n)]
        total = 0
        trip_node, trip_col, trip_par, trip_mut = [], [], [], []
        for c0 in range(0, P, self.chunk):
            c1 = min(c0 + self.chunk, P)
            lm = store.materialize(self.bfs, self.is_leaf, c0, c1)
            st_h, mk_h = self._solve(lm, ref_nt[c0:c1], min_back)
            devs.set_chunk(c0, mk_h, ref_row[c0:c1])
            arrays = self._mutation_arrays(st_h, lm, ref_row[c0:c1])
            ni, si, pv, mv = arrays
            trip_node.append(ni)
            trip_col.append(si + c0)
            trip_par.append(pv)
            trip_mut.append(mv)
            chunk_nodes, chunk_total = self._lists_of(
                arrays, ref_row[c0:c1], self.positions[c0:c1], chrom)
            total += chunk_total
            for i, muts in enumerate(chunk_nodes):
                if muts:
                    per_node[i].extend(muts)
        for i, node in enumerate(self.bfs):
            node.mutations = per_node[i]
        # array form of the whole-tree mutation set, so the SPR finder can
        # build its CSR snapshot without a per-mutation Python from_tree
        devs.csr_triplets = (
            np.concatenate(trip_node) if trip_node else np.zeros(0, np.int64),
            np.concatenate(trip_col) if trip_col else np.zeros(0, np.int64),
            np.concatenate(trip_par) if trip_par else np.zeros(0, np.uint8),
            np.concatenate(trip_mut) if trip_mut else np.zeros(0, np.uint8))
        return total, devs

    def _mutation_arrays(self, states, leaf_masks, ref_row):
        """Vectorized branch-mutation extraction from FS states: returns
        (node_idx i64, site_idx i64, par_nib u8, mut_nib u8) over the given
        position axis — the array form BigMAT consumes directly (no
        per-mutation Python)."""
        # uint8 shifts: no int32 copy of the [n, S] states
        self_nib = np.left_shift(np.uint8(1), states.astype(np.uint8))
        par_nib = self_nib[self.parent]
        par_nib[0] = np.left_shift(np.uint8(1), np.where(
            ref_row > 0, np.log2(np.maximum(ref_row, 1)).astype(np.uint8),
            np.uint8(0)))
        leaf_arr = self.is_leaf
        mut = self_nib != par_nib
        leaves = np.flatnonzero(leaf_arr)
        mut[leaves] = (leaf_masks[leaves] & par_nib[leaves]) == 0
        # few rows of a chunk carry a mutation: find them first
        rows = np.flatnonzero(mut.any(axis=1))
        r, site_idx = np.nonzero(mut[rows])
        node_idx = rows[r]
        mut_v = np.where(leaf_arr[node_idx],
                         leaf_masks[node_idx, site_idx],
                         self_nib[node_idx, site_idx])
        keep = mut_v != 0
        return (node_idx[keep], site_idx[keep],
                par_nib[node_idx, site_idx][keep], mut_v[keep])

    def _mutation_lists(self, states, leaf_masks, ref_row, positions, chrom):
        """Per-node mutation lists implied by FS states over the given
        position axis (width of states/leaf_masks/ref_row).  Returns
        (per_node lists, total count)."""
        return self._lists_of(
            self._mutation_arrays(states, leaf_masks, ref_row), ref_row,
            positions, chrom)

    def _lists_of(self, arrays, ref_row, positions, chrom):
        """_mutation_lists from the _mutation_arrays it would compute."""
        node_idx, site_idx, par_v, mut_v = arrays
        pos_v = np.asarray(positions)[site_idx]
        ref_v = ref_row[site_idx]
        per_node: list[list[Mutation]] = [[] for _ in range(self.n)]
        for ni, pos, r, pn, mn in zip(node_idx.tolist(), pos_v.tolist(),
                                      ref_v.tolist(), par_v.tolist(),
                                      mut_v.tolist()):
            per_node[ni].append(Mutation(chrom=chrom, position=pos,
                                         ref_nuc=r, par_nuc=pn, mut_nuc=mn))
        return per_node, len(node_idx)

    def patch_mutations(self, states: np.ndarray, leaf_masks: np.ndarray,
                        ref_row: np.ndarray, chrom: str,
                        col_positions) -> int:
        """Restricted rewrite: replace branch mutations ONLY at the given
        genome positions (the local FS patch-up of reference apply_move/
        backward_pass.cpp — topology changes only perturb states at
        positions mutated on the touched subtrees/paths).  The arrays here
        are restricted to those columns.  Returns the parsimony DELTA
        (#added - #removed) over the patched positions."""
        positions = np.asarray(col_positions)
        per_node, added = self._mutation_lists(states, leaf_masks, ref_row,
                                               positions, chrom)
        pos_set = {int(p) for p in positions}
        removed = 0
        for i, node in enumerate(self.bfs):
            old = node.mutations
            if not old and not per_node[i]:
                continue
            kept = [m for m in old if m.position not in pos_set]
            removed += len(old) - len(kept)
            if per_node[i]:
                merged = kept + per_node[i]
                merged.sort(key=lambda m: m.position)
                node.mutations = merged
            else:
                node.mutations = kept
        return added - removed

    def rewrite_mutations(self, states: np.ndarray, leaf_masks,
                          ref_row: np.ndarray, chrom: str) -> int:
        """Replace every node's branch mutations from the FS states.

        Internal nodes take single FS states; leaves keep their full original
        genotype mask as mut_nuc when the parent state is outside it
        (ambiguity-preserving, so genotype reconstruction stays exact).
        leaf_masks may be a dense [n, P] array or a SparseLeafStore
        (materialized per column chunk).  Returns the new total parsimony
        score."""
        if isinstance(leaf_masks, np.ndarray):
            per_node, total = self._mutation_lists(
                states, leaf_masks, ref_row, self.positions, chrom)
        else:
            store = leaf_masks
            P = len(ref_row)
            per_node = [[] for _ in range(self.n)]
            total = 0
            for c0 in range(0, P, self.chunk):
                c1 = min(c0 + self.chunk, P)
                lm = store.materialize(self.bfs, self.is_leaf, c0, c1)
                chunk_nodes, chunk_total = self._mutation_lists(
                    states[:, c0:c1], lm, ref_row[c0:c1],
                    self.positions[c0:c1], chrom)
                total += chunk_total
                for i, muts in enumerate(chunk_nodes):
                    if muts:
                        per_node[i].extend(muts)
        for i, node in enumerate(self.bfs):
            node.mutations = per_node[i]
        return total


class MaskDeviations:
    """Per-node sparse deviations of the FS Fitch masks from the reference
    row: CSR (row_ptr, cols, vals).  The streamed-states optimizer path
    (optimize/driver.py stream_states) keeps ONLY this instead of the dense
    [n, P] states/masks matrices; BigMoveFinder consumes it directly.

    The entries are held as flat (row, col, val) arrays, grouped into the
    CSR when first read: a chunk costs numpy passes, not a Python step per
    node."""

    def __init__(self, n: int):
        self.n = n
        # (rows, cols, vals) runs in ascending column order
        self._parts: list = []
        self._csr = None

    def set_chunk(self, c0: int, mk_chunk: np.ndarray,
                  ref_chunk: np.ndarray) -> None:
        rows, cols = np.nonzero(mk_chunk != ref_chunk[None, :])
        if len(rows):
            self._parts.append((rows, cols + c0, mk_chunk[rows, cols]))
            self._csr = None

    def _arrays(self):
        """(row_ptr [n + 1], cols int64, vals uint8): a stable sort by row
        keeps each row's columns ascending, as the runs came in column
        order."""
        if self._csr is None:
            if self._parts:
                rows, cols, vals = (np.concatenate(a)
                                    for a in zip(*self._parts))
            else:
                rows, cols = np.zeros(0, np.int64), np.zeros(0, np.int64)
                vals = np.zeros(0, np.uint8)
            o = np.argsort(rows, kind="stable")
            rows, cols, vals = rows[o], cols[o], vals[o]
            self._parts = [(rows, cols, vals)]
            self._csr = (np.searchsorted(rows, np.arange(self.n + 1)),
                         cols, vals)
        return self._csr

    def deviations(self, i: int):
        """(cols int64[], mask values uint8[]) for node i; chunks were
        appended in ascending column order so cols are sorted."""
        ptr, cols, vals = self._arrays()
        return cols[ptr[i]:ptr[i + 1]], vals[ptr[i]:ptr[i + 1]]

    def remap_patch(self, src_rows, cols_arr, mk_sub: np.ndarray,
                    ref_sub: np.ndarray) -> "MaskDeviations":
        """Incremental update after a local FS patch: new node order
        `src_rows` (new row i copies old row src_rows[i]), with deviations
        at `cols_arr` REPLACED from the freshly solved mk_sub [n, |cols|].
        Every column where a new/changed node's mask can differ from its
        copy source is in cols_arr (the affected-position set), so rows are
        exact (same argument as the dense engine's states/masks remap,
        optimize/driver.py)."""
        src = np.asarray(src_rows, dtype=np.int64)
        n = len(src)
        ptr, cols, vals = self._arrays()
        colset = np.asarray(cols_arr, dtype=np.int64)
        # the copied rows' entries: the run ptr[src[i]]:ptr[src[i] + 1] for
        # each new row i (none for a row with no source)
        has = (src >= 0) & (src < self.n)
        lo = np.where(has, ptr[np.where(has, src, 0)], 0)
        cnt = np.where(has, ptr[np.where(has, src, 0) + 1], 0) - lo
        new_row = np.repeat(np.arange(n, dtype=np.int64), cnt)
        take = np.arange(len(new_row)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        take += np.repeat(lo, cnt)
        c, v = cols[take], vals[take]
        if len(colset):
            at = np.searchsorted(colset, c)
            keep = ~((at < len(colset))
                     & (colset[np.minimum(at, len(colset) - 1)] == c))
            new_row, c, v = new_row[keep], c[keep], v[keep]
            r2, k = np.nonzero(mk_sub != ref_sub[None, :])
            new_row = np.concatenate([new_row, r2])
            c = np.concatenate([c, colset[k]])
            v = np.concatenate([v, mk_sub[r2, k]])
        o = np.lexsort((c, new_row))
        out = MaskDeviations(n)
        out._parts = [(new_row[o], c[o], v[o])]
        return out
