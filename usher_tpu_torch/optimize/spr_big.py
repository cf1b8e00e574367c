"""CSR-backed SPR move search: the pandemic-scale MoveFinder (counterpart of
usher_tpu/optimize/spr_big.py; the derivation is in its docstring).

The dense MoveFinder holds st/stp [N, P] on the device.  This finder scores
each source's subtree Fitch mask as a SPARSE entry set (its deviations from
the reference row) through the DFS-interval engine (X7, ops/interval.py):
one scatter and one scan per chunk, the radius bound computed on the device
as a nested-interval count and the tie-broken argmin reduced there, so only
three [B] vectors leave it.  A chunk takes one of three paths:

  device  ``interval_spr_dev``: the events expanded on the device from
          BigMAT's resident CSC index (the widest column must hold at most
          DEV_MAX_OCCUPANCY mutations and the [B, K, occupancy] pair grid
          at most EXPANSION_BUDGET pairs)
  host    ``interval_spr``: the events expanded on the host, linear in the
          actual deviations (one near-root subtree mask can make K huge)
  mesh    ``_spr_sharded_fn``: host events split over a batch mesh

``paths`` counts the chunks each path took.  Results are bit-identical to
MoveFinder.find_moves on every path (tested).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.bigmat import DEV_MAX_OCCUPANCY, BigMAT
from ..core.tree import Tree
from ..ops import interval as iv
from ..utils.device import apply_platform_env
from .spr import Move, MoveFinder, collapse_bonus

# most (entry, column-mutation) pairs a device-expanded chunk may hold
EXPANSION_BUDGET = 1 << 25


def _fetch3(out):
    """The three per-chunk result vectors in ONE host copy (int32)."""
    packed = torch.stack([o.to(torch.int32) for o in out]).cpu().numpy()
    return packed[0], packed[1], packed[2]


class BigMoveFinder(MoveFinder):
    """MoveFinder drop-in whose scoring path never materializes [N, P]
    state matrices on the device."""

    def __init__(self, T: Tree, states: np.ndarray, masks: np.ndarray,
                 ref_row: np.ndarray, bfs, parent: np.ndarray,
                 chunk: int = 128, positions=None, mesh=None, csr=None,
                 device=None):
        """mesh: optional 1-D parallel.mesh.Mesh — shards the SOURCE batch
        axis of the interval-engine SPR scorer over its devices with the
        CSR metadata replicated (the analog of the reference's MPI SPR work
        distributor, optimize_tree.cpp:165-252).

        csr: optional (node_idx, col, par_nib, mut_nib) arrays (the
        streamed FS emits them, fitch.py run_rewrite_streamed) — builds the
        CSR snapshot directly, skipping the O(mutations) Python from_tree
        walk.  device: where the BigMAT lives (default: the mesh's lead
        device, else from USHER_TPU_PLATFORM)."""
        # host bookkeeping only — never upload [N, P] state matrices
        self.T = T
        self.bfs = bfs
        self.parent = parent
        self.mesh = mesh
        self.device = (torch.device(device) if device is not None
                       else mesh.lead if mesh is not None
                       else apply_platform_env())
        self.chunk = chunk * (mesh.size if mesh is not None else 1)
        n = len(bfs)
        self.n = n
        self.masks = masks   # dense [n, P] uint8 OR MaskDeviations
        self.ref_row = ref_row
        self.paths = {"device": 0, "host": 0, "mesh": 0}

        T.depth_first_expansion()
        self.bfs_index = {id(node): i for i, node in enumerate(bfs)}
        self.dfs_idx = np.array([node.dfs_idx for node in bfs],
                                dtype=np.int64)
        self.dfs_end = np.array([node.dfs_end_idx for node in bfs],
                                dtype=np.int64)
        self.level = np.array([node.level for node in bfs], dtype=np.int32)

        self.adj: list[list[int]] = [[] for _ in range(n)]
        for i in range(1, n):
            self.adj[i].append(int(parent[i]))
            self.adj[parent[i]].append(i)

        if positions is None:
            positions = np.arange(masks.shape[1], dtype=np.int64)
        if csr is not None:
            node_a, col_a, par_a, mut_a = csr
            order = np.argsort(node_a, kind="stable")
            counts = np.bincount(node_a, minlength=n).astype(np.int64)
            mut_ptr = np.zeros(n + 1, dtype=np.int64)
            mut_ptr[1:] = np.cumsum(counts)
            self.big = BigMAT(parent.astype(np.int32), mut_ptr,
                              col_a[order].astype(np.int32),
                              par_a[order], mut_a[order],
                              positions, ref_row, device=self.device)
            self.big._nodes = bfs
            if os.environ.get("USHER_TPU_CHECK_CSR"):
                # invariant checker: array-maintained triplets must equal a
                # from-scratch from_tree build (per-node column/allele sets)
                chk = BigMAT.from_tree(T, positions, ref_row,
                                       device=self.device)
                for i in range(n):
                    a = sorted(zip(
                        self.big.mut_col[self.big.mut_ptr[i]:
                                         self.big.mut_ptr[i + 1]].tolist(),
                        self.big.mut_par[self.big.mut_ptr[i]:
                                         self.big.mut_ptr[i + 1]].tolist(),
                        self.big.mut_mut[self.big.mut_ptr[i]:
                                         self.big.mut_ptr[i + 1]].tolist()))
                    b = sorted(zip(
                        chk.mut_col[chk.mut_ptr[i]:
                                    chk.mut_ptr[i + 1]].tolist(),
                        chk.mut_par[chk.mut_ptr[i]:
                                    chk.mut_ptr[i + 1]].tolist(),
                        chk.mut_mut[chk.mut_ptr[i]:
                                    chk.mut_ptr[i + 1]].tolist()))
                    assert a == b, (
                        f"CHECK_CSR: node {i} triplets diverge from "
                        f"from_tree: {a} vs {b}")
        else:
            self.big = BigMAT.from_tree(T, positions, ref_row,
                                        device=self.device)
        self.big.mesh = mesh
        # BigMAT slots are BFS order == our bfs indexing; verify cheaply
        if not np.array_equal(self.big.parent, parent.astype(np.int32)):
            raise AssertionError("BigMAT BFS order diverged from FitchEngine")
        self._num_leaves_h = np.asarray(self.big.num_leaves)
        self._bfs_rank_h = np.arange(self.n, dtype=np.int32)

    def _mc_for(self, pos):
        """The widest column occupancy of the chunk's entries (the pair
        grid's last axis), or None past DEV_MAX_OCCUPANCY (host events)."""
        big = self.big
        e = pos < big.P
        if not e.any():
            return 1
        mx = int((big.csc_ptr[pos[e] + 1] - big.csc_ptr[pos[e]]).max())
        return max(mx, 1) if mx <= DEV_MAX_OCCUPANCY else None

    def _dev_of(self, si):
        """(cols, mask values) where node si's Fitch mask deviates from the
        reference row -- from a dense masks matrix or MaskDeviations."""
        if isinstance(self.masks, np.ndarray):
            cols = np.nonzero(self.masks[si] != self.ref_row)[0]
            return cols, self.masks[si][cols]
        return self.masks.deviations(si)

    def find_moves(self, radius: int, sources=None, log=None) -> list[Move]:
        big = self.big
        n = self.n
        bfs = self.bfs
        if sources is None:
            sources = [i for i in range(1, n)]
        moves: list[Move] = []
        max_level = int(self.level.max()) if n else 0
        eff_radius = radius if radius > 0 else 2 * max_level + 2
        dfs_of = big.dfs_of
        dfs_end_of = big.dfs_end_of

        for c0 in range(0, len(sources), self.chunk):
            idxs = sources[c0:c0 + self.chunk]
            B = len(idxs)
            oldcost = np.zeros(B, dtype=np.int64)
            # sparse entries: deviations of each source's Fitch mask from ref
            devs = []
            max_k = 1
            anc_rows = []   # (dfs row, dfs end, source) per proper ancestor
            src_level = np.zeros(B, dtype=np.int32)
            src_lo = np.zeros(B, dtype=np.int32)
            src_hi = np.zeros(B, dtype=np.int32)
            src_parent_row = np.zeros(B, dtype=np.int32)
            for b, si in enumerate(idxs):
                node = bfs[si]
                oldcost[b] = len(node.mutations) + collapse_bonus(node)
                cols, vals = self._dev_of(si)
                devs.append((cols, vals))
                max_k = max(max_k, len(cols))
                p = int(self.parent[si])
                while True:
                    anc_rows.append((dfs_of[p], dfs_end_of[p], b))
                    if p == 0:
                        break
                    p = int(self.parent[p])
                # BigMAT levels (0-based hops to root), matching meta["level"]
                # and the ancestor-count lca — host Tree levels are 1-based
                src_level[b] = big.level[si]
                src_lo[b] = dfs_of[si]
                src_hi[b] = dfs_end_of[si]
                src_parent_row[b] = dfs_of[int(self.parent[si])]

            K = max_k
            pos = np.full((B, K), big.P, dtype=np.int32)
            gval = np.zeros((B, K), dtype=np.uint8)
            for b, (cols, vals) in enumerate(devs):
                pos[b, :len(cols)] = cols
                gval[b, :len(cols)] = vals

            ar = np.asarray(anc_rows, dtype=np.int32).reshape(-1, 3)
            cnt = (np.concatenate([ar[:, 0], ar[:, 1]]),
                   np.concatenate([ar[:, 2], ar[:, 2]]),
                   np.concatenate([np.ones(len(ar), np.int32),
                                   -np.ones(len(ar), np.int32)]))
            if self.mesh is not None:
                self.paths["mesh"] += 1
                cost, row, hu = self._find_sharded(
                    pos, gval, cnt, src_level, src_lo, src_hi,
                    src_parent_row, eff_radius)
            else:
                cost, row, hu = self._find_one(
                    pos, gval, cnt, src_level, src_lo, src_hi,
                    src_parent_row, eff_radius)

            slot = big.dfs_order[np.minimum(row[:B], big.N - 1)]
            for b, si in enumerate(idxs):
                imp = int(oldcost[b]) - int(cost[b])
                if imp > 0 and cost[b] < (1 << 29):
                    d = int(slot[b])
                    moves.append(Move(
                        src=bfs[si], dst=bfs[d], improvement=imp,
                        sibling_split=bool(hu[b]) or bfs[d].is_leaf(),
                        src_interval=(int(self.dfs_idx[si]),
                                      int(self.dfs_end[si])),
                        dst_dfs=int(self.dfs_idx[d])))
        return moves

    def _find_one(self, pos, gval, cnt, src_level, src_lo, src_hi,
                  src_parent_row, radius):
        """One chunk on the BigMAT's device: device expansion, or host
        events past the expansion budget."""
        big = self.big
        B, K = pos.shape
        meta = big._dfs_meta(spr=True)
        t = big._t
        margs = (meta["num_mut"], meta["is_root"], meta["active"],
                 meta["num_leaves"], meta["bfs_rank"], meta["level"])
        srcs = (t(src_level), t(src_lo), t(src_hi), t(src_parent_row))
        cntp = [t(a) for a in iv.pad_events(*cnt, big.N)]
        mc = self._mc_for(pos)
        # the expansion materializes [B, K, mc] intermediates; one
        # exceedingly deviant source (near-root subtree mask) can inflate K
        # unboundedly — host events (linear in actual deviations) past the
        # budget
        if mc is not None and B * K * mc > EXPANSION_BUDGET:
            mc = None
        if mc is not None:
            self.paths["device"] += 1
            # device-side expansion from the resident CSC index: the
            # chunk's H2D is the [B, K] deviation arrays, not the expanded
            # event streams
            return _fetch3(iv.interval_spr_dev(
                *big._csc_dev(), t(pos), t(gval), *cntp,
                meta["base"], meta["nc_base"], *margs, *srcs, radius,
                big.N, B, mc))
        self.paths["host"] += 1
        *ev, add0 = big._events(pos, gval, np.zeros((B, K), dtype=bool),
                                spr=True)
        return _fetch3(iv.interval_spr(
            *(t(a) for a in iv.pad_events(*ev[:3], big.N)),
            *(t(a) for a in iv.pad_events(*ev[3:6], big.N)),
            *cntp, meta["base"], meta["nc_base"], t(add0.astype(np.int32)),
            *margs, *srcs, radius, big.N, B))

    def _find_sharded(self, pos, gval, cnt, src_level, src_lo, src_hi,
                      src_parent_row, radius):
        """One chunk split over the batch mesh (host events, X7 a shard)."""
        from ..parallel.mesh import split_bounds
        big = self.big
        B, K = pos.shape
        nd = self.mesh.size
        bl = max(1, split_bounds(B, nd)[0][1])
        *ev, add0 = big._events(pos, gval, np.zeros((B, K), dtype=bool),
                                spr=True)
        fn = iv._spr_sharded_fn(self.mesh, big.N, bl)
        packed = fn(iv.shard_events(ev[:3], nd, bl, big.N),
                    iv.shard_events(ev[3:6], nd, bl, big.N),
                    iv.shard_events(cnt, nd, bl, big.N),
                    big._dfs_meta(spr=True, sharded=True),
                    add0.astype(np.int32), src_level, src_lo, src_hi,
                    src_parent_row, radius)
        return packed[0], packed[1], packed[2]

    # -- host-side mirror of the device mask/reduction (cross-check only) ----

    def _reduce(self, idxs, score, nc, nnm, radius):
        """Numpy mirror of interval_spr's device mask + reduction
        (optimize/spr.py _score_moves semantics); kept as the test oracle
        for the device path."""
        B = len(idxs)
        n = self.n
        has_unique = nc < nnm[None, :]
        nc_pos = nc > 0
        root_mask = np.zeros(n, dtype=bool)
        root_mask[0] = True
        # is_leaf passed as zeros in the dense scorer: leaves get
        # sibling-split via has_unique
        valid = (root_mask[None, :]
                 | (has_unique & nc_pos)
                 | (~has_unique))

        lvl = self.level
        ok = np.zeros((B, n), dtype=bool)
        for b, si in enumerate(idxs):
            # lca level for every dest: deepest src-ancestor containing it
            lca_lvl = np.full(n, -1, dtype=np.int32)
            p = int(self.parent[si])
            while True:
                inside = (self.dfs_idx[p] <= self.dfs_idx) & \
                         (self.dfs_idx < self.dfs_end[p])
                lca_lvl = np.maximum(lca_lvl,
                                     np.where(inside, lvl[p], -1))
                if p == 0:
                    break
                p = int(self.parent[p])
            dist = lvl + lvl[si] - 2 * lca_lvl
            row = dist <= radius
            in_sub = (self.dfs_idx >= self.dfs_idx[si]) & \
                     (self.dfs_idx < self.dfs_end[si])
            row &= ~in_sub
            row[int(self.parent[si])] = False
            ok[b] = row
        valid = valid & ok

        big_c = np.int64(1 << 30)
        s = np.where(valid, score.astype(np.int64), big_c)
        best = s.min(axis=1)
        is_best = valid & (score == best[:, None])
        leaves_masked = np.where(is_best, self._num_leaves_h[None, :], -1)
        best_leaves = leaves_masked.max(axis=1)
        is_best2 = is_best & (self._num_leaves_h[None, :]
                              == best_leaves[:, None])
        rank_masked = np.where(is_best2, self._bfs_rank_h[None, :], -1)
        best_rank = rank_masked.max(axis=1)
        best_slot = np.argmax(
            (self._bfs_rank_h[None, :] == best_rank[:, None]) & is_best2,
            axis=1)
        hu_best = has_unique[np.arange(B), best_slot]
        return best, best_slot.astype(np.int32), hu_best
