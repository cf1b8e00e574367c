"""Sparse leaf-genotype store: the optimizer's Original_State_t without the
dense [nodes x positions] matrix.

The reference keeps every sample's original genotype as a per-node mutation
set (Original_State_t, check_samples.hpp:35-41) — O(total deviations), not
O(n * P).  Round-2's driver materialized a dense uint8 [n, P] leaf matrix
plus a per-leaf row dict (~2 x 60 GB at pandemic scale).  This store keeps
per-leaf sparse deviations from the reference row and materializes dense
column slices on demand for the chunked Fitch-Sankoff DP and the
mutation-rewrite passes.

Leaf genotypes are the invariant of the whole optimization (topology moves
never change them), so the store is built once per optimize_tree call and
survives every iteration's re-flattening (keyed by leaf identifier).
"""

from __future__ import annotations

import numpy as np

from ..core.tree import Tree


class SparseLeafStore:
    """Per-leaf sparse deviations {identifier: (col_idx int64[], val uint8[])}
    against ref_row, over the segregating-position axis."""

    def __init__(self, ref_row: np.ndarray):
        self.ref_row = np.asarray(ref_row, dtype=np.uint8)
        self.rows: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        self._entries = None

    @classmethod
    def from_tree(cls, T: Tree, positions: np.ndarray):
        """Root->leaf accumulation (same semantics as leaf_masks_from_tree):
        a leaf's genotype at a position is the most recent mutation's
        mut_nuc on its root path, else the reference allele.
        Returns (store, ref_row)."""
        pos_index = {int(p): i for i, p in enumerate(positions)}
        P = len(positions)
        ref_row = np.zeros(P, dtype=np.uint8)
        for node in T.depth_first_expansion():
            for m in node.mutations:
                j = pos_index.get(m.position)
                if j is not None:
                    ref_row[j] = m.ref_nuc
        store = cls(ref_row)
        # iterative DFS carrying the sparse state dict
        stack = [(T.root, False)]
        state_stack: list[dict[int, int]] = [{}]
        while stack:
            node, expanded = stack.pop()
            if expanded:
                state_stack.pop()
                continue
            state = state_stack[-1]
            if node.mutations:
                state = dict(state)
                for m in node.mutations:
                    j = pos_index.get(m.position)
                    if j is not None:
                        state[j] = m.mut_nuc
            if node.is_leaf():
                dev = {j: v for j, v in state.items()
                       if v != int(ref_row[j])}
                if dev:
                    cols = np.fromiter(sorted(dev), dtype=np.int64,
                                       count=len(dev))
                    vals = np.array([dev[int(c)] for c in cols],
                                    dtype=np.uint8)
                    store.rows[node.identifier] = (cols, vals)
                else:
                    store.rows[node.identifier] = (
                        np.empty(0, dtype=np.int64),
                        np.empty(0, dtype=np.uint8))
            else:
                stack.append((node, True))
                state_stack.append(state)
                for ch in reversed(node.children):
                    stack.append((ch, False))
        return store, ref_row

    def row(self, identifier: str) -> np.ndarray:
        """Full dense row for one leaf (small helper; O(P))."""
        out = self.ref_row.copy()
        entry = self.rows.get(identifier)
        if entry is not None:
            cols, vals = entry
            out[cols] = vals
        return out

    def _leaf_entries(self, bfs, is_leaf: np.ndarray):
        """Every leaf deviation of one BFS order as (row, col, val) arrays
        sorted by column, kept for the (bfs, is_leaf) pair it was last
        asked for: an FS pass materializes one order chunk after chunk, and
        a column slice of these arrays is then one searchsorted, not a
        Python loop over the leaves."""
        if self._entries is None or self._entries[0] is not bfs \
                or self._entries[1] is not is_leaf:
            rows, cols, vals = [], [], []
            for i in np.nonzero(is_leaf)[0]:
                entry = self.rows.get(bfs[i].identifier)
                if entry is not None and len(entry[0]):
                    rows.append(np.full(len(entry[0]), i, dtype=np.int64))
                    cols.append(entry[0])
                    vals.append(entry[1])
            if rows:
                rows, cols, vals = (np.concatenate(a)
                                    for a in (rows, cols, vals))
            else:
                rows, cols = np.zeros(0, np.int64), np.zeros(0, np.int64)
                vals = np.zeros(0, np.uint8)
            o = np.argsort(cols, kind="stable")
            self._entries = (bfs, is_leaf, rows[o], cols[o], vals[o])
        return self._entries[2:]

    def materialize(self, bfs, is_leaf: np.ndarray, c0: int,
                    c1: int) -> np.ndarray:
        """[n, c1-c0] uint8: leaf rows hold genotypes over columns
        [c0, c1); internal rows are zero (ignored by the FS DP)."""
        rows, cols, vals = self._leaf_entries(bfs, is_leaf)
        out = np.zeros((len(bfs), c1 - c0), dtype=np.uint8)
        out[np.nonzero(is_leaf)[0]] = self.ref_row[c0:c1]
        lo, hi = np.searchsorted(cols, (c0, c1))
        out[rows[lo:hi], cols[lo:hi] - c0] = vals[lo:hi]
        return out

    def materialize_cols(self, bfs, is_leaf: np.ndarray,
                         cols_arr: np.ndarray) -> np.ndarray:
        """[n, len(cols_arr)] uint8 for an arbitrary (sorted) column set."""
        n = len(bfs)
        cols_arr = np.asarray(cols_arr, dtype=np.int64)
        out = np.zeros((n, len(cols_arr)), dtype=np.uint8)
        if len(cols_arr) == 0:
            # empty request: searchsorted below would index an empty array
            # with -1 before the take<len guard can mask it
            return out
        ref_slice = self.ref_row[cols_arr]
        leaf_idx = np.nonzero(is_leaf)[0]
        out[leaf_idx] = ref_slice
        for i in leaf_idx:
            entry = self.rows.get(bfs[i].identifier)
            if entry is None:
                continue
            dcols, vals = entry
            # intersect the leaf's deviation columns with the request
            take = np.searchsorted(cols_arr, dcols)
            ok = (take < len(cols_arr)) & (cols_arr[np.minimum(
                take, len(cols_arr) - 1)] == dcols)
            if ok.any():
                out[i, take[ok]] = vals[ok]
        return out
