"""Pandemic-scale placement engine: PlacementEngine's interface over BigMAT
(counterpart of usher_tpu/placement/big_engine.py).

The dense FlatMAT holds a [cap, P] path-state matrix -- impossible at the
reference's target scale (>2M leaves x ~30k sites ~ 150 GB).  This engine
keeps the tree as CSR mutation lists (core/bigmat.py, O(N+M) host memory)
and scores every node against a batch with the DFS-interval engine on the
device.

Epoch discipline: tree surgery queues O(delta) incremental appends into
the CSR snapshot (core/bigmat.py queue_child_insert/queue_sibling_split),
flushed lazily at the next scoring call — the same replica-patching
discipline as the reference's MPI followers
(place_sample_follower.cpp:95-249).  A full from_tree rebuild happens only
at construction, on compaction (appends > snapshot/4), or when a sample
mutates a position outside the snapshot's column set.
"""

from __future__ import annotations

import numpy as np

import torch

from ..core.flat import collect_positions
from ..core.tree import Mutation, Tree
from ..ops.placement import placement_outputs
from ..utils.device import apply_platform_env
from ..utils.instrument import timeit
from .driver import SampleResult, ScoreSnapshot


class _FlatShim:
    """The minimal `.flat` surface the drivers touch (tree + slot lookup)."""

    def __init__(self, engine):
        self._engine = engine

    @property
    def tree(self):
        return self._engine.T

    @property
    def positions(self):
        return self._engine.positions

    @property
    def ref(self):
        return self._engine.ref

    @property
    def chrom(self):
        return self._engine.chrom


class BigPlacementEngine:
    """Drop-in engine for run_usher/place_batch on trees too large for the
    dense path.  Interface parity: score_samples(...), apply_placement(...),
    .flat.tree."""

    def __init__(self, T: Tree, vcf=None, extra_mutations=None,
                 mesh=None, device=None):
        """device: torch device of the BigMAT's resident arrays (default:
        from USHER_TPU_PLATFORM, utils/device.py; under a mesh its lead
        device).  mesh: optional parallel.mesh.Mesh, flattened to a 1-D
        batch mesh: the sample axis of a scoring batch is split over its
        devices and the CSR metadata replicated."""
        if mesh is not None and len(mesh.axis_names) > 1:
            mesh = mesh.flattened("batch")
        self.mesh = mesh
        self.T = T
        if mesh is not None:
            self.device = mesh.lead
        else:
            self.device = (torch.device(device) if device is not None
                           else apply_platform_env())
        positions, ref, chrom = collect_positions(T, vcf)
        if extra_mutations:
            pos_ref = {int(p): int(r) for p, r in zip(positions, ref)}
            for m in extra_mutations:
                if m.position >= 0 and m.position not in pos_ref:
                    pos_ref[m.position] = m.ref_nuc
                    chrom = chrom or m.chrom
            positions = np.array(sorted(pos_ref), dtype=np.int64)
            ref = np.array([pos_ref[p] for p in positions.tolist()],
                           dtype=np.uint8)
        self.positions = positions
        self.ref = ref
        self.chrom = chrom
        self.flat = _FlatShim(self)
        self._big = None
        self._slot_of: dict = {}
        self._dirty = True

    def _ensure(self):
        big = self._big
        if (big is not None and not self._dirty
                and big._appended + len(big._pending)
                > max(4096, (big.N - big._appended) // 4)):
            # compaction: the incremental overlay has grown past a quarter
            # of the snapshot; fold it into a fresh CSR build
            self._dirty = True
        if self._dirty or self._big is None:
            from ..core.bigmat import BigMAT
            with timeit("placement:bigmat_build"):
                self._big = BigMAT.from_tree(self.T, self.positions,
                                             self.ref, device=self.device)
            self._big.mesh = self.mesh
            self._slot_of = {id(n): i
                             for i, n in enumerate(self._big._nodes)}
            self._dirty = False
        return self._big

    def score_samples(self, samples_mutations, want_matrix=False,
                      exclude_slots=None, snapshot=False):
        big = self._ensure()
        for muts in samples_mutations:
            muts.sort(key=lambda m: m.position)
        pos, gval, kmiss = big.sparsify(samples_mutations)
        score_T, nc_T, nnm = big.score_batch_T(pos, gval, kmiss)
        score = score_T.T
        nc = nc_T.T
        valid, has_unique = placement_outputs(
            score, nc, nnm, big.is_root_mask, big.is_leaf, big.active)
        valid = np.asarray(valid)
        has_unique = np.asarray(has_unique)
        if exclude_slots is not None:
            valid = valid.copy()
            for b, slot in enumerate(exclude_slots):
                if slot is not None and slot >= 0:
                    valid[b, slot] = False

        num_leaves = big.num_leaves
        bfs_rank = big.bfs_rank
        nodes = big._nodes
        slot_of = self._slot_of
        snap = (ScoreSnapshot(score, valid, has_unique, nodes,
                              lambda n: slot_of.get(id(n), -1), num_leaves,
                              int(big.active.sum()))
                if snapshot else None)
        results = []
        for b in range(len(samples_mutations)):
            s_row, v_row, hu_row = score[b], valid[b], has_unique[b]
            vs = np.where(v_row, s_row, 1 << 30)
            best = int(vs.min())
            tied_slots = np.nonzero(v_row & (s_row == best))[0]
            tied_slots = tied_slots[np.argsort(bfs_rank[tied_slots],
                                               kind="stable")]
            tl = num_leaves[tied_slots]
            cand = tied_slots[tl == tl.max()]
            best_slot = int(cand[np.argmax(bfs_rank[cand])])
            res = SampleResult(
                best_score=best,
                num_best=int(len(tied_slots)),
                best_node=nodes[best_slot],
                best_has_unique=bool(hu_row[best_slot]),
                tied_nodes=[nodes[s] for s in tied_slots],
                tied_has_unique=[bool(hu_row[s]) for s in tied_slots],
                snapshot=snap, row=b,
            )
            if want_matrix:
                # slot -> BFS order (identity right after from_tree;
                # incremental appends interleave, so reorder by rank)
                order = np.argsort(bfs_rank, kind="stable")
                res.scores_bfs = s_row[order]
                res.valid_bfs = v_row[order]
            results.append(res)
        return results

    def _triplets(self, muts):
        """Mutation list -> [(col, par_nibble, mut_nibble)] in BigMAT
        column space (masked positions dropped, mirroring from_tree's
        filter).  Returns None when a position is outside the snapshot's
        column set (caller falls back to a full rebuild)."""
        out = []
        for m in muts:
            if m.position < 0:
                continue
            c = self._big.pos_index.get(m.position)
            if c is None:
                return None
            out.append((c, int(m.par_nuc), int(m.mut_nuc)))
        return out

    def apply_placement(self, sample_name: str, res: SampleResult,
                        excess: list[Mutation]) -> None:
        """Identical surgery semantics to PlacementEngine.apply_placement
        (reference usher_common.cpp:652-765).  The host tree is patched
        first, then the CSR snapshot mirrors the result via O(delta)
        incremental appends (core/bigmat.py queue_*) — no per-batch
        from_tree rebuild."""
        T = self.T
        best_node = res.best_node
        big = self._big if not self._dirty else None
        u_slot = (self._slot_of.get(id(best_node))
                  if big is not None else None)
        if best_node.is_leaf() or res.best_has_unique:
            nid = T.new_internal_node_id()
            new_internal = T.create_node(nid, best_node.parent)
            sample_node = T.create_node(sample_name, new_internal)
            T.move_node(best_node.identifier, nid)

            curr_l1 = [m.copy() for m in best_node.mutations]
            best_node.clear_mutations()
            l1, l2, common = [], [], []
            for m1 in curr_l1:
                if not any((not m1.is_masked()) and m1.position == m2.position
                           and m1.mut_nuc == m2.mut_nuc for m2 in excess):
                    l1.append(m1.copy())
            for m1 in excess:
                matched = any((not m1.is_masked())
                              and m1.position == m2.position
                              and m1.mut_nuc == m2.mut_nuc for m2 in curr_l1)
                (common if matched else l2).append(m1.copy())
            for m in common:
                new_internal.add_mutation(m)
            for m in l1:
                best_node.add_mutation(m)
            for m in l2:
                sample_node.add_mutation(m)
            tc = (self._triplets(new_internal.mutations)
                  if u_slot is not None else None)
            tl2 = (self._triplets(sample_node.mutations)
                   if u_slot is not None else None)
            if u_slot is not None and tc is not None and tl2 is not None:
                x_slot, s_slot = big.queue_sibling_split(
                    u_slot, tc, tl2,
                    x_node=new_internal, s_node=sample_node)
                self._slot_of[id(new_internal)] = x_slot
                self._slot_of[id(sample_node)] = s_slot
            else:
                self._dirty = True
        else:
            sample_node = T.create_node(sample_name, best_node.identifier)
            curr_l1 = best_node.mutations
            for m1 in excess:
                if not any((not m1.is_masked()) and m1.position == m2.position
                           and m1.mut_nuc == m2.mut_nuc for m2 in curr_l1):
                    sample_node.add_mutation(m1.copy())
            ts = (self._triplets(sample_node.mutations)
                  if u_slot is not None else None)
            if u_slot is not None and ts is not None:
                s_slot = big.queue_child_insert(u_slot, ts,
                                                node=sample_node)
                self._slot_of[id(sample_node)] = s_slot
            else:
                self._dirty = True
