"""Sample placement driver (counterpart of usher_tpu/placement/driver.py).

The end-to-end placement flow of the reference's usher_common.cpp: optional
collapse/condense of the input tree, optional sample sorting, the
per-sample placement loop (each batch scored on the device against every
node at once), tree surgery, and the output files (final-tree.nh,
placement_stats.tsv, mutation-paths.txt, parsimony-scores.tsv, clades.txt,
MAT .pb).  The host side (tree, I/O, host oracle) is this package's own copy
of the JAX package's; the device side is its FlatMAT and scoring ops, or
with --bigmat its CSR BigMAT and DFS-interval engine
(placement/big_engine.py), either of them over a device mesh when
--mesh-devices asks for one (parallel/mesh.py).

Deterministic semantics: the tie set is every VALID node at the minimum
score, and the winner maximizes (subtree leaf count, BFS index)
(usher_mapper.cpp:458-497), which equals the reference's sequential-order
outcome.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.flat import FlatMAT, collect_positions
from ..core.nuc import char_from_nuc_id
from ..core.tree import Mutation, MissingSample, Tree
from ..io.newick import write_newick
from ..io.pbio import save_mat_pb
from ..ops import placement as dev
from ..ops import placement_sparse as ps
from ..utils.device import apply_platform_env
from ..utils.instrument import count, timeit
from .mapper import score_placement


def _err(*a):
    print(*a, file=sys.stderr)


@dataclass
class UsherOptions:
    dout_filename: str = ""
    outdir: str = "."
    batch_size: int = 64
    # -1 = auto (every visible card when there are several, else no mesh),
    # 0 = single-device, N>1 = shard over N devices (parallel/mesh.py)
    mesh_devices: int = -1
    max_trees: int = 1
    max_uncertainty: int = 1_000_000
    max_parsimony: int = 1_000_000
    use_bigmat: bool = False   # CSR BigMAT engine for trees too large for
    #                            the dense FlatMAT (placement/big_engine.py)
    sort_before_placement_1: bool = False
    sort_before_placement_2: bool = False
    sort_before_placement_3: bool = False
    reverse_sort: bool = False
    collapse_tree: bool = False
    collapse_output_tree: bool = False
    print_uncondensed_tree: bool = False
    print_parsimony_scores: bool = False
    retain_original_branch_len: bool = False
    no_add: bool = False
    detailed_clades: bool = False
    print_subtrees_size: int = 0
    print_subtrees_single: int = 0


@dataclass
class ScoreSnapshot:
    """The full rows of one score_samples call, kept for a batch (as
    references): score, valid and has_unique [B, R] in the engine's row
    space, the row -> node list, the node -> row lookup (-1 for a node the
    snapshot lacks), and the subtree leaf counts [R] and node count of the
    tree that was scored."""
    score: np.ndarray
    valid: np.ndarray
    has_unique: np.ndarray
    nodes: list
    row_of: object
    num_leaves: np.ndarray
    num_nodes: int


@dataclass
class SampleResult:
    """Exact placement result for one sample against a tree snapshot."""
    best_score: int
    num_best: int
    best_node: object
    best_has_unique: bool
    tied_nodes: list = field(default_factory=list)       # BFS order
    tied_has_unique: list = field(default_factory=list)
    scores_bfs: np.ndarray | None = None                 # per BFS node (for -p)
    valid_bfs: np.ndarray | None = None
    # with score_samples(snapshot=True): the batch's rows, this sample's row
    snapshot: ScoreSnapshot | None = field(default=None, repr=False,
                                           compare=False)
    row: int = field(default=-1, repr=False, compare=False)


class PlacementEngine:
    """Holds the device-resident flat MAT and runs batched scoring.

    backend selects the scorer: "sparse" = the B1/B2 CUDA kernels
    (ops.placement_sparse; their plain twins on the CPU), "dense" = the
    plain [B, N, P] formula (ops.placement), "auto" = sparse on CUDA and
    dense on the CPU.  The two are bit-identical; the host oracle check in
    run_usher guards every applied placement either way.

    mesh: optional parallel.mesh.Mesh with ("data", "model") axes: the node
    axis is sharded over "model", sample batches over "data", and every
    shard runs the same scorer on its own device (mesh B1 on the sparse
    backend).  Results equal the single-device engine's.
    """

    def __init__(self, T: Tree, vcf=None, extra_mutations=None,
                 backend: str = "auto", device=None, mesh=None):
        """extra_mutations: iterable of Mutation whose positions must join
        the segregating-position set.  device: torch device of the flat MAT
        (default: from USHER_TPU_PLATFORM, utils/device.py; under a mesh
        its lead device)."""
        if backend not in ("auto", "sparse", "dense"):
            raise ValueError(f"unknown backend {backend!r}")
        if mesh is not None:
            self.device = mesh.lead
        else:
            self.device = (torch.device(device) if device is not None
                           else apply_platform_env())
        self.mesh = mesh
        self.backend = backend
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
        self.flat = FlatMAT(T, positions, ref, chrom, device=self.device,
                            mesh=mesh)

    def _tensor(self, x) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def score_samples(self, samples_mutations, want_matrix=False,
                      exclude_slots=None, restrict_slots=None,
                      snapshot=False):
        """Score a batch of samples against the current tree.

        exclude_slots: optional per-sample node slot to invalidate.
        restrict_slots: optional per-sample iterable of ALLOWED node slots
        (None entries mean unrestricted).
        snapshot: attach the batch's ScoreSnapshot to every result.
        Returns a list of SampleResult (one per sample)."""
        flat = self.flat
        st_dev, parent_dev = flat.sync()
        meta = flat.order_arrays()
        score, num_common, node_num_mut = self._score_matrices(
            st_dev, parent_dev, samples_mutations, meta["active"])
        valid, has_unique = dev.placement_outputs(
            score, num_common, node_num_mut, meta["is_root_mask"],
            meta["is_leaf"], meta["active"])
        if exclude_slots is not None:
            valid = np.asarray(valid).copy()
            for b, slot in enumerate(exclude_slots):
                if slot is not None and slot >= 0:
                    valid[b, slot] = False
        if restrict_slots is not None:
            valid = np.asarray(valid).copy()
            for b, allow in enumerate(restrict_slots):
                if allow is None:
                    continue
                mask = np.zeros(valid.shape[1], dtype=bool)
                mask[np.asarray(list(allow), dtype=np.int64)] = True
                valid[b] &= mask

        bfs = meta["bfs"]
        bfs_rank = meta["bfs_rank"]
        num_leaves = meta["num_leaves"]
        snap = (ScoreSnapshot(score, valid, has_unique, flat._slot_node,
                              lambda n: n.slot, num_leaves, len(bfs))
                if snapshot else None)
        results = []
        for b in range(len(samples_mutations)):
            s_row, v_row, hu_row = score[b], valid[b], has_unique[b]
            vs = np.where(v_row, s_row, 1 << 30)
            best = int(vs.min())
            tied_slots = np.nonzero(v_row & (s_row == best))[0]
            if len(tied_slots) == 0:
                # only reachable under restrict_slots: every candidate in
                # the allowed set was invalid
                results.append(SampleResult(
                    best_score=best, num_best=0, best_node=None,
                    best_has_unique=False))
                continue
            # order tie set by BFS rank ascending
            tied_slots = tied_slots[np.argsort(bfs_rank[tied_slots], kind="stable")]
            # winner: max leaves then max BFS rank
            tl = num_leaves[tied_slots]
            cand = tied_slots[tl == tl.max()]
            best_slot = int(cand[np.argmax(bfs_rank[cand])])
            res = SampleResult(
                best_score=best,
                num_best=int(len(tied_slots)),
                best_node=flat._slot_node[best_slot],
                best_has_unique=bool(hu_row[best_slot]),
                tied_nodes=[flat._slot_node[s] for s in tied_slots],
                tied_has_unique=[bool(hu_row[s]) for s in tied_slots],
                snapshot=snap, row=b,
            )
            if want_matrix:
                slots = np.array([n.slot for n in bfs])
                res.scores_bfs = s_row[slots]
                res.valid_bfs = v_row[slots]
            results.append(res)
        return results

    def best_placements(self, samples_mutations):
        """(best_score [B], num_best [B]) numpy int32 of each sample against
        the current tree: the fused scoring step (B2 on the sparse backend),
        for callers that need no tie set."""
        flat = self.flat
        st_dev, parent_dev = flat.sync()
        meta = flat.order_arrays()
        if self.mesh is not None:
            return self._best_mesh(samples_mutations, meta)
        args = (st_dev, parent_dev, flat.root_slot, flat.ref_dev) + tuple(
            self._tensor(meta[k]) for k in ("active", "is_leaf",
                                            "is_root_mask", "num_leaves",
                                            "bfs_rank"))
        if self._resolve_backend() == "sparse":
            pos, gval, kmiss = ps.sparsify(samples_mutations, flat.pos_index,
                                           flat.P_pad)
            best, _, num_best = ps.placement_step_sparse(
                *args, self._tensor(pos), self._tensor(gval),
                self._tensor(kmiss))
        else:
            g, E, miss = flat.encode_samples(samples_mutations)
            best, _, num_best = dev.placement_step(
                *args, self._tensor(g), self._tensor(E), self._tensor(miss))
        return best.cpu().numpy(), num_best.cpu().numpy()

    def _pad_sparse(self, samples_mutations):
        """Sparse slot arrays of the batch, padded to a multiple of the
        mesh's data size with rows of padding slots (pos = P_pad)."""
        flat = self.flat
        pos, gval, kmiss = ps.sparsify(samples_mutations, flat.pos_index,
                                       flat.P_pad)
        pad = -len(samples_mutations) % self.mesh.shape["data"]
        if pad:
            K = pos.shape[1]
            pos = np.concatenate(
                [pos, np.full((pad, K), flat.P_pad, np.int32)], 0)
            gval = np.concatenate([gval, np.zeros((pad, K), np.uint8)], 0)
            kmiss = np.concatenate([kmiss, np.zeros((pad, K), bool)], 0)
        return pos, gval, kmiss

    def _pad_dense(self, samples_mutations):
        """Dense encoding of the batch, padded to a multiple of the mesh's
        data size with reference rows (no entries)."""
        flat = self.flat
        g, E, miss = flat.encode_samples(samples_mutations)
        pad = -len(samples_mutations) % self.mesh.shape["data"]
        if pad:
            g = np.concatenate([g, np.tile(flat.ref, (pad, 1))], 0)
            E = np.concatenate([E, np.zeros((pad, E.shape[1]), bool)], 0)
            miss = np.concatenate(
                [miss, np.zeros((pad, miss.shape[1]), bool)], 0)
        return g, E, miss

    def _best_mesh(self, samples_mutations, meta):
        """best_placements over the mesh: per shard the B2 partials (sparse)
        or the dense step's, merged exactly over the node shards."""
        from ..parallel import mesh as pmesh
        flat = self.flat
        st, stp = flat.sync_mesh()
        B = len(samples_mutations)
        node = [pmesh.put_nodes(self.mesh, meta[k]) for k in (
            "active", "is_leaf", "is_root_mask", "num_leaves", "bfs_rank")]
        if self._resolve_backend() == "sparse":
            batch = [pmesh.put_batch(self.mesh, x)
                     for x in self._pad_sparse(samples_mutations)]
            best, _, num_best = pmesh.sharded_placement_reduce(
                self.mesh, st, stp, flat.ref_mesh, *node, *batch)
        else:
            active, is_leaf, is_root, num_leaves, bfs_rank = node
            batch = [pmesh.put_batch(self.mesh, x)
                     for x in self._pad_dense(samples_mutations)]
            best, _, num_best = pmesh.sharded_placement_step(self.mesh)(
                st, stp, flat.ref_mesh, active, num_leaves, bfs_rank,
                is_leaf, is_root, *batch)
        return best[:B].cpu().numpy(), num_best[:B].cpu().numpy()

    def _score_mesh(self, samples_mutations, active):
        """Sharded scoring over the (data, model) mesh: the sample batch is
        padded to the data-axis size and split over "data"; st/stp live
        split over "model" in the FlatMAT.  Identical math to the
        single-device path: B1 per shard on the sparse backend (mesh B1),
        the dense formula per shard otherwise."""
        from ..parallel import mesh as pmesh
        flat = self.flat
        st, stp = flat.sync_mesh()
        B = len(samples_mutations)
        if self._resolve_backend() == "sparse":
            batch = [pmesh.put_batch(self.mesh, x)
                     for x in self._pad_sparse(samples_mutations)]
            score_t, nc_t, nnm = pmesh.sharded_sparse_score_fn(self.mesh)(
                st, stp, flat.ref_mesh, *batch)
            return (pmesh.gather_blocks(score_t, node_axis=0).T[:B],
                    pmesh.gather_blocks(nc_t, node_axis=0).T[:B],
                    pmesh.gather_nodes(nnm))
        batch = [pmesh.put_batch(self.mesh, x)
                 for x in self._pad_dense(samples_mutations)]
        score, nc, nnm = pmesh.sharded_score_fn(self.mesh)(
            st, stp, flat.ref_mesh, pmesh.put_nodes(self.mesh, active),
            *batch)
        return (pmesh.gather_blocks(score, node_axis=1)[:B],
                pmesh.gather_blocks(nc, node_axis=1)[:B],
                pmesh.gather_nodes(nnm))

    def _resolve_backend(self) -> str:
        if self.backend != "auto":
            return self.backend
        return "sparse" if self.device.type == "cuda" else "dense"

    def _score_matrices(self, st_dev, parent_dev, samples_mutations, active):
        """Raw (score [B,N], num_common [B,N], node_num_mut [N]) numpy arrays
        from the selected scorer."""
        flat = self.flat
        if self.mesh is not None:
            return self._score_mesh(samples_mutations, active)
        if self._resolve_backend() == "sparse":
            pos, gval, kmiss = ps.sparsify(samples_mutations, flat.pos_index,
                                           flat.P_pad)
            score_t, nc_t, nnm = ps.score_sparse_T(
                st_dev, parent_dev, flat.root_slot, flat.ref_dev,
                self._tensor(pos), self._tensor(gval), self._tensor(kmiss))
            return (score_t.cpu().numpy().T, nc_t.cpu().numpy().T,
                    nnm.cpu().numpy())
        g, E, miss = flat.encode_samples(samples_mutations)
        return tuple(x.cpu().numpy() for x in dev.score_batch(
            st_dev, parent_dev, flat.root_slot, flat.ref_dev,
            self._tensor(active), self._tensor(g), self._tensor(E),
            self._tensor(miss)))

    # --- surgery ------------------------------------------------------------

    def apply_placement(self, sample_name: str, res: SampleResult,
                        excess: list[Mutation]) -> None:
        """Insert the sample at the winning node (reference
        usher_common.cpp:652-765)."""
        T = self.flat.tree
        best_node = res.best_node
        if best_node.is_leaf() or res.best_has_unique:
            # sibling: split the branch
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
                matched = any((not m1.is_masked()) and m1.position == m2.position
                              and m1.mut_nuc == m2.mut_nuc for m2 in curr_l1)
                (common if matched else l2).append(m1.copy())
            for m in common:
                new_internal.add_mutation(m)
            for m in l1:
                best_node.add_mutation(m)
            for m in l2:
                sample_node.add_mutation(m)

            self.flat.add_node(new_internal)
            self.flat.add_node(sample_node)
            self.flat.reparent(best_node)
        else:
            # child
            sample_node = T.create_node(sample_name, best_node.identifier)
            curr_l1 = best_node.mutations
            for m1 in excess:
                if not any((not m1.is_masked()) and m1.position == m2.position
                           and m1.mut_nuc == m2.mut_nuc for m2 in curr_l1):
                    sample_node.add_mutation(m1.copy())
            self.flat.add_node(sample_node)


class BatchDelta:
    """A batch's own changes over its scoring snapshot, so that every
    in-batch question is answered without a pass over the whole tree.

    Earlier applies in a batch change only the score of the node whose
    branch was split, the nodes the batch created, and the tie-break
    metadata.  So a sample's exact result on the current tree is the
    snapshot row with those nodes masked, against their host scores; BFS
    order is the order of (depth, child-index path from the root), read
    from a node's ancestors; a subtree's leaf count is the snapshot's plus
    what the batch's applies added, tallied along each new sample's
    ancestors."""

    def __init__(self, snap: ScoreSnapshot):
        self.snap = snap
        self.num_nodes = snap.num_nodes
        self._leaves: dict[int, int] = {}   # id(node) -> current count

    def leaf_count(self, node) -> int:
        c = self._leaves.get(id(node))
        if c is None:
            c = int(self.snap.num_leaves[self.snap.row_of(node)])
        return c

    def record_apply(self, sample_node, split_node=None) -> None:
        """Tally an applied placement: a child of its parent, or, with
        split_node, a sibling of split_node under a new internal node."""
        leaves = self._leaves
        leaves[id(sample_node)] = 1
        n = sample_node.parent
        if split_node is not None:
            leaves[id(n)] = self.leaf_count(split_node) + 1
            n = n.parent
            self.num_nodes += 2
        else:
            self.num_nodes += 1
        while n is not None:
            leaves[id(n)] = self.leaf_count(n) + 1
            n = n.parent

    def correct(self, res: SampleResult, check_nodes: list,
                checks: list) -> SampleResult:
        """res's exact result on the current tree: its snapshot row with
        check_nodes masked, against their host scores `checks`."""
        snap, b = self.snap, res.row
        s_row = snap.score[b]
        vs = np.where(snap.valid[b], s_row, 1 << 30)
        rows = [r for r in map(snap.row_of, check_nodes)
                if 0 <= r < len(vs)]
        vs[rows] = 1 << 30
        best = int(vs.min())
        for d in checks:
            if d.is_valid and d.set_difference < best:
                best = d.set_difference
        tied_rows = np.nonzero(vs == best)[0]
        nodes = [snap.nodes[r] for r in tied_rows.tolist()]
        hus = snap.has_unique[b][tied_rows].tolist()
        for node, d in zip(check_nodes, checks):
            if d.is_valid and d.set_difference == best:
                nodes.append(node)
                hus.append(bool(d.has_unique))
        out = SampleResult(best_score=best, num_best=len(nodes),
                           best_node=None, best_has_unique=False,
                           tied_nodes=nodes, tied_has_unique=hus)
        self.refresh_winner(out)
        return out

    def refresh_winner(self, res: SampleResult) -> None:
        """Order res's tie set by the current tree's BFS and re-resolve the
        winner: max leaves, then max BFS rank (usher_mapper.cpp:476-497)."""
        paths: dict[int, tuple] = {}
        index: dict[int, dict] = {}

        def key(node):
            chain = []
            while node.parent is not None and id(node) not in paths:
                chain.append(node)
                node = node.parent
            path = paths.get(id(node), ())
            for c in reversed(chain):
                p = c.parent
                idx = index.get(id(p))
                if idx is None:
                    idx = index[id(p)] = {id(x): i for i, x
                                          in enumerate(p.children)}
                path = paths[id(c)] = path + (idx[id(c)],)
            return len(path), path

        order = sorted(range(len(res.tied_nodes)),
                       key=lambda i: key(res.tied_nodes[i]))
        res.tied_nodes = [res.tied_nodes[i] for i in order]
        res.tied_has_unique = [res.tied_has_unique[i] for i in order]
        leaves = [self.leaf_count(n) for n in res.tied_nodes]
        top = max(leaves)
        best_i = max(i for i, c in enumerate(leaves) if c == top)
        res.best_node = res.tied_nodes[best_i]
        res.best_has_unique = res.tied_has_unique[best_i]


def _mesh_from_options(opts: UsherOptions, device):
    """The (data, model) mesh that opts.mesh_devices asks for, or None: -1
    takes every card of every process when there is more than one, N > 1
    makes N shards (more shards than cards share the cards; N global
    shards over the ranks of a live process group)."""
    from ..parallel.mesh import make_mesh, visible_shards
    device = (torch.device(device) if device is not None
              else apply_platform_env())
    want = opts.mesh_devices
    if want == -1:
        nd = visible_shards(device)
        want = nd if nd > 1 else 0
    if want <= 1:
        return None
    mesh = make_mesh(want, device=device)
    _err(f"Sharding placement over a {mesh.shape} device mesh.")
    return mesh


def run_usher(T: Tree, missing_samples: list[MissingSample], opts: UsherOptions,
              vcf=None, device=None) -> int:
    """Place ``missing_samples`` on ``T`` and write the outputs (reference
    usher_common.cpp); device as in PlacementEngine."""
    low_confidence_samples: list[str] = []

    if opts.print_subtrees_size == 1:
        _err("ERROR: print-subtrees-size should be larger than 1")
        return 1
    if (opts.sort_before_placement_1 + opts.sort_before_placement_2
            + opts.sort_before_placement_3) > 1:
        _err("ERROR: Can't use two or more of sort-before-placement-1, "
             "sort-before-placement-2 and sort-before-placement-3 simultaneously.")
        return 1
    if opts.reverse_sort and not (opts.sort_before_placement_1
                                  or opts.sort_before_placement_2
                                  or opts.sort_before_placement_3):
        _err("ERROR: Can't use reverse-sort without sorting options")
        return 1
    if opts.print_parsimony_scores and opts.max_trees > 1:
        _err("ERROR: cannot use --multiple-placements (-M) and "
             "--print_parsimony_scores (-p) options simulaneously.")
        return 1
    if opts.max_trees == 0:
        _err("ERROR: Number of trees specified by --multiple-placements (-M) "
             "should be >= 1")
        return 1
    if opts.max_trees > 1:
        return run_usher_multi(T, missing_samples, opts, vcf, device)
    if opts.no_add and (opts.print_subtrees_size > 0 or opts.print_subtrees_single):
        _err("ERROR: Sorry, cannot output subtrees when -n/--no-add is specified.")
        return 1

    os.makedirs(opts.outdir, exist_ok=True)
    outdir = os.path.realpath(opts.outdir)

    if opts.collapse_tree:
        _err("Collapsing input tree.")
        T.collapse_tree()
        _err("Condensing identical sequences.")
        T.condense_leaves()
        path = os.path.join(outdir, "condensed-tree.nh")
        with open(path, "w") as f:
            f.write(write_newick(T, print_internal=True, print_branch_len=True,
                                 retain_original_branch_len=opts.retain_original_branch_len)
                    + "\n")

    _err(f"Found {len(missing_samples)} missing samples.\n")

    if opts.sort_before_placement_3:
        missing_samples.sort(key=lambda s: s.num_ambiguous)
        if opts.reverse_sort:
            missing_samples.reverse()

    mesh = _mesh_from_options(opts, device)
    if opts.use_bigmat:
        from .big_engine import BigPlacementEngine
        _err("Using the CSR BigMAT engine (pandemic-scale path).")
        engine = BigPlacementEngine(T, vcf, device=device, mesh=mesh)
    else:
        with timeit("placement:flat_build"):
            engine = PlacementEngine(T, vcf, device=device, mesh=mesh)
    flat = engine.flat

    if missing_samples:
        indexes = list(range(len(missing_samples)))

        if opts.print_parsimony_scores:
            path = os.path.join(outdir, "current-tree.nh")
            with open(path, "w") as f:
                f.write(write_newick(T, print_internal=True, print_branch_len=True)
                        + "\n")
        elif ((opts.sort_before_placement_1 or opts.sort_before_placement_2)
              and len(missing_samples) > 1):
            _err("Computing parsimony scores and number of parsimony-optimal "
                 "placements for new samples and using them to sort the samples.")
            for s in missing_samples:
                s.mutations.sort(key=lambda m: m.position)
            with timeit("placement:sort_scores"):
                if opts.use_bigmat:
                    # BigPlacementEngine has no fused step: reduce the
                    # SampleResults, as the JAX driver does for every engine
                    pres = engine.score_samples(
                        [s.mutations for s in missing_samples])
                    best_scores = [r.best_score for r in pres]
                    num_placements = [r.num_best for r in pres]
                else:
                    best_scores, num_placements = engine.best_placements(
                        [s.mutations for s in missing_samples])
            if opts.sort_before_placement_1:
                indexes.sort(key=lambda i: (best_scores[i], num_placements[i]))
            else:
                indexes.sort(key=lambda i: (num_placements[i], best_scores[i]))
            if opts.reverse_sort:
                indexes.reverse()

        if not opts.print_parsimony_scores:
            _err("Adding missing samples to the tree.")

        stats_path = os.path.join(outdir, "placement_stats.tsv")
        stats_f = open(stats_path, "w")
        pars_f = None

        # Batched scoring with exact sequential semantics: a whole batch is
        # scored against a frozen tree snapshot in one device call; before
        # applying each proposal, cheap host checks prove it equals what a
        # sequential re-score would produce, or correct it exactly from the
        # snapshot and the batch's own changes (BatchDelta).  Earlier
        # applies in a batch only change (a) scores of the touched node
        # whose branch was split, (b) the two new nodes, (c) tie-break
        # metadata (leaf counts / BFS ranks) -- each is checked below.
        bsz = max(1, opts.batch_size)
        flat_batches = [indexes[i:i + bsz] for i in range(0, len(indexes), bsz)]
        for j, batch_idx in enumerate(flat_batches):
            batch = [missing_samples[i] for i in batch_idx]
            with timeit("placement:score_batch", batch=j):
                pres = engine.score_samples(
                    [s.mutations for s in batch],
                    want_matrix=opts.print_parsimony_scores, snapshot=True)
            delta = BatchDelta(pres[0].snapshot)
            # nodes whose score could differ from the snapshot due to earlier
            # applies in this batch (split node + the nodes it created)
            check_nodes: list = []
            check_ids: set[str] = set()

            with timeit("placement:apply_batch", batch=j,
                        samples=len(batch)):
                for s, res in zip(batch, pres):
                    sample = s.name
                    if T.get_node(sample) is not None:
                        _err(f"WARNING: Sample {sample} already in the tree! "
                             f"Ignoring.\n")
                        continue

                    if opts.print_parsimony_scores and pars_f is None:
                        pars_path = os.path.join(outdir, "parsimony-scores.tsv")
                        _err(f"\nNow computing branch parsimony scores for adding the "
                             f"missing samples at each of the nodes in the existing tree "
                             f"without modifying the tree.\nThe branch parsimony scores "
                             f"will be written to file {pars_path}\n")
                        pars_f = open(pars_path, "w")
                        pars_f.write("#Sample\tTree node\tParsimony score\tOptimal (y/n)\t"
                                     "Parsimony-increasing mutations (for optimal nodes)\n")

                    if check_nodes:
                        # the tree changed since the snapshot (an apply
                        # adds at least the new sample to check_nodes)
                        stale = any(t.identifier in check_ids
                                    for t in res.tied_nodes)
                        checks = []
                        if not stale:
                            for node in check_nodes:
                                d = score_placement(node, s.mutations,
                                                    compute_vecs=False)
                                checks.append(d)
                                if d.is_valid and d.set_difference <= res.best_score:
                                    stale = True
                                    break
                        if stale:
                            count("rescores")
                            with timeit("placement:rescore"):
                                checks += [score_placement(
                                    node, s.mutations, compute_vecs=False)
                                    for node in check_nodes[len(checks):]]
                                res = delta.correct(res, check_nodes, checks)
                        elif res.num_best > 1:
                            with timeit("placement:refresh_winner"):
                                delta.refresh_winner(res)

                    best_set_difference = res.best_score
                    num_best = res.num_best
                    best_node = res.best_node
                    with timeit("placement:tree_size"):
                        total_nodes = delta.num_nodes

                    # Cross-check device score against the exact host scorer for the
                    # winner; also produces the excess/imputed vectors for surgery.
                    detail = score_placement(best_node, s.mutations)
                    if detail.set_difference != best_set_difference:
                        raise AssertionError(
                            f"device/host score mismatch for {sample} at "
                            f"{best_node.identifier}: {best_set_difference} vs "
                            f"{detail.set_difference}")

                    if opts.print_parsimony_scores:
                        _err(f"Missing sample: {sample}\t Best parsimony score: "
                             f"{best_set_difference}\tNumber of parsimony-optimal "
                             f"placements: {num_best}")
                        bfs_nodes = flat.tree.breadth_first_expansion()
                        for k, node in enumerate(bfs_nodes):
                            sc = int(res.scores_bfs[k])
                            reported = sc if res.valid_bfs[k] else sc + 1
                            is_opt = "y" if reported == best_set_difference else "n"
                            pars_f.write(f"{sample}\t{node.identifier}\t{reported}\t\t{is_opt}\t")
                            if reported == best_set_difference:
                                det_k = score_placement(node, s.mutations)
                                if reported == 0:
                                    pars_f.write("*")
                                n_print = min(reported, len(det_k.excess))
                                pars_f.write(",".join(
                                    det_k.excess[i].get_string() for i in range(n_print)))
                            else:
                                pars_f.write("N/A")
                            pars_f.write("\n")
                        # the reference writes the (empty) per-sample stats terminator
                        # even in -p mode (usher_common.cpp:788)
                        stats_f.write("\n")
                        continue

                    _err(f"Current tree size (#nodes): {total_nodes}\tSample name: "
                         f"{sample}\tParsimony score: {best_set_difference}\tNumber of "
                         f"parsimony-optimal placements: {num_best}")
                    stats_f.write(f"{sample}\t{best_set_difference}\t{num_best}\t")

                    if num_best > 1:
                        if opts.max_trees == 1:
                            low_confidence_samples.append(sample)
                        if num_best > opts.max_uncertainty:
                            _err(f"WARNING: Number of parsimony-optimal placements exceeds "
                                 f"maximum allowed value ({opts.max_uncertainty}). Ignoring "
                                 f"sample {sample}.")
                        elif best_set_difference <= opts.max_parsimony:
                            _err("WARNING: Multiple parsimony-optimal placements found. "
                                 "Placement done without high confidence.")
                    if best_set_difference > opts.max_parsimony:
                        _err(f"WARNING: Parsimony score of the most parsimonious placement "
                             f"exceeds the maximum allowed value ({opts.max_parsimony}). "
                             f"Ignoring sample {sample}.")

                    if (num_best <= opts.max_uncertainty
                            and best_set_difference <= opts.max_parsimony):
                        # clade assignment over the tie set (usher_common.cpp:600-619)
                        num_annotations = T.get_num_annotations()
                        s.clade_assignments = []
                        s.best_clade_assignment = [""] * num_annotations
                        for c in range(num_annotations):
                            assignments = []
                            for node, hu in zip(res.tied_nodes, res.tied_has_unique):
                                include_self = (not node.is_leaf()) and (not hu)
                                clade = T.get_clade_assignment(node, c, include_self)
                                assignments.append(clade)
                                if node is best_node:
                                    s.best_clade_assignment[c] = clade
                            assignments.sort()
                            s.clade_assignments.append(assignments)

                        if not opts.no_add and T.get_node(sample) is None:
                            parent_before = best_node.parent
                            with timeit("placement:surgery"):
                                engine.apply_placement(sample, res,
                                                       detail.excess)
                            added = [T.get_node(sample)]
                            split = best_node.parent is not parent_before
                            delta.record_apply(
                                added[0], best_node if split else None)
                            if split:
                                # sibling split: the new internal node is a fresh
                                # candidate AND best_node's own score changed
                                # (its branch mutations were redistributed)
                                added.append(best_node.parent)
                                added.append(best_node)
                            for n in added:
                                if n is not None and n.identifier not in check_ids:
                                    check_ids.add(n.identifier)
                                    check_nodes.append(n)

                        if detail.imputed:
                            _err("Imputed mutations:\t" + ";".join(
                                f"{m.position}:{_nuc_char(m.mut_nuc)}" for m in detail.imputed))
                            stats_f.write(";".join(
                                f"{m.position}:{_nuc_char(m.mut_nuc)}" for m in detail.imputed))
                    stats_f.write("\n")

        stats_f.close()
        if pars_f is not None:
            pars_f.close()
        if opts.print_parsimony_scores:
            return 0

    with timeit("placement:write_outputs"):
        _write_outputs(T, missing_samples, opts, outdir,
                       low_confidence_samples)
    return 0


def _write_outputs(T: Tree, missing_samples: list[MissingSample],
                   opts: UsherOptions, outdir: str,
                   low_confidence_samples: list[str]) -> None:
    """The output files of a single-tree run (usher_common.cpp:796-1044)."""
    if opts.collapse_output_tree:
        _err("Collapsing output tree.")
        T.collapse_tree()

    if opts.print_uncondensed_tree:
        path = os.path.join(outdir, "uncondensed-final-tree.nh")
        _err(f"Writing uncondensed final tree to file {path}")
        _err(f"The parsimony score for this tree is: {T.get_parsimony_score()}")
        with open(path, "w") as f:
            f.write(write_newick(T, print_internal=True, print_branch_len=True,
                                 uncondense_leaves=True))
    else:
        path = os.path.join(outdir, "final-tree.nh")
        _err(f"Writing final tree to file {path}")
        _err(f"The parsimony score for this tree is: {T.get_parsimony_score()}")
        with open(path, "w") as f:
            f.write(write_newick(T, print_internal=True, print_branch_len=True))

    if missing_samples:
        path = os.path.join(outdir, "mutation-paths.txt")
        _err(f"Writing mutation paths to file {path}")
        write_mutation_paths(T, [s.name for s in missing_samples], path)

        num_annotations = T.get_num_annotations()
        if num_annotations > 0:
            path = os.path.join(outdir, "clades.txt")
            _err(f"Writing clade annotations to file {path}")
            with open(path, "w") as f:
                for s in missing_samples:
                    if not s.best_clade_assignment:
                        continue
                    f.write(f"{s.name}\t")
                    cols = []
                    for k in range(num_annotations):
                        col = s.best_clade_assignment[k]
                        if opts.max_trees == 1 and opts.detailed_clades:
                            col += "*|"
                            hist = []
                            curr_clade, curr_count = "", 0
                            total = len(s.clade_assignments[k])
                            for clade in s.clade_assignments[k]:
                                if clade == curr_clade:
                                    curr_count += 1
                                else:
                                    if curr_count > 0:
                                        hist.append(f"{curr_clade}({curr_count}/{total})")
                                    curr_clade, curr_count = clade, 1
                            if curr_count > 0:
                                hist.append(f"{curr_clade}({curr_count}/{total})")
                            col += ",".join(hist)
                        cols.append(col)
                    f.write("\t".join(cols) + "\n")

    if opts.print_subtrees_single > 1 and missing_samples:
        from ..tools.subtrees import write_single_subtree
        _err(f"Computing the single subtree for added samples with "
             f"{opts.print_subtrees_single} random leaves.\n")
        T.uncondense_leaves()
        write_single_subtree(
            T, [s.name for s in missing_samples], outdir,
            opts.print_subtrees_single,
            retain_original_branch_len=opts.retain_original_branch_len)

    if opts.print_subtrees_size > 1 and missing_samples:
        from ..tools.subtrees import write_sample_subtrees
        _err("Computing subtrees for added samples.\n")
        T.uncondense_leaves()
        write_sample_subtrees(
            T, [s.name for s in missing_samples], outdir,
            opts.print_subtrees_size,
            retain_original_branch_len=opts.retain_original_branch_len)

    if low_confidence_samples:
        _err("WARNING: Following samples had multiple possibilities of "
             "parsimony-optimal placements:")
        for name in low_confidence_samples:
            _err(name)

    if opts.dout_filename:
        _err(f"Saving mutation-annotated tree object to file (after condensing "
             f"identical sequences) {opts.dout_filename}")
        if T.condensed_nodes:
            T.uncondense_leaves()
        T.condense_leaves()
        save_mat_pb(T, opts.dout_filename)


def run_usher_multi(T: Tree, missing_samples: list[MissingSample],
                    opts: UsherOptions, vcf=None, device=None) -> int:
    """--multiple-placements (-M > 1): each sample is placed into EVERY tree
    accumulated so far; when a tree offers multiple parsimony-optimal
    placements and capacity remains, the tree is forked — one copy per
    co-optimal node in BFS order (usher_common.cpp:310-780; fork accounting
    :556-585; per-tree outputs :830-1011).

    Deviation from the reference: the fork's sibling-vs-child choice uses
    the tied node's own has_unique value (the reference indexes
    node_has_unique[k] with the fork counter, usher_common.cpp:653 — an
    out-of-range-looking index we do not reproduce)."""
    os.makedirs(opts.outdir, exist_ok=True)
    outdir = os.path.realpath(opts.outdir)

    if opts.collapse_tree:
        _err("Collapsing input tree.")
        T.collapse_tree()
        _err("Condensing identical sequences.")
        T.condense_leaves()
        path = os.path.join(outdir, "condensed-tree.nh")
        with open(path, "w") as f:
            f.write(write_newick(T, print_internal=True, print_branch_len=True,
                                 retain_original_branch_len=opts.retain_original_branch_len)
                    + "\n")

    _err(f"Found {len(missing_samples)} missing samples.\n")
    if opts.sort_before_placement_3:
        missing_samples.sort(key=lambda s: s.num_ambiguous)
        if opts.reverse_sort:
            missing_samples.reverse()

    optimal_trees: list[Tree] = [T]
    engines: dict[int, PlacementEngine] = {0: PlacementEngine(T, vcf, device=device)}
    indexes = list(range(len(missing_samples)))

    if ((opts.sort_before_placement_1 or opts.sort_before_placement_2)
            and len(missing_samples) > 1):
        _err("Computing parsimony scores and number of parsimony-optimal "
             "placements for new samples and using them to sort the samples.")
        for s in missing_samples:
            s.mutations.sort(key=lambda m: m.position)
        best_scores, num_placements = engines[0].best_placements(
            [s.mutations for s in missing_samples])
        if opts.sort_before_placement_1:
            indexes.sort(key=lambda i: (best_scores[i], num_placements[i]))
        else:
            indexes.sort(key=lambda i: (num_placements[i], best_scores[i]))
        if opts.reverse_sort:
            indexes.reverse()

    _err("Adding missing samples to the tree.")
    stats_path = os.path.join(outdir, "placement_stats.tsv")
    with open(stats_path, "w") as stats_f:
        for idx in indexes:
            s = missing_samples[idx]
            sample = s.name
            num_trees = len(optimal_trees)
            for t_idx in range(num_trees):
                Tt = optimal_trees[t_idx]
                if t_idx not in engines:
                    engines[t_idx] = PlacementEngine(Tt, vcf, device=device)
                eng = engines[t_idx]
                if num_trees > 1:
                    _err(f"==Tree {t_idx + 1}=== ")
                if Tt.get_node(sample) is not None:
                    _err(f"WARNING: Sample {sample} already in the tree! "
                         f"Ignoring.\n")
                    continue
                res = eng.score_samples([s.mutations])[0]
                total_nodes = Tt.num_nodes()
                _err(f"Current tree size (#nodes): {total_nodes}\tSample "
                     f"name: {sample}\tParsimony score: {res.best_score}\t"
                     f"Number of parsimony-optimal placements: "
                     f"{res.num_best}")
                stats_f.write(f"{sample}\t{res.best_score}\t{res.num_best}\t")
                if res.num_best > 1:
                    if res.num_best > opts.max_uncertainty:
                        _err(f"WARNING: Number of parsimony-optimal "
                             f"placements exceeds maximum allowed value "
                             f"({opts.max_uncertainty}). Ignoring sample "
                             f"{sample}.")
                    elif res.best_score <= opts.max_parsimony:
                        _err("WARNING: Multiple parsimony-optimal placements "
                             "found. Placement done without high confidence.")
                if res.best_score > opts.max_parsimony:
                    _err(f"WARNING: Parsimony score of the most parsimonious "
                         f"placement exceeds the maximum allowed value "
                         f"({opts.max_parsimony}). Ignoring sample {sample}.")

                if (res.num_best <= opts.max_uncertainty
                        and res.best_score <= opts.max_parsimony):
                    nb = res.num_best
                    if nb + len(optimal_trees) > opts.max_trees:
                        if (nb + len(optimal_trees) > opts.max_trees + 1
                                and opts.max_trees > 1):
                            _err(f"{nb} parsimony-optimal placements found "
                                 f"but total trees has already exceed the "
                                 f"max possible value ({opts.max_trees})!")
                        nb = max(1, 1 + opts.max_trees - len(optimal_trees))
                    curr_copy = Tt.copy() if nb > 1 else None
                    for k in range(nb):
                        if nb > 1 and k == 0:
                            _err(f"Creating {nb - 1} additional tree(s) for "
                                 f"{nb} parsimony-optimal placements.")
                        if k == 0:
                            target_T, target_eng = Tt, eng
                            node = res.tied_nodes[0]
                            hu = res.tied_has_unique[0]
                        else:
                            newT = curr_copy.copy()
                            optimal_trees.append(newT)
                            target_eng = PlacementEngine(newT, vcf,
                                                         device=device)
                            engines[len(optimal_trees) - 1] = target_eng
                            target_T = newT
                            node = target_T.get_node(
                                res.tied_nodes[k].identifier)
                            hu = res.tied_has_unique[k]
                        if not opts.no_add and target_T.get_node(sample) is None:
                            detail = score_placement(node, s.mutations)
                            res_k = SampleResult(
                                best_score=res.best_score,
                                num_best=res.num_best, best_node=node,
                                best_has_unique=hu)
                            target_eng.apply_placement(sample, res_k,
                                                       detail.excess)
                            if detail.imputed:
                                imp = ";".join(
                                    f"{m.position}:{_nuc_char(m.mut_nuc)}"
                                    for m in detail.imputed)
                                _err("Imputed mutations:\t" + imp)
                                stats_f.write(imp)
                stats_f.write("\n")

    # --- per-tree outputs (usher_common.cpp:830-1011) -----------------------
    num_trees = len(optimal_trees)
    for t_idx, Tt in enumerate(optimal_trees):
        if opts.collapse_output_tree:
            _err("Collapsing output tree.")
            Tt.collapse_tree()
        suffix = f"-{t_idx + 1}" if num_trees > 1 else ""
        if opts.print_uncondensed_tree:
            path = os.path.join(outdir,
                                f"uncondensed-final-tree{suffix}.nh")
            _err(f"Writing uncondensed final tree to file {path}")
            with open(path, "w") as f:
                f.write(write_newick(Tt, print_internal=True,
                                     print_branch_len=True,
                                     uncondense_leaves=True))
        else:
            path = os.path.join(outdir, f"final-tree{suffix}.nh")
            _err(f"Writing final tree to file {path}")
            _err(f"The parsimony score for this tree is: "
                 f"{Tt.get_parsimony_score()}")
            with open(path, "w") as f:
                f.write(write_newick(Tt, print_internal=True,
                                     print_branch_len=True))
        if missing_samples:
            path = os.path.join(outdir, f"mutation-paths{suffix}.txt")
            _err(f"Writing mutation paths to file {path}")
            write_mutation_paths(Tt, [s.name for s in missing_samples], path)

    if opts.print_subtrees_single > 1 and missing_samples:
        from ..tools.subtrees import write_single_subtree
        for t_idx, Tt in enumerate(optimal_trees):
            Tt.uncondense_leaves()
            write_single_subtree(
                Tt, [s.name for s in missing_samples], outdir,
                opts.print_subtrees_single, tree_idx=t_idx,
                use_tree_idx=(num_trees > 1),
                retain_original_branch_len=opts.retain_original_branch_len)
    if opts.print_subtrees_size > 1 and missing_samples:
        from ..tools.subtrees import write_sample_subtrees
        for t_idx, Tt in enumerate(optimal_trees):
            Tt.uncondense_leaves()
            write_sample_subtrees(
                Tt, [s.name for s in missing_samples], outdir,
                opts.print_subtrees_size, tree_idx=t_idx,
                use_tree_idx=(num_trees > 1),
                retain_original_branch_len=opts.retain_original_branch_len)

    if opts.dout_filename:
        _err(f"Saving mutation-annotated tree object to file (after "
             f"condensing identical sequences) {opts.dout_filename}")
        if num_trees > 1:
            _err("WARNING: --multiple-placements option was used but only "
                 "the first mutation-annotated tree object will be saved to "
                 "file.")
        T0 = optimal_trees[0]
        if T0.condensed_nodes:
            T0.uncondense_leaves()
        T0.condense_leaves()
        save_mat_pb(T0, opts.dout_filename)
    return 0


def _nuc_char(nuc_id: int) -> str:
    return char_from_nuc_id(nuc_id)


def write_mutation_paths(T: Tree, samples: list[str], filename: str) -> None:
    """Root->sample branch mutation paths (reference
    mutation_annotated_tree.cpp:1991-2050)."""
    with open(filename, "w") as f:
        for sample in samples:
            node = T.get_node(sample)
            if node is None:
                continue
            chain = []
            cur = node
            while cur is not None:
                if cur.mutations:
                    chain.append(cur.identifier + ":"
                                 + ",".join(m.get_string() for m in cur.mutations)
                                 + " ")
                cur = cur.parent
            f.write(sample + "\t" + "".join(reversed(chain)) + "\n")
