#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (usher_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from usher_tpu_torch/csrc, then runs
these phases and fails (non-zero exit) if any of them fails:

  kernel_small     B1, B1-spr, B1-3d and B2 against their plain PyTorch
                   twins on the card, on random MATs with ambiguous and
                   missing entries, padding slots, inactive slots and
                   forced ties, and again on multi-base path states, where
                   B1-spr's scores must differ from B1's; B1-3d's tiles,
                   re-laid, must also equal B1's matrices; the fused calls
                   (row sums taken in the kernel) against row_reductions
                   plus the plain twins; more blocks than row groups,
                   batches of 1, 3 and 64 samples, 8 and 2,048 slots, a
                   column count that is no multiple of 16, a fused B1 call
                   without samples and B2 without rows
  kernel_headline  the same on a synthetic 100,000-node x 512-site MAT,
                   1,024 samples of 16 entries, with the median ms of 5 runs
  kernel_genome    the same at genome width: 100,000 nodes x 30,000 sites,
                   1,024 samples of 32 entries
  mesh_kernel      at that genome shape, a 2 x 2 (data, model) mesh over
                   the visible cards (shards share a card when there are
                   fewer): mesh B1 against its plain twin and the
                   unsharded B1, the sharded B2 step against the unsharded
                   B2, with the ms of each beside the unsharded call
  fixture_e2e      the usher CLI's build and place steps on the vendored
                   fixtures, byte-matching tests/goldens/smoke_*
  realistic_e2e    the CLI places 1,024 samples (VCF, ~34 entries each,
                   some N) onto a synthetic 100,000-node x 30,000-site MAT
                   saved as a pb, with -s so that the sort pre-pass runs
                   the fused B2 step over the whole set
  mesh_fixture     the fixture's placement step with --mesh-devices 4, dense
                   and with --bigmat, byte-matching tests/goldens/smoke_*
  mesh_realistic   256 samples placed onto the realistic MAT with
                   --mesh-devices 4 -s; the output files must be
                   byte-identical to an unsharded run on the same samples;
                   then, on that run's own sharded FlatMAT and slot arrays
                   (the first batch of 64 and the pre-pass set of 256),
                   mesh B1 against its plain twin and the unsharded B1 and
                   the sharded B2 step against the unsharded B2
  bigmat_fixture   the fixture's two CLI steps with --bigmat (the CSR
                   BigMAT engine), byte-matching tests/goldens/smoke_*
  bigmat_realistic the realistic run again with --bigmat; its output files
                   must be byte-identical to realistic_e2e's
  bigmat_pandemic  a chain-consistent synthetic 1,000,000-node x
                   30,000-site BigMAT (bench.py's pandemic_1m_x_30k shape),
                   1,024 samples of 24 entries (32 slots): place_arrays
                   (X5) on all of them against the interval scores (X8)
                   reduced on the host and the host engine; the column
                   path (B1-spr, both modes) against the interval engine;
                   B1-spr against its plain twin at that shape, on the
                   tree's path states and on multi-base ones; score_batch_T
                   and place_arrays under a batch mesh of 4 against the
                   unsharded calls on 256 samples

Kernel against plain comparisons are exact (tolerance 0: the arithmetic is
integer).  Every comparison covers the kernel with caller-given row sums and
the fused form, whose score_T, nc_T, base, nc_base and node_num_mut (for B2
the three [B] results) are held against row_reductions plus the plain twins.
The launch counters, and the call counter of row_reductions, are zeroed
right before each main path and read right after it; the dense and the mesh
path must launch B1 21 and 36 times and B2 1 and 4 times and never call
row_reductions: the dense path (fixture_e2e and the realistic CLI
run, kernels B1 and B2), the mesh path (mesh_fixture and mesh_realistic,
B1 and B2 per shard: mesh B1's launches are the B1 kernel's there) and
the BigMAT path (bigmat_fixture,
bigmat_realistic and bigmat_pandemic's scoring calls, kernel B1-spr in the
column path).  B1-3d has no caller on any path (its TPU counterpart has
none either), so its main-path count is 0 and only the comparisons launch
it.  A kernel's bound is the larger of the bytes it must move (inputs read
once, outputs written once) over the card's published memory rate and its
integer operations over the card's int32 rate, both computed here from
the shapes and slot counts of the run; a fused call's bound adds the row
sums' operations and their three [N] outputs.  One line gives the ms of
parent_states (the stp = st[parent] gather that score_sparse_T makes every
call) at the main-path shape.  Earlier lines report the card, the
build, each phase and the kernels (one JSON object); the last line is
{"ok": true, "device": {...}}.  Work files go to build/chip_smoke/.
The script imports no jax and nothing of the JAX package usher_tpu.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
NIBBLES = np.array([1, 2, 4, 8], dtype=np.uint8)
CHROM = "NC_045512v2"
GOLDENS = os.path.join(REPO, "tests", "goldens")
PLACE_FILES = ("placement_stats.tsv", "final-tree.nh", "mutation-paths.txt")
GOLDEN_FILES = ("smoke_placement_stats.tsv", "smoke_final_tree.nh",
                "smoke_mutation_paths.txt")


# Published peaks of an H100 SXM at its full 700 W limit.  The data sheet
# gives 3.35 TB/s of HBM3 and 67 TFLOP/s of fp32 outside the tensor cores,
# which counts a fused multiply-add as two on 128 lanes an SM; an SM has 64
# int32 lanes and an integer operation counts once, hence a quarter of it.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
# integer operations of the scoring kernels per (node, sample, valid slot)
# triple, counted in the compiled loop (the source note of
# csrc/placement_sparse.cu): 162 for the 16 triples of a quad of four slots
# against four rows; with one row a stage (the wide shapes) the kernel
# executes 61 a quad, so the bound below is a lower limit there too.  For B2
# also per (node, sample) pair of the validity test and tie-break fold
OPS_PER_TRIPLE = 162 / 16
OPS_PER_PAIR_B2 = 12
# and of the per-node row sums, counted from the function and not from the
# kernel's instructions: a 16-cell word (four 32-bit words each of st, stp and
# ref) is compared with 8 xor, 7 or and a test; where it differs, each 32-bit
# word takes 21 more for the three byte-parallel masks (4 xor/and, 4 x 2 for
# the non-zero bytes, 9 to combine them), and the 16-cell word 3 popc and 3
# adds: 16 + 4 * 21 + 6.  Addressing, loads, the vote and the in-place pack of
# the kernel are its design's and are not charged
OPS_PER_EQUAL_WORD = 16
OPS_PER_DIFFER_WORD = 16 + 4 * 21 + 6
OPS_PER_CELL_REDUCTION = OPS_PER_DIFFER_WORD / 16
# what the compiled sweep executes for the same two kinds of word (the source
# note's count), reported beside the bound as sweep_executed_ms
EXECUTED_PER_EQUAL_WORD = 58
EXECUTED_PER_DIFFER_WORD = 116


def bound(n_bytes, n_ops):
    """The least time the card could take: {"bound_ms", "bound_by",
    "bytes_ms", "ops_ms"}."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_ms": bytes_ms, "ops_ms": ops_ms}


def sweep_ops(st, stp, ref, executed=False):
    """Operations of the row sums on these states: 16-cell words are
    counted on the card, those in which some cell of st, stp and ref differs
    apart from those in which all agree.  With `executed`, what the compiled
    sweep spends on them instead of what the function needs."""
    N, P = st.shape
    words = -(-P // 16)
    cols = P // 16 * 16
    differ = N * (words - P // 16)          # a ragged last word always does
    step = max(1, (1 << 28) // max(1, P))
    for n0 in range(0, N, step):
        s = st[n0:n0 + step, :cols]
        d = (s != stp[n0:n0 + step, :cols]) | (s != ref[None, :cols])
        differ += int(d.view(d.shape[0], -1, 16).any(-1).sum())
    per = ((EXECUTED_PER_DIFFER_WORD, EXECUTED_PER_EQUAL_WORD) if executed
           else (OPS_PER_DIFFER_WORD, OPS_PER_EQUAL_WORD))
    return differ * per[0] + (N * words - differ) * per[1]


def score_bounds(N, P, pos, sweep=None):
    """Bounds of B1 (also B1-spr, B1-3d and mesh B1, which move the same
    bytes and do the same work) and of B2 for st/stp [N, P] and the slot
    array pos [B, K], with caller-given row sums and fused.  Bytes: st and
    stp read once, seven words per quad of four slots and one quad count
    per sample; with caller-given sums base and nc_base, fused the reference
    row; the outputs written once: [N, B] x 2 for B1 (fused also the three
    [N] row sums), the three [B] results for B2, which also reads 16 bytes
    of node metadata a row.  Operations count the slots that hold an entry
    in this run, not K; a fused call adds the row sums' operations, `sweep`
    (``sweep_ops`` of the states; without it every cell is charged as one
    that differs)."""
    B, K = pos.shape
    valid = int(((pos >= 0) & (pos < P)).sum())
    read = 2 * N * P + 4 * 7 * -(-K // 4) * B + 4 * B
    triples = N * valid * OPS_PER_TRIPLE
    if sweep is None:
        sweep = N * P * OPS_PER_CELL_REDUCTION
    b1 = (read + 8 * N * B, triples + 2 * N * B)
    b2 = (read + 16 * N + 12 * B, triples + N * B * OPS_PER_PAIR_B2)
    return {"B1": bound(b1[0] + 8 * N, b1[1]),
            "B2": bound(b2[0] + 8 * N, b2[1]),
            "B1 fused": bound(b1[0] + P + 12 * N, b1[1] + sweep),
            "B2 fused": bound(b2[0] + P, b2[1] + sweep)}


def executed_sweep_ms(st, stp, ref):
    """The compiled sweep's instructions on these states over the int32
    rate: what the fused kernels spend where the bound charges sweep_ops."""
    return sweep_ops(st, stp, ref, executed=True) / INT32_OPS_PER_S * 1e3


def reductions_bound(N, P):
    """Bound of the per-node row sums alone (row_reductions, the plain twin
    of what the fused kernels fold in): st and stp read once, three [N]
    int32 vectors written."""
    return bound(2 * N * P + 12 * N, N * P * OPS_PER_CELL_REDUCTION)


def log(*a):
    print(*a, flush=True)


def median_ms(fn, runs=5):
    """Median of `runs` synchronized wall times of fn(), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def max_abs_err(got, want) -> int:
    """Largest |kernel - plain| over a tuple of integer outputs; raises
    unless it is 0."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {g.dtype} vs "
                                 f"{w.shape} {w.dtype}")
        err = max(err, int((g.long() - w.long()).abs().max().item())
                  if g.numel() else 0)
    if err:
        raise AssertionError(f"kernel disagrees with plain: max |err| {err}")
    return err


class Kernels:
    """The kernels of the port: comparison errors, times and the launch
    counts of a main path."""

    def __init__(self, ps, pmesh):
        self.ps = ps
        self.pmesh = pmesh
        self.err = {"B1": 0, "B2": 0, "B1-spr": 0, "B1-3d": 0, "mesh B1": 0,
                    "B1 fused": 0, "B2 fused": 0}
        self.ms = {}
        self.bounds = {}

    def hold(self, name, got, want):
        self.err[name] = max(self.err[name], max_abs_err(got, want))

    def compare_b1(self, b1, ambiguous=False):
        """B1 and B1-spr against their plain twins on one input.  With
        ambiguous path states (several bases in a mask) the SPR term
        (ref & a_r) == 0 and the placement term a_r != ref part, so the
        kernel's two modes must give different scores there."""
        ps = self.ps
        scores = {}
        for name, spr in (("B1", False), ("B1-spr", True)):
            got = ps.score_entries_T(*b1, spr=spr)
            self.hold(name, got, ps.score_entries_T_plain(*b1, spr=spr))
            scores[spr] = got[0]
            self.compare_3d(b1, spr, got)
            del got
        torch.cuda.synchronize()
        if ambiguous and torch.equal(scores[False], scores[True]):
            raise AssertionError("B1-spr scores equal B1's on ambiguous "
                                 "path states")

    @staticmethod
    def tile_width(b1):
        """Samples per B1-3d tile for the slot array of b1: 1,024 slots a
        tile, as the TPU kernel cut its tiles, and at least one sample."""
        return max(1, 1024 // b1[5].shape[1])

    def compare_3d(self, b1, spr, flat_out):
        """B1-3d against its plain twin and against B1's [N, B] matrices
        re-laid, on the real rows and samples of the tiles."""
        ps = self.ps
        tb = self.tile_width(b1)
        got = ps.score_entries_3d(*b1, tb, spr=spr)
        want = ps.score_entries_3d_plain(*b1, tb, spr=spr)
        if got[2:] != want[2:]:
            raise AssertionError(f"B1-3d shapes {got[2:]} vs {want[2:]}")
        N, B = got[2], got[3]
        relaid = [ps.tiles_to_T(t, N, B) for t in got[:2]]
        del got
        self.hold("B1-3d", relaid, [ps.tiles_to_T(t, N, B) for t in want[:2]])
        del want
        self.hold("B1-3d", relaid, flat_out)

    def compare_fused(self, b1, b2):
        """The fused calls against row_reductions plus the plain twins:
        B1's two matrices and the three row sums it writes, the public
        fused wrapper, and B2's three [B] results."""
        ps = self.ps
        st, stp, ref, base, nc_base, pos, gval, kmiss = b1
        want = ps.score_entries_T_plain(*b1)
        score_t, nc_t, sums = ps._score_entries_cuda(
            st, stp, ref, None, None, pos, gval, kmiss, False)
        self.hold("B1 fused", (score_t, nc_t, *sums),
                  (*want, base, nc_base, b2[5]))
        del score_t, nc_t
        self.hold("B1 fused", ps.score_sparse_stp_T(st, stp, ref, pos, gval,
                                                    kmiss), (*want, b2[5]))
        del want
        self.hold("B2 fused",
                  ps.placement_reduce(st, stp, ref, None, None, None, *b2[6:]),
                  ps.placement_reduce_plain(*b2))

    def compare(self, st, stp, ref, node, pos, gval, kmiss, ambiguous=False):
        """B1, B1-spr, B1-3d and B2 against their plain twins on one input,
        with caller-given row sums and fused; node is (active, is_leaf,
        is_root, num_leaves, bfs_rank)."""
        ps = self.ps
        base, nc_base, nnm = ps.row_reductions(st, stp, ref)
        b1 = (st, stp, ref, base, nc_base, pos, gval, kmiss)
        self.compare_b1(b1, ambiguous)
        b2 = (st, stp, ref, base, nc_base, nnm, *node, pos, gval, kmiss)
        self.hold("B2", ps.placement_reduce(*b2),
                  ps.placement_reduce_plain(*b2))
        self.compare_fused(b1, b2)
        torch.cuda.synchronize()
        return b1, b2

    @staticmethod
    def fused_args(b1, b2):
        """(arguments of score_sparse_stp_T, of the fused placement_reduce)
        from the explicit ones."""
        st, stp, ref, _, _, pos, gval, kmiss = b1
        return ((st, stp, ref, pos, gval, kmiss),
                (st, stp, ref, None, None, None, *b2[6:]))

    def time(self, phase, b1, b2):
        ps = self.ps
        tb = self.tile_width(b1)
        f1, f2 = self.fused_args(b1, b2)
        t = {"B1": (median_ms(lambda: ps.score_entries_T(*b1)),
                    median_ms(lambda: ps.score_entries_T_plain(*b1))),
             "B1-3d": (median_ms(lambda: ps.score_entries_3d(*b1, tb)),
                       median_ms(lambda: ps.score_entries_3d_plain(*b1,
                                                                   tb))),
             "B2": (median_ms(lambda: ps.placement_reduce(*b2)),
                    median_ms(lambda: ps.placement_reduce_plain(*b2))),
             "B1 fused": (median_ms(lambda: ps.score_sparse_stp_T(*f1)),
                          median_ms(
                              lambda: ps.score_sparse_stp_T_plain(*f1))),
             "B2 fused": (median_ms(lambda: ps.placement_reduce(*f2)),
                          None)}
        self.ms[phase] = t
        N, P = b1[0].shape
        self.bounds[phase] = score_bounds(N, P, b1[5].cpu().numpy(),
                                          sweep_ops(*b1[:3]))
        t["sweep_executed_ms"] = executed_sweep_ms(*b1[:3])
        return t

    def reset_counts(self):
        self.ps.score_entries_T.launches = 0
        self.ps.score_entries_T.launches_spr = 0
        self.ps.placement_reduce.launches = 0
        self.ps.score_entries_3d.launches = 0
        self.ps.row_reductions.calls = 0

    def counts(self):
        """Launches per kernel, and the calls of row_reductions; B1 counts
        its spr=False launches only.  Mesh B1 launches the B1 kernel once
        per shard, so over a sharded run its count is B1's."""
        f = self.ps.score_entries_T
        return {"B1": f.launches - f.launches_spr, "B1-spr": f.launches_spr,
                "B2": self.ps.placement_reduce.launches,
                "B1-3d": self.ps.score_entries_3d.launches,
                "row_reductions": self.ps.row_reductions.calls}


def ambiguous_states(st, parent, root_slot, seed):
    """st with a random base mask ORed into a quarter of its entries (most
    become multi-base ambiguity masks, as Fitch sets are), and the parent
    states of the result."""
    from usher_tpu_torch.ops.placement import parent_states
    g = torch.Generator(device=st.device).manual_seed(seed)
    r = torch.randint(0, 64, tuple(st.shape), dtype=torch.uint8,
                      device=st.device, generator=g)
    st = torch.where(r < 16, st | r, st)
    del r
    return st, parent_states(st, parent, root_slot)


# --- random MATs (the tests/test_placement.py recipes) --------------------

def random_mat(rng, n_leaves, n_positions, mut_rate=0.35):
    """Random multifurcating topology with well-formed branch mutations
    (par_nuc is the parent's path state, mut != par), back mutations
    included, sometimes a root mutation."""
    from usher_tpu_torch.core.tree import Mutation
    from usher_tpu_torch.io.newick import parse_newick_string
    bases = NIBBLES.tolist()
    parts = [f"L{i}" for i in range(n_leaves)]
    while len(parts) > 1:
        k = int(rng.integers(2, min(4, len(parts)) + 1))
        group = [parts.pop(int(rng.integers(len(parts)))) for _ in range(k)]
        parts.append("(" + ",".join(group) + ")")
    T = parse_newick_string(parts[0] + ";")
    positions = list(range(100, 100 + n_positions))
    ref = {p: bases[int(rng.integers(4))] for p in positions}
    root_mut = rng.random() < 0.5
    stack = [(T.root, {positions[0]: [b for b in bases
                                      if b != ref[positions[0]]][0]}
              if root_mut else {})]
    if root_mut:
        p = positions[0]
        T.root.add_mutation(Mutation("c", p, ref[p], ref[p],
                                     stack[0][1][p]))
    while stack:
        node, state = stack.pop()
        state = dict(state)
        if node.parent is not None:
            for p in positions:
                if rng.random() < mut_rate / n_positions * 6:
                    par = state.get(p, ref[p])
                    mut = [b for b in bases if b != par][int(rng.integers(3))]
                    node.add_mutation(Mutation("c", p, ref[p], par, mut))
                    state[p] = mut
        for ch in node.children:
            stack.append((ch, state))
    return T, ref


def random_sample(rng, ref, n_entries):
    """Entries at random sites: 15% missing (N), 20% ambiguous masks, the
    rest a non-reference base."""
    from usher_tpu_torch.core.tree import Mutation
    bases = NIBBLES.tolist()
    sites = sorted(rng.choice(list(ref), size=min(n_entries, len(ref)),
                              replace=False).tolist())
    muts = []
    for p in sites:
        r = rng.random()
        m = Mutation("c", p, ref[p], ref[p])
        if r < 0.15:
            m.is_missing = True
            m.mut_nuc = 15
        elif r < 0.35:
            m.mut_nuc = int(rng.integers(3, 15))
        else:
            m.mut_nuc = [b for b in bases if b != ref[p]][int(rng.integers(3))]
        muts.append(m)
    return muts


def phase_kernel_small(kern, device):
    from usher_tpu_torch.core.flat import FlatMAT
    from usher_tpu_torch.ops.placement import parent_states
    ps = kern.ps
    cases = 0
    for seed in range(6):
        rng = np.random.default_rng(seed)
        n_leaves, n_pos = [(20, 15), (60, 40), (200, 300)][seed % 3]
        T, ref = random_mat(rng, n_leaves, n_pos)
        positions = np.array(sorted(ref), dtype=np.int64)
        refarr = np.array([ref[p] for p in positions.tolist()], np.uint8)
        flat = FlatMAT(T, positions, refarr, "c", device=device)
        assert flat.cap > flat.n_slots
        samples = [random_sample(rng, ref, int(rng.integers(1, 12)))
                   for _ in range(13)]
        # forced ties: an empty sample (scores equal base everywhere) and a
        # duplicated sample
        samples += [[], samples[0]]
        st, parent = flat.sync()
        stp = parent_states(st, parent, flat.root_slot)
        meta = flat.order_arrays()
        node = tuple(torch.from_numpy(meta[k]).to(device) for k in (
            "active", "is_leaf", "is_root_mask", "num_leaves", "bfs_rank"))
        for k_slots in (8, 64, 2048):
            pos, gval, kmiss = (torch.from_numpy(x).to(device) for x in
                                ps.sparsify(samples, flat.pos_index,
                                            flat.P_pad, k_slots))
            kern.compare(st, stp, flat.ref_dev, node, pos, gval, kmiss)
            # the same slots on multi-base path states, where B1-spr's
            # SPR term parts from B1's placement term
            st_a, stp_a = ambiguous_states(st, parent, flat.root_slot, seed)
            kern.compare(st_a, stp_a, flat.ref_dev, node, pos, gval, kmiss,
                         ambiguous=True)
            cases += 2
        if seed % 3 == 2:
            cases += kernel_small_shapes(kern, rng, flat, st, stp, node, ref)
    return {"cases": cases, "max_abs_err": dict(kern.err)}


def kernel_small_shapes(kern, rng, flat, st, stp, node, ref):
    """The launch-plan corners on one small MAT: more blocks than row
    groups, batches of 1, 3 and 64 samples (1 to 32 lanes a sample), 8 and
    2,048 slots, and a column count that is no multiple of 16 (the threads
    copy the rows instead of the bulk copies)."""
    ps = kern.ps
    device = st.device
    cases = 0
    for n_samples, k_slots, cut in ((1, 8, 0), (1, 2048, 0), (3, 8, 0),
                                    (3, 2048, 5), (64, 8, 5), (64, 2048, 0),
                                    (64, 64, 11)):
        samples = [random_sample(rng, ref, int(rng.integers(0, 12)))
                   for _ in range(n_samples)]
        pos, gval, kmiss = (torch.from_numpy(x).to(device) for x in
                            ps.sparsify(samples, flat.pos_index, flat.P_pad,
                                        k_slots))
        # without the last `cut` columns; entries there become padding
        P = flat.P_pad - cut
        st_c, stp_c = (x[:, :P].contiguous() for x in (st, stp))
        plan = ps.launch_plan(P, n_samples, pos.shape[1], True,
                              st_c.data_ptr() % 16 == 0,
                              limits=ps.device_limits(device.index or 0))
        if plan.grid <= -(-st_c.shape[0] // plan.rows):
            raise AssertionError(f"{plan}: expected more blocks than row "
                                 f"groups for {st_c.shape[0]} rows")
        if plan.vec != (cut == 0):
            raise AssertionError(f"{plan}: P={P}")
        kern.compare(st_c, stp_c, flat.ref_dev[:P].contiguous(), node, pos,
                     gval, kmiss)
        cases += 1
    # a fused B1 call without samples still owes the row sums, and B2
    # without rows one identity part per block: both from the kernels
    ref_dev = flat.ref_dev
    score_t, nc_t, sums = ps._score_entries_cuda(
        st, stp, ref_dev, None, None, pos[:0], gval[:0], kmiss[:0], False)
    none = torch.empty((st.shape[0], 0), dtype=torch.int32, device=device)
    kern.hold("B1 fused", (score_t, nc_t, *sums),
              (none, none, *ps.row_reductions(st, stp, ref_dev)))
    parts = ps.placement_partials(st[:0], stp[:0], ref_dev, None, None, None,
                                  *(x[:0] for x in node), pos, gval, kmiss)
    want = torch.tensor([1 << 30, 0, -1, -1], dtype=torch.int32,
                        device=device)[:, None, None].expand_as(parts)
    kern.hold("B2 fused", tuple(parts), tuple(want))
    return cases + 2


# --- synthetic flat MATs (bench.py's recipe) -------------------------------

def synth_mat(rng, n_nodes, n_sites, n_mut=3):
    """Parent pointers in topological order and path states derived
    root->leaf with n_mut random branch mutations per node (numpy)."""
    ref = NIBBLES[rng.integers(0, 4, size=n_sites)]
    parent = np.zeros(n_nodes, dtype=np.int32)
    parent[1:] = (rng.random(n_nodes - 1)
                  * np.arange(n_nodes - 1)).astype(np.int32)
    st = np.empty((n_nodes, n_sites), dtype=np.uint8)
    st[0] = ref
    mut_pos = rng.integers(0, n_sites, size=(n_nodes, n_mut))
    mut_allele = NIBBLES[rng.integers(0, 4, size=(n_nodes, n_mut))]
    for i in range(1, n_nodes):
        st[i] = st[parent[i]]
        st[i, mut_pos[i]] = mut_allele[i]
    is_leaf = np.ones(n_nodes, dtype=bool)
    is_leaf[parent[1:]] = False
    is_leaf[0] = False
    num_leaves = is_leaf.astype(np.int32)
    for i in range(n_nodes - 1, 0, -1):
        num_leaves[parent[i]] += num_leaves[i]
    return dict(st=st, parent=parent, ref=ref, mut_pos=mut_pos,
                is_leaf=is_leaf, num_leaves=num_leaves)


def synth_slots(rng, ref, n_samples, n_entries):
    """Samples with n_entries distinct non-reference sites each, as slot
    arrays (pos, gval, kmiss)."""
    P = len(ref)
    pos = np.stack([rng.choice(P, size=n_entries, replace=False)
                    for _ in range(n_samples)]).astype(np.int32)
    shift = rng.integers(1, 4, size=pos.shape)
    idx = (np.log2(ref[pos]).astype(np.int64) + shift) % 4
    gval = NIBBLES[idx]
    kmiss = np.zeros(pos.shape, dtype=bool)
    return pos, gval, kmiss


def phase_kernel_synth(kern, name, mat, n_samples, n_entries, seed, device):
    rng = np.random.default_rng(seed)
    N, P = mat["st"].shape
    st = torch.from_numpy(mat["st"]).to(device)
    parent = torch.from_numpy(mat["parent"]).to(device)
    stp = st[parent.long()]
    ref = torch.from_numpy(mat["ref"]).to(device)
    node = (torch.ones(N, dtype=torch.bool, device=device),
            torch.from_numpy(mat["is_leaf"]).to(device),
            (torch.arange(N, device=device) == 0),
            torch.from_numpy(mat["num_leaves"]).to(device),
            torch.arange(N, dtype=torch.int32, device=device))
    pos, gval, kmiss = (torch.from_numpy(x).to(device) for x in
                        synth_slots(rng, mat["ref"], n_samples, n_entries))
    b1, b2 = kern.compare(st, stp, ref, node, pos, gval, kmiss)
    t = kern.time(name, b1, b2)
    del b1, b2, st, stp
    torch.cuda.empty_cache()
    bounds = kern.bounds[name]
    return {"N": N, "P": P, "B": n_samples, "K": n_entries,
            "max_abs_err": dict(kern.err),
            "B1_ms": t["B1"][0], "B1_plain_ms": t["B1"][1],
            "B1_3d_ms": t["B1-3d"][0], "B1_3d_plain_ms": t["B1-3d"][1],
            "B2_ms": t["B2"][0], "B2_plain_ms": t["B2"][1],
            "B1_fused_ms": t["B1 fused"][0],
            "B1_fused_plain_ms": t["B1 fused"][1],
            "B2_fused_ms": t["B2 fused"][0],
            "B1_bound": bounds["B1"], "B2_bound": bounds["B2"],
            "B1_fused_bound": bounds["B1 fused"],
            "B2_fused_bound": bounds["B2 fused"],
            "sweep_executed_ms": t["sweep_executed_ms"]}


# --- end to end through the CLI --------------------------------------------

@contextlib.contextmanager
def sankoff_devices(seen):
    """Record the device of every Sankoff state tensor the CLI computes."""
    from usher_tpu_torch.ops import sankoff
    orig = sankoff._sankoff_states

    def spy(*a, **k):
        out = orig(*a, **k)
        seen.append(out.device.type)
        return out

    sankoff._sankoff_states = spy
    try:
        yield
    finally:
        sankoff._sankoff_states = orig


def run_cli(argv):
    from usher_tpu_torch.cli.usher_cli import main
    rc = main(argv)
    if rc != 0:
        raise AssertionError(f"usher CLI {argv} returned {rc}")


def same_files(dir_a, dir_b, pairs):
    for fa, fb in pairs:
        with open(os.path.join(dir_a, fa), "rb") as a, \
                open(os.path.join(dir_b, fb), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"{dir_a}/{fa} differs from {dir_b}/{fb}")


def phase_fixture_e2e(kern):
    fx = os.path.join(REPO, "tests", "fixtures")
    out = os.path.join(WORK, "fixture")
    seen = []
    with sankoff_devices(seen):
        run_cli(["-t", os.path.join(fx, "global_phylo.nh"),
                 "-v", os.path.join(fx, "global_samples.vcf"),
                 "-o", os.path.join(out, "out.pb"), "-d",
                 os.path.join(out, "b"), "--mesh-devices", "0"])
    run_cli(["-i", os.path.join(out, "out.pb"),
             "-v", os.path.join(fx, "new_samples.vcf"),
             "-o", os.path.join(out, "out2.pb"), "-d",
             os.path.join(out, "p"), "--mesh-devices", "0"])
    same_files(os.path.join(out, "p"), GOLDENS, zip(PLACE_FILES, GOLDEN_FILES))
    if seen != ["cuda"]:
        raise AssertionError(f"Sankoff ran on {seen}, expected ['cuda']")
    counts = kern.counts()
    if counts["B1"] < 1:
        raise AssertionError("fixture placement never launched B1")
    return {"goldens": "byte-identical", "sankoff_device": seen[0],
            "launches": counts}


def synth_tree(mat, positions):
    """The synthetic MAT as a Tree (leaves named leaf_<i>)."""
    from usher_tpu_torch.core.tree import Mutation, Tree
    st, parent, ref = mat["st"], mat["parent"], mat["ref"]
    N = len(parent)
    T = Tree()
    nodes = [T.create_node("node_1", None)]
    for i in range(1, N):
        name = f"leaf_{i}" if mat["is_leaf"][i] else f"node_{i + 1}"
        nodes.append(T.create_node(name, nodes[parent[i]]))
    for i in range(1, N):
        for c in sorted(set(mat["mut_pos"][i].tolist())):
            a, pa = int(st[i, c]), int(st[parent[i], c])
            if a != pa:
                nodes[i].add_mutation(Mutation(CHROM, int(positions[c]),
                                               int(ref[c]), pa, a))
    return T


def write_samples_vcf(path, rng, mat, positions, n_samples, n_new=2,
                      n_missing=2):
    """Samples near random nodes: the node's genotype plus n_new new
    mutations and n_missing N calls, written as a VCF of the sites where
    any sample differs from the reference."""
    st, ref = mat["st"], mat["ref"]
    N, P = st.shape
    G = st[rng.integers(0, N, size=n_samples)].copy()        # [B, P]
    rows = np.arange(n_samples)[:, None]
    new = rng.integers(0, P, size=(n_samples, n_new))
    G[rows, new] = NIBBLES[(np.log2(G[rows, new]).astype(np.int64)
                            + rng.integers(1, 4, size=new.shape)) % 4]
    G[rows, rng.integers(0, P, size=(n_samples, n_missing))] = 15
    sites = np.nonzero((G != ref[None, :]).any(0))[0]
    chars = np.array(list("?AC?G???T??????N"))
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                "FILTER\tINFO\tFORMAT\t"
                + "\t".join(f"sample_{b}" for b in range(n_samples)) + "\n")
        for c in sites.tolist():
            col = G[:, c]
            alts = [int(a) for a in NIBBLES
                    if a != ref[c] and (col == a).any()]
            code = np.full(n_samples, "0", dtype=object)
            for j, a in enumerate(alts):
                code[col == a] = str(j + 1)
            code[col == 15] = "."
            f.write(f"{CHROM}\t{positions[c]}\t.\t{chars[ref[c]]}\t"
                    f"{','.join(chars[a] for a in alts) or '.'}\t.\t.\t.\t"
                    "GT\t" + "\t".join(code.tolist()) + "\n")
    entries = (G != ref[None, :]).sum(1)
    return len(sites), float(entries.mean())


def stage_seconds(trace_path):
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        out[e["name"]] = out.get(e["name"], 0.0) + e["dur"] / 1e6
    return out


def realistic_setup(mat, n_samples, seed):
    """Inputs of the realistic run: the synthetic MAT as a Tree and as a
    pb, and a VCF of n_samples new samples."""
    from usher_tpu_torch.io.pbio import save_mat_pb
    rng = np.random.default_rng(seed)
    out = os.path.join(WORK, "realistic")
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    positions = np.arange(1, mat["st"].shape[1] + 1, dtype=np.int64)
    T = synth_tree(mat, positions)
    pb = os.path.join(out, "tree.pb")
    save_mat_pb(T, pb)
    vcf = os.path.join(out, "samples.vcf")
    n_sites, mean_entries = write_samples_vcf(vcf, rng, mat, positions,
                                              n_samples)
    setup_s = time.perf_counter() - t0
    return T, pb, vcf, {"setup_s": setup_s, "vcf_sites": n_sites,
                        "mean_entries": mean_entries,
                        "tree_nodes": T.num_nodes()}


def run_realistic_cli(pb, vcf, batch_size, *flags, tag=None):
    from usher_tpu_torch.utils.instrument import Instrumentor
    if tag is None:
        tag = "".join(f.strip("-") for f in flags)
    out = os.path.join(WORK, "realistic", "out" + tag)
    trace = os.path.join(WORK, "realistic", f"trace{tag}.json")
    inst = Instrumentor.get()
    inst.begin_session(trace)
    t0 = time.perf_counter()
    try:
        run_cli(["-i", pb, "-v", vcf, "-d", out, "-s",
                 "--batch-size", str(batch_size), *flags])
    finally:
        inst.end_session()
    return time.perf_counter() - t0, stage_seconds(trace), out


def check_realistic(kern, T, vcf, out_dir, n_samples, device, batch_size):
    from usher_tpu_torch.io.newick import parse_newick_string
    from usher_tpu_torch.io.vcf import read_vcf
    from usher_tpu_torch.ops.placement import parent_states
    from usher_tpu_torch.placement.driver import PlacementEngine
    ps = kern.ps
    with open(os.path.join(out_dir, "placement_stats.tsv")) as f:
        rows = [l for l in f.read().split("\n") if l]
    if len(rows) != n_samples:
        raise AssertionError(f"placement_stats.tsv has {len(rows)} rows")
    n_leaves_in = len(T.get_leaves_ids())
    with open(os.path.join(out_dir, "final-tree.nh")) as f:
        n_leaves_out = len(parse_newick_string(f.read()).get_leaves_ids())
    if n_leaves_out != n_leaves_in + n_samples:
        raise AssertionError(f"final tree has {n_leaves_out} leaves, "
                             f"expected {n_leaves_in} + {n_samples}")

    # the first batch through the kernel and through its plain twin
    missing, vcf_data = read_vcf(T, vcf, create_new_mat=False)
    eng = PlacementEngine(T, vcf_data, device=device)
    batch = [s.mutations for s in missing[:batch_size]]

    def summary(results):
        return [(r.best_score, r.num_best, r.best_node.identifier,
                 r.best_has_unique, [n.identifier for n in r.tied_nodes],
                 r.tied_has_unique) for r in results]

    got = summary(eng.score_samples(batch))
    fused_b1 = ps.score_sparse_stp_T
    ps.score_sparse_stp_T = ps.score_sparse_stp_T_plain
    try:
        want = summary(eng.score_samples(batch))
    finally:
        ps.score_sparse_stp_T = fused_b1
    if got != want:
        raise AssertionError("first batch: kernel and plain SampleResults "
                             "differ")
    # the kernels at the main path's own shapes on the engine's FlatMAT:
    # B1 on one batch, B2 on all samples (the -s pre-pass)
    flat = eng.flat
    st, parent = flat.sync()
    stp = st[parent.long()]
    stp[flat.root_slot] = st[flat.root_slot]
    meta = flat.order_arrays()
    node = tuple(torch.from_numpy(meta[k]).to(device) for k in (
        "active", "is_leaf", "is_root_mask", "num_leaves", "bfs_rank"))
    N, P = (int(x) for x in st.shape)
    shapes = {"parent_states_ms": median_ms(
        lambda: parent_states(st, parent, flat.root_slot))}
    sweep = sweep_ops(st, stp, flat.ref_dev)
    shapes["sweep_executed_ms"] = executed_sweep_ms(st, stp, flat.ref_dev)
    for name, samples in (("B1", batch),
                          ("B2", [s.mutations for s in missing])):
        pos, gval, kmiss = (torch.from_numpy(x).to(device) for x in
                            ps.sparsify(samples, flat.pos_index, flat.P_pad))
        b1, b2 = kern.compare(st, stp, flat.ref_dev, node, pos, gval, kmiss)
        f1, f2 = kern.fused_args(b1, b2)
        fn, plain, args, fused = (
            (ps.score_entries_T, ps.score_entries_T_plain, b1,
             lambda: ps.score_sparse_stp_T(*f1)) if name == "B1" else
            (ps.placement_reduce, ps.placement_reduce_plain, b2,
             lambda: ps.placement_reduce(*f2)))
        bounds = score_bounds(N, P, pos.cpu().numpy(), sweep)
        shapes[name] = {"N": N, "P": P,
                        "B": len(samples), "K": int(pos.shape[1]),
                        "ms": median_ms(lambda: fn(*args)),
                        "plain_ms": median_ms(lambda: plain(*args)),
                        "fused_ms": median_ms(fused),
                        "bound": bounds[name],
                        "fused_bound": bounds[name + " fused"]}
    return {"stats_rows": len(rows), "leaves_added": n_leaves_out - n_leaves_in,
            "first_batch": f"{len(got)} SampleResults identical",
            "main_shapes": shapes}


# --- the mesh path -------------------------------------------------------------

MESH_SHARDS = 4        # --mesh-devices of the CLI phases: a 2 x 2 mesh


def mesh_against_unsharded(kern, mesh, sh, node_sh, whole, node,
                           plain_runs=3):
    """mesh B1 against its plain twin and the unsharded B1, and the sharded
    B2 step against the unsharded B2 kernel, all exact, then the median ms
    of each.  sh is (st, stp, ref, pos, gval, kmiss) sharded over the mesh
    and node_sh the five node metadata arrays; whole and node are the same
    on the lead device."""
    ps, pmesh = kern.ps, kern.pmesh
    st, stp, ref, pos, gval, kmiss = whole

    def gathered(out):
        """Sharded (score, nc, nnm) as whole tensors on the lead device."""
        score_t, nc_t, nnm = out
        parts = [torch.cat([torch.cat([b.to(mesh.lead) for b in per_d], 0)
                            for per_d in blocks], 1)
                 for blocks in (score_t, nc_t)]
        return parts + [torch.cat([t.to(mesh.lead) for t in nnm[0]])]

    mesh_fn = pmesh.sharded_sparse_score_fn(mesh)
    before = kern.counts()["B1"]
    got = gathered(mesh_fn(*sh))
    per_call = kern.counts()["B1"] - before
    if per_call != mesh.size:
        raise AssertionError(f"mesh B1 made {per_call} launches for "
                             f"{mesh.size} shards")
    err = max_abs_err(got, gathered(
        pmesh.sharded_sparse_score_plain(mesh, *sh)))
    err = max(err, max_abs_err(got, ps.score_sparse_stp_T(*whole)))
    kern.err["mesh B1"] = max(kern.err["mesh B1"], err)
    del got
    base, nc_base, nnm = ps.row_reductions(st, stp, ref)
    b2 = (st, stp, ref, base, nc_base, nnm, *node, pos, gval, kmiss)
    fused_b2 = (st, stp, ref, None, None, None, *node, pos, gval, kmiss)
    best, row, num_best = ps.placement_reduce(*b2)
    kern.hold("B2 fused", ps.placement_reduce(*fused_b2),
              (best, row, num_best))
    got2 = pmesh.sharded_placement_reduce(mesh, sh[0], sh[1], sh[2],
                                          *node_sh, *sh[3:])
    err2 = max_abs_err(got2, (best, node[4][row.long()], num_best))
    kern.err["B2"] = max(kern.err["B2"], err2)
    torch.cuda.synchronize()
    t = {
        "mesh_b1_ms": median_ms(lambda: mesh_fn(*sh)),
        "mesh_b1_plain_ms": median_ms(
            lambda: pmesh.sharded_sparse_score_plain(mesh, *sh),
            runs=plain_runs),
        "unsharded_score_sparse_ms": median_ms(
            lambda: ps.score_sparse_stp_T(*whole)),
        "mesh_b2_ms": median_ms(lambda: pmesh.sharded_placement_reduce(
            mesh, sh[0], sh[1], sh[2], *node_sh, *sh[3:])),
        "unsharded_b2_ms": median_ms(lambda: ps.placement_reduce(*b2)),
        "unsharded_b2_fused_ms": median_ms(
            lambda: ps.placement_reduce(*fused_b2)),
    }
    return dict(t, launches_per_call=per_call,
                max_abs_err={"mesh B1": err, "B2": err2}), b2


def phase_mesh_kernel(kern, mat, n_samples, n_entries, seed, device):
    """mesh B1 and the sharded B2 step at the genome shape on a 2 x 2
    (data, model) mesh over the visible cards."""
    ps, pmesh = kern.ps, kern.pmesh
    rng = np.random.default_rng(seed)
    N, P = mat["st"].shape
    mesh = pmesh.make_mesh(MESH_SHARDS, device=device)
    pos_h, gval_h, kmiss_h = synth_slots(rng, mat["ref"], n_samples,
                                         n_entries)
    stp_h = mat["st"][mat["parent"]]
    node_h = (np.ones(N, dtype=bool), mat["is_leaf"], np.arange(N) == 0,
              mat["num_leaves"], np.arange(N, dtype=np.int32))
    sh = pmesh.shard_sparse_inputs(mesh, mat["st"], stp_h, mat["ref"],
                                   pos_h, gval_h, kmiss_h)
    node_sh = [pmesh.put_nodes(mesh, a) for a in node_h]
    # the unsharded inputs, on the lead device
    whole = tuple(torch.from_numpy(x).to(mesh.lead) for x in (
        mat["st"], stp_h, mat["ref"], pos_h, gval_h, kmiss_h))
    del stp_h
    node = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(mesh.lead)
                 for a in node_h)
    t, b2 = mesh_against_unsharded(kern, mesh, sh, node_sh, whole, node)

    # one shard's kernel launch alone: N / model rows x B / data samples
    s00 = [x[0][0] for x in sh]
    base0, nc_base0, _ = ps.row_reductions(s00[0], s00[1], s00[2])
    shard_b1 = (s00[0], s00[1], s00[2], base0, nc_base0, *s00[3:])
    b1 = (*whole[:3], b2[3], b2[4], *whole[3:])
    t.update({
        "unsharded_b1_kernel_ms": median_ms(
            lambda: ps.score_entries_T(*b1)),
        "one_shard_b1_kernel_ms": median_ms(
            lambda: ps.score_entries_T(*shard_b1)),
        "row_reductions_ms": median_ms(
            lambda: ps.row_reductions(*whole[:3])),
    })
    kern.ms["mesh_kernel"] = t
    kern.bounds["mesh_kernel"] = dict(
        score_bounds(N, P, pos_h, sweep_ops(*whole[:3])),
        reductions=reductions_bound(N, P))
    shard_shape = [int(x) for x in (*s00[0].shape, s00[3].shape[0])]
    devices = sorted({str(d) for d in mesh.devices.reshape(-1).tolist()})
    del whole, sh, b1, b2, shard_b1, s00
    torch.cuda.empty_cache()
    return dict(t, N=N, P=P, B=n_samples, K=n_entries,
                mesh=mesh.shape, devices=devices, shard_NPB=shard_shape,
                mesh_b1_bound=kern.bounds["mesh_kernel"]["B1 fused"],
                reductions_bound=kern.bounds["mesh_kernel"]["reductions"])


def phase_mesh_fixture(kern, built_pb):
    """The fixture's placement step sharded over MESH_SHARDS, dense and
    with --bigmat, from the pb that fixture_e2e built."""
    fx = os.path.join(REPO, "tests", "fixtures")
    out = os.path.join(WORK, "fixture_mesh")
    before = kern.counts()
    for tag, flags in (("dense", []), ("bigmat", ["--bigmat"])):
        run_cli(["-i", built_pb, "-v", os.path.join(fx, "new_samples.vcf"),
                 "-d", os.path.join(out, tag), "--mesh-devices",
                 str(MESH_SHARDS), *flags])
        same_files(os.path.join(out, tag), GOLDENS,
                   zip(PLACE_FILES, GOLDEN_FILES))
    after = kern.counts()
    if after["B1"] - before["B1"] < MESH_SHARDS:
        raise AssertionError("the sharded fixture run never launched mesh B1")
    return {"goldens": "byte-identical (dense and --bigmat)",
            "mesh_devices": MESH_SHARDS,
            "launches": {k: after[k] - before[k] for k in after}}


def mesh_reference(mat, pb, n_samples, batch_size, seed):
    """A VCF of n_samples new samples for the realistic MAT and the
    unsharded CLI run on it, which the sharded run must reproduce."""
    rng = np.random.default_rng(seed)
    positions = np.arange(1, mat["st"].shape[1] + 1, dtype=np.int64)
    vcf = os.path.join(WORK, "realistic", f"samples{n_samples}.vcf")
    n_sites, mean_entries = write_samples_vcf(vcf, rng, mat, positions,
                                              n_samples)
    wall, stages, out = run_realistic_cli(
        pb, vcf, batch_size, "--mesh-devices", "0", tag="mesh_off")
    return {"vcf": vcf, "out": out, "wall": wall, "stages": stages,
            "n_sites": n_sites, "mean_entries": mean_entries}


def check_mesh_realistic(kern, pb, vcf, batch_size, device):
    """The mesh kernels at the sharded main path's own shapes, on the
    engine's sharded FlatMAT of the realistic tree: mesh B1 on the first
    batch and the sharded B2 step on the whole sample set (the -s
    pre-pass), each against its plain twin and the unsharded kernel."""
    from usher_tpu_torch.io.pbio import load_mat_pb
    from usher_tpu_torch.io.vcf import read_vcf
    from usher_tpu_torch.placement.driver import PlacementEngine
    ps, pmesh = kern.ps, kern.pmesh
    T = load_mat_pb(pb)
    missing, vcf_data = read_vcf(T, vcf, create_new_mat=False)
    mesh = pmesh.make_mesh(MESH_SHARDS, device=device)
    eng = PlacementEngine(T, vcf_data, mesh=mesh)
    flat = eng.flat
    st_sh, stp_sh = flat.sync_mesh()
    meta = flat.order_arrays()
    node_h = [meta[k] for k in ("active", "is_leaf", "is_root_mask",
                                "num_leaves", "bfs_rank")]
    node_sh = [pmesh.put_nodes(mesh, a) for a in node_h]
    node = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(mesh.lead)
                 for a in node_h)
    st, stp = (torch.cat([t.to(mesh.lead) for t in x[0]])
               for x in (st_sh, stp_sh))
    ref = flat.ref_mesh[0][0].to(mesh.lead)
    N, P = (int(x) for x in st.shape)
    sweep = sweep_ops(st, stp, ref)
    shapes = {}
    for name, samples in (("batch", missing[:batch_size]),
                          ("pre_pass", missing)):
        slots = eng._pad_sparse([s.mutations for s in samples])
        sh = (st_sh, stp_sh, flat.ref_mesh,
              *(pmesh.put_batch(mesh, x) for x in slots))
        whole = (st, stp, ref,
                 *(torch.from_numpy(x).to(mesh.lead) for x in slots))
        t, _ = mesh_against_unsharded(kern, mesh, sh, node_sh, whole, node)
        bounds = score_bounds(N, P, slots[0], sweep)
        shapes[name] = dict(
            t, N=N, P=P, B=len(samples), K=int(slots[0].shape[1]),
            shard_NPB=[int(x) for x in (*st_sh[0][0].shape,
                                        sh[3][0][0].shape[0])],
            mesh_b1_bound=bounds["B1 fused"],
            b2_bound=bounds["B2 fused"])
        del sh, whole
    return shapes


def phase_mesh_realistic(kern, pb, reference, n_samples, batch_size, device):
    """n_samples new samples onto the realistic MAT with --mesh-devices 4,
    against the unsharded run on the same VCF (``mesh_reference``); then
    the mesh kernels against their plain twins at that run's shapes."""
    vcf, out_1 = reference["vcf"], reference["out"]
    wall_1, stages_1 = reference["wall"], reference["stages"]
    n_sites, mean_entries = reference["n_sites"], reference["mean_entries"]
    before = kern.counts()
    wall_m, stages_m, out_m = run_realistic_cli(
        pb, vcf, batch_size, "--mesh-devices", str(MESH_SHARDS),
        tag="mesh_on")
    after = kern.counts()
    launches = {k: after[k] - before[k] for k in after}
    same_files(out_m, out_1, zip(PLACE_FILES, PLACE_FILES))
    with open(os.path.join(out_m, "placement_stats.tsv")) as f:
        rows = [l for l in f.read().split("\n") if l]
    if len(rows) != n_samples:
        raise AssertionError(f"placement_stats.tsv has {len(rows)} rows")
    need = -(-n_samples // batch_size) * MESH_SHARDS
    if launches["B1"] != need or launches["B2"] != MESH_SHARDS:
        raise AssertionError(f"mesh launches {launches}: expected B1 "
                             f"{need} and B2 {MESH_SHARDS}")
    shapes = check_mesh_realistic(kern, pb, vcf, batch_size, device)
    torch.cuda.empty_cache()
    return {"vs_unsharded": "byte-identical " + ", ".join(PLACE_FILES),
            "samples": n_samples, "vcf_sites": n_sites,
            "mean_entries": mean_entries, "mesh_devices": MESH_SHARDS,
            "launches": launches, "main_shapes": shapes,
            "cli_seconds": wall_m, "unsharded_cli_seconds": wall_1,
            "stage_seconds": {k: round(v, 3) for k, v in stages_m.items()},
            "unsharded_stage_seconds": {k: round(v, 3)
                                        for k, v in stages_1.items()}}


# --- the BigMAT path ---------------------------------------------------------

@contextlib.contextmanager
def bigmat_devices(seen):
    """Record the device of every BigMAT the CLI builds."""
    from usher_tpu_torch.core.bigmat import BigMAT
    orig = BigMAT.from_tree.__func__

    def spy(cls, *a, **k):
        big = orig(cls, *a, **k)
        seen.append(big.device.type)
        return big

    BigMAT.from_tree = classmethod(spy)
    try:
        yield
    finally:
        BigMAT.from_tree = classmethod(orig)


def phase_bigmat_fixture():
    fx = os.path.join(REPO, "tests", "fixtures")
    out = os.path.join(WORK, "fixture_bigmat")
    seen = []
    with bigmat_devices(seen):
        run_cli(["-t", os.path.join(fx, "global_phylo.nh"),
                 "-v", os.path.join(fx, "global_samples.vcf"),
                 "-o", os.path.join(out, "out.pb"), "-d",
                 os.path.join(out, "b"), "--bigmat", "--mesh-devices", "0"])
        run_cli(["-i", os.path.join(out, "out.pb"),
                 "-v", os.path.join(fx, "new_samples.vcf"),
                 "-o", os.path.join(out, "out2.pb"), "-d",
                 os.path.join(out, "p"), "--bigmat", "--mesh-devices", "0"])
    same_files(os.path.join(out, "p"), GOLDENS, zip(PLACE_FILES, GOLDEN_FILES))
    if not seen or set(seen) != {"cuda"}:
        raise AssertionError(f"BigMATs built on {seen}, expected cuda")
    return {"goldens": "byte-identical", "bigmat_builds": len(seen),
            "bigmat_device": seen[0]}


def phase_bigmat_realistic(pb, vcf, dense_out, batch_size):
    seen = []
    with bigmat_devices(seen):
        wall, stages, out = run_realistic_cli(pb, vcf, batch_size,
                                              "--bigmat")
    same_files(out, dense_out, zip(PLACE_FILES, PLACE_FILES))
    if not seen or set(seen) != {"cuda"}:
        raise AssertionError(f"BigMATs built on {seen}, expected cuda")
    return {"vs_realistic_e2e": "byte-identical " + ", ".join(PLACE_FILES),
            "bigmat_builds": len(seen), "cli_seconds": wall,
            "stage_seconds": {k: round(v, 3) for k, v in stages.items()}}


def synth_bigmat(rng, N, P, n_mut=2, device=None):
    """bench.py's synth_bigmat recipe (random recursive tree, n_mut branch
    mutations at random columns per non-root node) with chain-consistent
    mutations: mut_par is the path state above the mutation (the mut of
    the nearest ancestor mutation in the same column, else ref), and mut
    is a different base.  Columns are distinct within a node."""
    from usher_tpu_torch.core.bigmat import BigMAT
    parent = np.zeros(N, dtype=np.int32)
    parent[1:] = (rng.random(N - 1) * np.arange(1, N)).astype(np.int32)
    M = n_mut * (N - 1)
    mut_ptr = np.zeros(N + 1, dtype=np.int64)
    mut_ptr[2:] = n_mut * np.arange(1, N, dtype=np.int64)
    col = rng.integers(0, P, size=(N - 1, n_mut))
    for j in range(1, n_mut):
        dup = (col[:, j:j + 1] == col[:, :j]).any(1)
        while dup.any():
            col[dup, j] = rng.integers(0, P, size=int(dup.sum()))
            dup = (col[:, j:j + 1] == col[:, :j]).any(1)
    mut_col = col.reshape(-1).astype(np.int32)
    shift = rng.integers(1, 4, size=M)
    ref = NIBBLES[rng.integers(0, 4, size=P)]
    positions = np.arange(P, dtype=np.int64)
    # DFS intervals of the topology: a BigMAT of it without mutations
    topo = BigMAT(parent, np.zeros(N + 1, np.int64), np.zeros(0, np.int32),
                  np.zeros(0, np.uint8), np.zeros(0, np.uint8), positions,
                  ref, device=device)
    node = 1 + np.arange(M) // n_mut
    d = topo.dfs_of[node].astype(np.int64)
    e = topo.dfs_end_of[node].astype(np.int64)
    del topo
    # sorted by (column, DFS row), a mutation's nearest same-column
    # ancestor is the previous mutation of its column or, when that one's
    # interval does not contain it, that one's own nearest ancestor
    # (pointer chasing until an interval contains it or none is left)
    order = np.lexsort((d, mut_col))
    c_s, d_s, e_s = mut_col[order], d[order], e[order]
    anc = np.arange(M) - 1
    anc[np.r_[True, c_s[1:] != c_s[:-1]]] = -1
    todo = np.nonzero(anc >= 0)[0]
    while len(todo):
        todo = todo[d_s[todo] >= e_s[anc[todo]]]
        anc[todo] = anc[anc[todo]]
        todo = todo[anc[todo] >= 0]
    depth = np.zeros(M, np.int64)
    while True:
        nd = np.where(anc >= 0, depth[np.maximum(anc, 0)] + 1, 0)
        if (nd == depth).all():
            break
        depth = nd
    par_s = np.empty(M, np.uint8)
    mut_s = np.empty(M, np.uint8)
    sh = shift[order]
    for lv in range(int(depth.max()) + 1):
        i = np.nonzero(depth == lv)[0]
        par_s[i] = ref[c_s[i]] if lv == 0 else mut_s[anc[i]]
        mut_s[i] = NIBBLES[(np.searchsorted(NIBBLES, par_s[i]) + sh[i]) % 4]
    mut_par = np.empty(M, np.uint8)
    mut_mut = np.empty(M, np.uint8)
    mut_par[order] = par_s
    mut_mut[order] = mut_s
    return BigMAT(parent, mut_ptr, mut_col, mut_par, mut_mut, positions, ref,
                  device=device)


def big_samples(rng, big, B, K, K_slots, n_new=4):
    """B samples near random nodes, as slot arrays [B, K_slots]: up to
    K - n_new of the node's non-reference path-state entries plus n_new
    new non-reference entries at other columns; the rest is padding."""
    pos = np.full((B, K_slots), big.P, np.int32)
    gval = np.zeros((B, K_slots), np.uint8)
    for b, x in enumerate(rng.integers(0, big.N, size=B).tolist()):
        state = {}
        while True:
            lo, hi = int(big.mut_ptr[x]), int(big.mut_ptr[x + 1])
            for c, v in zip(big.mut_col[lo:hi].tolist(),
                            big.mut_mut[lo:hi].tolist()):
                state.setdefault(c, v)
            p = int(big.parent[x])
            if p == x:
                break
            x = p
        ent = {c: v for c, v in state.items() if v != big.ref[c]}
        ent = dict(list(ent.items())[:K - n_new])
        while len(ent) < K:
            c = int(rng.integers(0, big.P))
            if c not in ent and c not in state:
                ent[c] = int(NIBBLES[(np.searchsorted(NIBBLES, big.ref[c])
                                      + int(rng.integers(1, 4))) % 4])
        pos[b, :K] = list(ent)
        gval[b, :K] = list(ent.values())
    return pos, gval, np.zeros((B, K_slots), dtype=bool)


def host_reduce(big, score_T, nc_T):
    """The host tie-break of BigPlacementEngine.score_samples over [N, B]
    score/num_common matrices, vectorized over samples: (best_score,
    best_slot, num_best, has_unique at the winner) [B]."""
    hu = nc_T < big.node_num_mut[:, None]
    ncp = nc_T > 0
    leaf = big.is_leaf[:, None]
    valid = ((big.is_root_mask[:, None] | (leaf & ncp) | (~leaf & hu & ncp)
              | (~leaf & ~hu)) & big.active[:, None])
    best = np.where(valid, score_T, 1 << 30).min(0)
    tied = valid & (score_T == best[None, :])
    num_best = tied.sum(0)
    leaves = np.where(tied, big.num_leaves[:, None], -1).max(0)
    tied &= big.num_leaves[:, None] == leaves[None, :]
    rank = np.where(tied, big.bfs_rank[:, None], -1).max(0)
    slot = np.argmax(tied & (big.bfs_rank[:, None] == rank[None, :]), axis=0)
    return best, slot, num_best, hu[slot, np.arange(len(slot))]


def same_arrays(what, got, want):
    for g, w in zip(got, want):
        if not np.array_equal(np.asarray(g), np.asarray(w)):
            raise AssertionError(f"{what}: outputs differ")


def phase_bigmat_pandemic(kern, device, n_nodes=1_000_000, n_sites=30_000):
    ps = kern.ps
    rng = np.random.default_rng(11)
    B, K, K_slots, B_x8, B_cols = 1024, 24, 32, 256, 64
    t0 = time.perf_counter()
    big = synth_bigmat(rng, n_nodes, n_sites, device=device)
    pos, gval, kmiss = big_samples(rng, big, B, K, K_slots)
    setup_s = time.perf_counter() - t0
    occ = np.diff(big.csc_ptr)

    # X5 on every sample; the first call uploads the CSC and epoch arrays
    t0 = time.perf_counter()
    res = big.place_arrays(pos, gval, kmiss)
    first_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    x5_ms = median_ms(lambda: big.place_arrays(pos, gval, kmiss), runs=3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # X8 on the first 256, reduced on the host with the engine's rules
    t0 = time.perf_counter()
    s_T, nc_T, _ = big.score_batch_T(pos[:B_x8], gval[:B_x8], kmiss[:B_x8])
    x8_s = time.perf_counter() - t0
    same_arrays("X5 vs X8 + host tie-break", [r[:B_x8] for r in res],
                host_reduce(big, s_T, nc_T))
    # the host engine on 4 samples
    for b in range(4):
        sl = slice(b, b + 1)
        if big.place_one_host(pos[sl], gval[sl], kmiss[sl]) != tuple(
                r[b].item() for r in res):
            raise AssertionError(f"place_one_host disagrees on sample {b}")
    # the column path (B1-spr kernel) against the interval engine
    p64, g64, k64 = pos[:B_cols], gval[:B_cols], kmiss[:B_cols]
    t0 = time.perf_counter()
    c_T = big.score_batch_T_cols(p64, g64, k64)
    cols_s = time.perf_counter() - t0
    same_arrays("score_batch_T_cols vs score_batch_T", c_T[:2],
                (s_T[:, :B_cols], nc_T[:, :B_cols]))
    g_spr = g64.copy()
    g_spr[:, :K] = rng.integers(1, 16, size=(B_cols, K), dtype=np.uint8)
    t0 = time.perf_counter()
    spr_iv = big.score_spr_T(p64, g_spr)
    spr_x8_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    spr_cols = big.score_spr_T_cols(p64, g_spr)
    spr_cols_s = time.perf_counter() - t0
    same_arrays("score_spr_T_cols vs score_spr_T", spr_cols, spr_iv)
    launches = kern.counts()          # end of the BigMAT path's window
    # the batch mesh: the sample axis split over 4 shards, against the
    # unsharded calls above on the same 256 samples
    from usher_tpu_torch.parallel.shard import batch_mesh
    big.mesh = batch_mesh(MESH_SHARDS, device=device)
    t0 = time.perf_counter()
    sm_T, ncm_T, _ = big.score_batch_T(pos[:B_x8], gval[:B_x8], kmiss[:B_x8])
    mesh_x8_s = time.perf_counter() - t0
    same_arrays("score_batch_T under a batch mesh", (sm_T, ncm_T),
                (s_T, nc_T))
    del sm_T, ncm_T
    t0 = time.perf_counter()
    res_m = big.place_arrays(pos[:B_x8], gval[:B_x8], kmiss[:B_x8])
    mesh_place_s = time.perf_counter() - t0
    same_arrays("place_arrays under a batch mesh", res_m,
                [r[:B_x8] for r in res])
    big.mesh = None
    if launches["B1-spr"] < 1 or launches["B1"] < 1:
        raise AssertionError(f"column path launches {launches}: expected "
                             "B1 (spr=False) and B1-spr >= 1")
    del s_T, nc_T, c_T, spr_iv, spr_cols

    # the kernel at the column path's own shape against its plain twin
    cols = np.unique(p64[p64 < big.P])
    shape = {}
    for spr, g in ((True, g_spr), (False, g64)):
        args = big._cols_inputs(p64, g, k64, cols, spr)
        st_c, stp_c = ps.cols_states(*args[:5])
        b1 = (st_c, stp_c, args[4], *args[5:])
        name = "B1-spr" if spr else "B1"
        kern.err[name] = max(kern.err[name], max_abs_err(
            ps.score_entries_T(*b1, spr=spr),
            ps.score_entries_T_plain(*b1, spr=spr)))
        torch.cuda.synchronize()
        if spr:
            kern.ms["bigmat_pandemic"] = {"B1-spr": (
                median_ms(lambda: ps.score_entries_T(*b1, spr=True)),
                median_ms(lambda: ps.score_entries_T_plain(*b1, spr=True)))}
            shape = {"N": int(st_c.shape[0]), "C": int(st_c.shape[1]),
                     "B": B_cols, "K": K_slots}
            kern.bounds["bigmat_pandemic"] = score_bounds(
                shape["N"], shape["C"], args[7].cpu().numpy())["B1"]
            # both modes at this shape on multi-base path states, where
            # they must part (the tree's own states are single bases)
            del stp_c
            st_a, stp_a = ambiguous_states(st_c, args[2], args[3], 7)
            del st_c
            kern.compare_b1((st_a, stp_a, *b1[2:]), ambiguous=True)
            del st_a, stp_a
        else:
            del st_c, stp_c
        del b1, args
    torch.cuda.empty_cache()
    ms, plain_ms = kern.ms["bigmat_pandemic"]["B1-spr"]
    return {"N": big.N, "P": big.P, "mutations": int(len(big.mut_col)),
            "max_depth": big.max_depth, "max_occupancy": int(occ.max()),
            "B": B, "K": K, "K_slots": K_slots, "setup_s": setup_s,
            "place_arrays_first_s": first_s,
            "place_arrays_ms_per_1024": x5_ms, "place_arrays_peak_gb": peak_gb,
            "x8_score_batch_T_256_s": x8_s,
            "cols_score_batch_T_cols_64_s": cols_s,
            "x8_score_spr_T_64_s": spr_x8_s,
            "cols_score_spr_T_cols_64_s": spr_cols_s,
            "mesh4_score_batch_T_256_s": mesh_x8_s,
            "mesh4_place_arrays_256_s": mesh_place_s,
            "checks": "X5 == X8 + host tie-break (256), == place_one_host "
                      "(4); cols == interval (64, both modes); batch mesh "
                      "of 4 == unsharded (256, scores and placements)",
            "launches": launches, "b1_spr_shape": shape,
            "b1_spr_ms": ms, "b1_spr_plain_ms": plain_ms,
            "b1_spr_bound": kern.bounds["bigmat_pandemic"],
            "max_abs_err": {"B1-spr": kern.err["B1-spr"],
                            "B1": kern.err["B1"]}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from usher_tpu_torch.ops import _build
    from usher_tpu_torch.ops import placement_sparse as ps
    from usher_tpu_torch.parallel import mesh as pmesh
    from usher_tpu_torch.utils.device import apply_platform_env

    os.environ["USHER_TPU_PLATFORM"] = "cuda"
    device = apply_platform_env()
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.load_library()
    log(f"build: {time.perf_counter() - t0:.3f} s ({_build.library_path()})")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    kern = Kernels(ps, pmesh)
    results = {}

    def phase(name, fn, *a):
        t = time.perf_counter()
        res = fn(*a)
        torch.cuda.synchronize()
        res = dict(res, seconds=round(time.perf_counter() - t, 3))
        results[name] = res
        log(f"phase {name}: {json.dumps(res)}")
        return res

    phase("kernel_small", phase_kernel_small, kern, device)
    rng = np.random.default_rng(1)
    head = synth_mat(rng, 100_000, 512)
    phase("kernel_headline", phase_kernel_synth, kern, "kernel_headline",
          head, 1024, 16, 2, device)
    del head
    genome = synth_mat(np.random.default_rng(3), 100_000, 30_000)
    phase("kernel_genome", phase_kernel_synth, kern, "kernel_genome",
          genome, 1024, 32, 4, device)
    phase("mesh_kernel", phase_mesh_kernel, kern, genome, 1024, 32, 4, device)

    # set-up of the realistic run (tree, pb, VCF) before the main path
    T, pb, vcf, setup = realistic_setup(genome, 1024, 5)
    log(f"realistic setup: {json.dumps(setup)}")

    # --- the dense main path: the counters cover exactly these CLI runs --
    kern.reset_counts()
    phase("fixture_e2e", phase_fixture_e2e, kern)
    wall, stages, out_dir = run_realistic_cli(pb, vcf, 64)
    counts = kern.counts()
    # ----------------------------------------------------------------------

    def realistic():
        res = check_realistic(kern, T, vcf, out_dir, 1024, device, 64)
        return dict(res, cli_seconds=wall, launches=counts, setup=setup,
                    stage_seconds={k: round(v, 3) for k, v in stages.items()})

    phase("realistic_e2e", realistic)
    del T

    # --- the mesh path: the counters cover the sharded CLI runs; the -------
    # --- unsharded run they are held against comes before the window, and --
    # --- mesh_realistic reads them before it compares kernels --------------
    reference = mesh_reference(genome, pb, 256, 64, 6)
    del genome
    kern.reset_counts()
    mesh_fixture = phase("mesh_fixture", phase_mesh_fixture, kern,
                         os.path.join(WORK, "fixture", "out.pb"))
    mesh_real = phase("mesh_realistic", phase_mesh_realistic, kern, pb,
                      reference, 256, 64, device)
    mesh_counts = {k: mesh_fixture["launches"][k] + mesh_real["launches"][k]
                   for k in mesh_real["launches"]}
    # ----------------------------------------------------------------------

    # --- the BigMAT path: the counters cover these CLI runs and the ------
    # --- pandemic phase's scoring calls (read inside that phase) ---------
    kern.reset_counts()
    phase("bigmat_fixture", phase_bigmat_fixture)
    phase("bigmat_realistic", phase_bigmat_realistic, pb, vcf, out_dir, 64)
    pandemic = phase("bigmat_pandemic", phase_bigmat_pandemic, kern, device)
    big_counts = pandemic["launches"]
    # ----------------------------------------------------------------------

    for banned in ("jax", "jaxlib", "usher_tpu"):
        if any(m == banned or m.startswith(banned + ".")
               for m in sys.modules):
            raise AssertionError(f"{banned} was imported")
    # the main paths make the launches they always made, all of them fused:
    # the dense path 5 fixture + 16 realistic batches and one pre-pass, the
    # mesh path 20 fixture + 16 realistic shard launches and 4 pre-pass ones
    for what, got, want in (("dense", counts, {"B1": 21, "B2": 1}),
                            ("mesh", mesh_counts, {"B1": 36, "B2": 4})):
        if any(got[k] != v for k, v in want.items()) or got["row_reductions"]:
            raise AssertionError(f"{what} path: launches {got}, expected "
                                 f"{want} and no call of row_reductions")
    main_shapes = results["realistic_e2e"]["main_shapes"]
    log("parent_states at the main-path shape: "
        f"{main_shapes['parent_states_ms']:.3f} ms")
    genome_ms = kern.ms["kernel_genome"]
    genome_bound = kern.bounds["kernel_genome"]
    mesh_ms = kern.ms["mesh_kernel"]
    src = "usher_tpu_torch/csrc/placement_sparse.cu"

    def entry(name, replaces, launches, err, ms, plain_ms, bnd, **more):
        # library_ms is null throughout: no single PyTorch call computes
        # the sparse placement score or its tie-broken argmin
        return dict(name=name, route="cuda", source=src, replaces=replaces,
                    launches=launches, max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=bnd["bound_ms"],
                    bound_by=bnd["bound_by"], library_ms=None,
                    bytes_ms=bnd["bytes_ms"], ops_ms=bnd["ops_ms"], **more)

    def fused(name):
        """fused_ms, fused_bound_ms and the main-path shape's numbers."""
        main = main_shapes[name]
        return dict(fused_ms=genome_ms[name + " fused"][0],
                    fused_bound_ms=genome_bound[name + " fused"]["bound_ms"],
                    fused_max_abs_err=kern.err[name + " fused"],
                    main_path=dict(main, bound_ms=main["bound"]["bound_ms"],
                                   fused_bound_ms=main["fused_bound"][
                                       "bound_ms"]))

    kernels = [
        entry("B1 score_entries_T",
              "usher_tpu/ops/placement_pallas.py:176", counts["B1"],
              max(kern.err["B1"], kern.err["B1 fused"]), *genome_ms["B1"],
              genome_bound["B1"], shape="kernel_genome", **fused("B1")),
        entry("B2 placement_reduce",
              "usher_tpu/ops/placement_pallas.py:119", counts["B2"],
              max(kern.err["B2"], kern.err["B2 fused"]), *genome_ms["B2"],
              genome_bound["B2"], shape="kernel_genome",
              mesh_path_launches=mesh_counts["B2"], **fused("B2")),
        entry("B1-spr score_cols_T",
              "usher_tpu/ops/placement_pallas.py:416", big_counts["B1-spr"],
              kern.err["B1-spr"], pandemic["b1_spr_ms"],
              pandemic["b1_spr_plain_ms"], pandemic["b1_spr_bound"],
              shape="bigmat_pandemic column path"),
        entry("mesh B1 sharded_sparse_score_fn",
              "usher_tpu/parallel/mesh.py:112", mesh_counts["B1"],
              kern.err["mesh B1"], mesh_ms["mesh_b1_ms"],
              mesh_ms["mesh_b1_plain_ms"],
              kern.bounds["mesh_kernel"]["B1 fused"],
              shape="mesh_kernel (2 x 2 shards, one fused launch a shard; "
                    "the bound is the unsharded fused call's)",
              main_shapes=mesh_real["main_shapes"],
              wrapper="usher_tpu_torch/parallel/mesh.py"),
        entry("B1-3d score_entries_3d",
              "usher_tpu/ops/placement_pallas.py:300",
              counts["B1-3d"] + mesh_counts["B1-3d"] + big_counts["B1-3d"],
              kern.err["B1-3d"], *genome_ms["B1-3d"], genome_bound["B1"],
              shape="kernel_genome",
              note="no caller on any path, as in the JAX package"),
    ]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
