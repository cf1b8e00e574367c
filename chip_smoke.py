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
  native           the compiled host scanners (usher_tpu_torch/native/src/
                   usher_native.cpp) built with g++ at their first use,
                   timed; on the realistic pb and VCF and on the fixture:
                   pb_to_arrays, newick_to_arrays, load_mat_arrays,
                   parse_vcf, parse_vcf_mt, read_vcf_sites and the
                   transposed codec (bytes, round trip) == the pure-Python
                   scanners, both sides timed; every later CLI reads
                   through the compiled scanner
  kernel_wide      B1 and B2 (and B1-spr, B1-3d), fused and with given row
                   sums, at position widths whose rows the launch plan cuts
                   into column segments: 131,072, 240,000 and 100,003 (no
                   multiple of 16: the threads copy the segments) on 20,000
                   rows, 256 samples of 24 entries in 32 slots, against the
                   plain twins, with ms, plain ms, bound and segment count
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
  direct_fixture   --pb-direct (placement/direct.py, no host Tree) on the
                   pb fixture_e2e built: the goldens; with -u -o, byte-equal
                   to --bigmat -u -o (uncondensed tree and saved pb),
                   unsharded and with --mesh-devices 4
  direct_realistic the realistic pb and 1,024 samples through --pb-direct -s
                   --batch-size 64, synchronous, with
                   USHER_TPU_DIRECT_PIPE=1 and, synchronous again, with
                   USHER_TPU_SEG=1 (scoring through X9, its calls counted):
                   byte-identical to realistic_e2e;
                   per mode the CLI wall, set-up (pb parse, VCF, BigMAT
                   build), place_all and where its time goes (sort
                   pre-pass, device scoring calls, host corrections,
                   surgery, newick), samples/s, the full host re-score
                   count and the peak device memory
  optimize_fixture matOptimize -N 2 -r 4 (usher_tpu_torch/cli/
                   matoptimize_cli.py) on the pb fixture_e2e built, dense,
                   --spr-backend big, --stream-states, --mesh-devices 4 and
                   big with --mesh-devices 4, and -E, on the card and, in a
                   subprocess, with USHER_TPU_PLATFORM=cpu: every output pb,
                   the EPP newick and epps_dump byte-equal; parsimony 500 ->
                   at most 494; X3, X11, X12 and X7 (both of its paths and
                   the mesh) ran on cuda
  optimize_realistic
                   matOptimize -N 1 -r 4 -z 0.002 -y 0 (~200 sources) on
                   the realistic pb, dense and --spr-backend big (the
                   streamed run is left out for time): byte-equal pbs;
                   per mode the CLI wall, the optimizer's spans
                   (initial FS pass, find_moves, FS patch, final min-back
                   pass), each program's ms a call (X3 a 512-position chunk,
                   X11 and X7 a source chunk), the chunks X7 took on the
                   device and on host events, and the peak device memory
  optimize_pandemic
                   bench.py's pandemic_optimize shape on bigmat_pandemic's
                   1M-node BigMAT: 2,048 sources, chunks of 512, radius 8,
                   K 32 through X7's device expansion (interval_spr_dev),
                   == X7 on host events on the card (every source) == a
                   CPU-tensor run (the first 16); ms a chunk, source nodes
                   searched a minute, peak device memory
  sampled_fixture  usher-sampled (usher_tpu_torch/cli/usher_sampled_cli.py)
                   on the fixture, on the card and in a CPU subprocess:
                   VCF with -B, --diff, -A -k -K, -M 2, --bigmat -s,
                   --mesh-devices 4 -s, and a pruned tree whose 85 new
                   samples fill more than a chunk, so the interleaved
                   optimization runs (and a final round): every output
                   file byte-equal between card and CPU
  sampled_realistic
                   usher-sampled -s on the realistic pb (the tree is not
                   cut) with the first 256 of its 1,024 samples, dense and
                   --bigmat: byte-equal files; walls, spans, score_samples
                   calls, stale retries, peak device memory
  server_realistic usher_server --once with the realistic pb pre-loaded
                   and two argument files of 64 samples (the second with
                   -s, B2), each == the usher CLI's files; the socket
                   server with two identical 64-sample requests and a
                   FIFO stop: equal replies and files, equal to
                   usher-sampled's on those samples; each request's wall
                   and the device memory after it (the second request's
                   peak within 5% of the first's)
  matutils_fixture every matUtils invocation of the port's CPU tests
                   (tests/matutils_cases.py: each subcommand, with
                   --pb-direct where it has one, the summary and extract
                   goldens) on the card and in a CPU subprocess: exit
                   codes, stdout and every file byte-equal; the goldens and
                   the Tree == --pb-direct pairs hold on the card
  matutils_realistic
                   matUtils on the realistic pb: uncertainty -e -o on 1,024
                   leaves by the Tree path (16 B1 launches) and by
                   --pb-direct with USHER_TPU_GROUPED=1 (X6) and =0 (X5),
                   byte-equal; annotate -c with 8 clades of its own
                   subtrees; merge of the two trees usher --pb-direct makes
                   of samples 0-255 and 256-511, Tree path == --pb-direct;
                   per run its wall, launches, X6/X5 calls, host share and
                   peak device memory
  grouped_pandemic bench.py's replace_1m_grouped shape: a lineage-
                   structured 1,000,000-node x 30,000-site BigMAT, 1,024 of
                   its leaves in chunks of 512 and of 1,024:
                   place_arrays_grouped (X6) == place_arrays (X5) on the
                   full ancestral sets, ms a chunk of each, host grouping
                   seconds, peak device memory, and at 1,024 where one
                   call of each spends its device time (torch.profiler)
  seg_pandemic     X9 (ops/interval.py::interval_place_seg_dev, place_arrays
                   under USHER_TPU_SEG=1) against X5 on bigmat_pandemic's
                   1M-node BigMAT (after optimize_pandemic, which cannot
                   take the overlay this phase appends): 1,024 samples of
                   24 entries in 32 slots, every output field equal without
                   and with the runner-up, again after an overlay append of
                   256 samples at their placements; ms a call and peak
                   device memory of each, ecap and the true pair bound, the
                   device ms by op of one X9 call
  ripples_fixture  ripples (X13 on the card) on tests/test_ripples.py's two
                   trees and on the fixture pb (the defaults, -n 1 -l 2,
                   -S/-E halves, -s), ripplesInit, ripplesUtils and
                   ripples-filter on them, transpose_vcf (round trip),
                   compareVCF and check_samples_place on the fixture VCF and
                   pbs, all through the dispatcher (python -m
                   usher_tpu_torch <tool>), on the card and in a
                   USHER_TPU_PLATFORM=cpu subprocess: exit codes, stdout,
                   stderr and every file byte-equal; R found, the clean tree
                   quiet, the halves the whole
  ripples_realistic
                   ripples on the realistic pb at full width: -s with 4
                   recombinant leaves planted under the root (each a donor
                   clade's path genotype below position 15,000 and a
                   disjoint acceptor clade's above), every one reported with
                   an improvement of 3 or more; -S 0 -E 32 (a fleet
                   worker's share) == -S 0 -E 16 then -S 16 -E 32; X13 ==
                   _cost_matrix_plain on the card for each candidate of the
                   -S 0 -E 16 run; ripples-filter on the -s run; per run
                   the wall, candidates, X13 ms a candidate, bytes to the
                   host a candidate, host share and peak device memory

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
column path), and the --pb-direct path (direct_fixture and direct_realistic),
which must launch neither B1 nor B2, and the matOptimize path
(optimize_fixture, optimize_realistic and optimize_pandemic), whose device
programs are torch ops and which must launch none of the five, the
usher-sampled path (sampled_fixture and sampled_realistic), whose B1
launches must equal its PlacementEngine.score_samples calls (one a shard
under a mesh), the two servers (server_realistic, a window each:
usher_server's -s request must launch B2), the matUtils path
(matutils_fixture and matutils_realistic), whose B1 launches must equal its
PlacementEngine.score_samples calls, and the RIPPLES, X9 and tools paths
(seg_pandemic, the X9 run of direct_realistic, ripples_fixture and
ripples_realistic), whose device programs are torch ops and which must
launch none of the five (ripples_path_launches in the kernels line).  The scanner phase launches
nothing.  B1-3d has
no caller on any path (its TPU counterpart has
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


def score_bounds_3d(N, P, pos, tb):
    """Bound of B1-3d: B1's inputs and work with caller-given row sums,
    its two outputs written as ceil(B / tb) tiles of [N, tb] int32 (the
    last tile's padding samples count as written)."""
    B, K = pos.shape
    valid = int(((pos >= 0) & (pos < P)).sum())
    read = 2 * N * P + 4 * 7 * -(-K // 4) * B + 4 * B + 8 * N
    tiles = -(-B // tb) * tb
    return bound(read + 8 * N * tiles, N * valid * OPS_PER_TRIPLE + 2 * N * B)


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
        pos = b1[5].cpu().numpy()
        self.bounds[phase] = dict(score_bounds(N, P, pos, sweep_ops(*b1[:3])),
                                  **{"B1-3d": score_bounds_3d(N, P, pos, tb)})
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
            "B1_3d_bound": bounds["B1-3d"],
            "B1_fused_bound": bounds["B1 fused"],
            "B2_fused_bound": bounds["B2 fused"],
            "sweep_executed_ms": t["sweep_executed_ms"]}


WIDE_WIDTHS = (131_072, 240_000, 100_003)


def wide_inputs(rng, N, P, B, K, device):
    """Tree-like states at a wide position axis, made on the card: ref in
    every row, a few random branch mutations a row, stp = st[parent] of a
    random recursive parent array; B samples of K - 8 entries (one in eight
    missing) in K slots; node metadata with inactive rows."""
    g = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 31)))
    ref_h = NIBBLES[rng.integers(0, 4, size=P)]
    ref = torch.from_numpy(ref_h).to(device)
    st = ref[None, :].repeat(N, 1)
    n_mut = 4 * N
    rows = torch.randint(0, N, (n_mut,), generator=g, device=device)
    cols = torch.randint(0, P, (n_mut,), generator=g, device=device)
    st[rows, cols] = torch.from_numpy(NIBBLES).to(device)[
        torch.randint(0, 4, (n_mut,), generator=g, device=device)]
    parent = (torch.rand(N, generator=g, device=device)
              * torch.arange(N, device=device)).long()
    stp = st[parent]
    pos_h, gval_h, kmiss_h = synth_slots(rng, ref_h, B, K - 8)
    kmiss_h[:, ::8] = True
    gval_h[kmiss_h] = 15
    pad = np.full((B, 8), P, dtype=np.int32)
    pos, gval, kmiss = (torch.from_numpy(np.ascontiguousarray(x)).to(device)
                        for x in (np.concatenate([pos_h, pad], 1),
                                  np.pad(gval_h, ((0, 0), (0, 8))),
                                  np.pad(kmiss_h, ((0, 0), (0, 8)))))
    node = ((torch.rand(N, generator=g, device=device) < 0.95),
            torch.rand(N, generator=g, device=device) < 0.5,
            torch.arange(N, device=device) == 0,
            torch.randint(1, 100, (N,), generator=g, device=device,
                          dtype=torch.int32),
            torch.arange(N, dtype=torch.int32, device=device))
    return st, stp, ref, node, pos, gval, kmiss


def phase_kernel_wide(kern, device, N=20_000, B=256, K=32):
    """B1 and B2 (and B1-spr, B1-3d) at position widths whose rows do not
    fit a ring stage, so that the plans cut them into column segments:
    131,072 (aligned, above both one-row limits), 240,000 (above the
    232,448 columns one packed row fills) and 100,003 (no multiple of 16:
    the threads copy the segments).  Each with caller-given row sums and
    fused, against the plain twins, exactly; the median ms of 3 calls."""
    ps = kern.ps
    rng = np.random.default_rng(11)
    out = {}
    for P in WIDE_WIDTHS:
        st, stp, ref, node, pos, gval, kmiss = wide_inputs(rng, N, P, B, K,
                                                           device)
        limits = ps.device_limits(device.index or 0)
        plans = {name: ps.launch_plan(P, B, K, fused, P % 16 == 0, b2, limits)
                 for name, fused, b2 in (("B1", False, False),
                                         ("B1 fused", True, False),
                                         ("B2", False, True),
                                         ("B2 fused", True, True))}
        if any(pl.segments(P) < 2 for n, pl in plans.items() if "fused" in n):
            raise AssertionError(f"P={P}: a fused plan of one segment "
                                 f"{plans}")
        b1, b2 = kern.compare(st, stp, ref, node, pos, gval, kmiss)
        f1, f2 = kern.fused_args(b1, b2)
        bounds = score_bounds(N, P, pos.cpu().numpy(), sweep_ops(st, stp, ref))
        t = {"B1": (lambda: ps.score_entries_T(*b1),
                    lambda: ps.score_entries_T_plain(*b1)),
             "B1 fused": (lambda: ps.score_sparse_stp_T(*f1),
                          lambda: ps.score_sparse_stp_T_plain(*f1)),
             "B2": (lambda: ps.placement_reduce(*b2),
                    lambda: ps.placement_reduce_plain(*b2)),
             "B2 fused": (lambda: ps.placement_reduce(*f2), None)}
        out[str(P)] = {
            name: {"ms": median_ms(fn, runs=3),
                   "plain_ms": median_ms(plain, runs=3) if plain else None,
                   "bound": bounds[name], "segments": plans[name].segments(P),
                   "seg": plans[name].seg, "vec": plans[name].vec}
            for name, (fn, plain) in t.items()}
        del st, stp, ref, node, pos, gval, kmiss, b1, b2, f1, f2
        torch.cuda.empty_cache()
    return {"N": N, "B": B, "K": K, "widths": list(WIDE_WIDTHS),
            "max_abs_err": dict(kern.err), "by_width": out}


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
        reductions=reductions_bound(N, P),
        one_shard_B1=score_bounds(s00[0].shape[0], P,
                                  s00[3].cpu().numpy())["B1"])
    shard_shape = [int(x) for x in (*s00[0].shape, s00[3].shape[0])]
    devices = sorted({str(d) for d in mesh.devices.reshape(-1).tolist()})
    del whole, sh, b1, b2, shard_b1, s00
    torch.cuda.empty_cache()
    return dict(t, N=N, P=P, B=n_samples, K=n_entries,
                mesh=mesh.shape, devices=devices, shard_NPB=shard_shape,
                mesh_b1_bound=kern.bounds["mesh_kernel"]["B1 fused"],
                one_shard_b1_bound=kern.bounds["mesh_kernel"]["one_shard_B1"],
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


# --- the no-Tree serving path (--pb-direct) ---------------------------------

@contextlib.contextmanager
def direct_spies(seen, times):
    """Record the device of every BigMAT built while the CLI runs, and
    time, from outside the package, the library calls of a --pb-direct
    run (seconds by key; a call inside another call of the same key counts
    once): DirectPlacer's set-up and within it the pb parse, the VCF read,
    the BigMAT build and its rank recomputation; place_all and within it
    the sort pre-pass, the device scoring calls (place_arrays_begin, and
    place_arrays_finish, which waits for the device), the host corrections
    (_BatchState.resolve), the surgery (apply_placement) and the newick
    writer."""
    from usher_tpu_torch.core.bigmat import BigMAT
    from usher_tpu_torch.placement import direct
    spied = [(direct, "load_mat_arrays", "load_mat_arrays_s"),
             (direct, "read_vcf_sites", "read_vcf_s"),
             (BigMAT, "__init__", "bigmat_init_s"),
             (BigMAT, "_recompute_ranks", "ranks_s"),
             (direct.DirectPlacer, "__init__", "placer_init_s"),
             (direct.DirectPlacer, "place_all", "place_all_s"),
             (direct.DirectPlacer, "_sorted_indexes", "sort_prepass_s"),
             (BigMAT, "place_arrays_begin", "scoring_begin_s"),
             (BigMAT, "place_arrays_finish", "scoring_finish_s"),
             (direct._BatchState, "resolve", "resolve_s"),
             (direct.DirectPlacer, "apply_placement", "apply_s"),
             (direct.DirectPlacer, "write_newick", "write_newick_s")]
    orig = [getattr(owner, name) for owner, name, _ in spied]
    depth = {}

    def timed(key, fn):
        def run(*a, **k):
            depth[key] = depth.get(key, 0) + 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                depth[key] -= 1
                if not depth[key]:
                    times[key] = (times.get(key, 0.0)
                                  + time.perf_counter() - t0)
        return run

    def init(self, *a, **k):
        orig[2](self, *a, **k)
        seen.append(self.device.type)

    for (owner, name, key), fn in zip(spied, orig):
        setattr(owner, name, timed(key, init if fn is orig[2] else fn))
    try:
        yield
    finally:
        for (owner, name, _), fn in zip(spied, orig):
            setattr(owner, name, fn)


@contextlib.contextmanager
def patched_env(env):
    """os.environ with the variables of `env` set, restored on exit."""
    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_direct(argv, env=None):
    """The CLI with --pb-direct under direct_spies and with its standard
    error captured (and passed on): (wall s, library-call seconds, BigMAT
    devices, full host re-score count, stderr text)."""
    import io
    seen, times = [], {}
    buf = io.StringIO()
    t0 = time.perf_counter()
    with patched_env(env), direct_spies(seen, times), \
            contextlib.redirect_stderr(buf):
        run_cli([*argv, "--pb-direct"])
    wall = time.perf_counter() - t0
    err = buf.getvalue()
    sys.stderr.write(err[-2000:])
    rescores = [l for l in err.splitlines() if l.startswith("[direct] ")]
    if not rescores:
        raise AssertionError("--pb-direct printed no re-score count")
    if not seen or set(seen) != {"cuda"}:
        raise AssertionError(f"BigMATs built on {seen}, expected cuda")
    return wall, times, seen, int(rescores[-1].split()[1]), rescores[-1]


def phase_direct_fixture(kern, built_pb):
    """--pb-direct on the pb that fixture_e2e built: the goldens; then -u
    -o against --bigmat -u -o (the uncondensed tree and the re-condensed
    pb byte for byte), unsharded and with --mesh-devices 4."""
    fx = os.path.join(REPO, "tests", "fixtures")
    out = os.path.join(WORK, "fixture_direct")
    vcf = os.path.join(fx, "new_samples.vcf")
    before = kern.counts()
    run_direct(["-i", built_pb, "-v", vcf, "-d", os.path.join(out, "p"),
                "--mesh-devices", "0"])
    same_files(os.path.join(out, "p"), GOLDENS, zip(PLACE_FILES, GOLDEN_FILES))
    run_cli(["-i", built_pb, "-v", vcf, "-d", os.path.join(out, "bigmat"),
             "-u", "-o", os.path.join(out, "bigmat", "o.pb"), "--bigmat",
             "--mesh-devices", "0"])
    builds = 0
    for tag, mesh in (("direct", "0"), ("direct_mesh", str(MESH_SHARDS))):
        _, _, seen, _, _ = run_direct([
            "-i", built_pb, "-v", vcf, "-d", os.path.join(out, tag), "-u",
            "-o", os.path.join(out, tag, "o.pb"), "--mesh-devices", mesh])
        builds += len(seen)
        same_files(os.path.join(out, tag), os.path.join(out, "bigmat"),
                   [(f, f) for f in ("uncondensed-final-tree.nh", "o.pb",
                                     "placement_stats.tsv",
                                     "mutation-paths.txt")])
    after = kern.counts()
    launches = {k: after[k] - before[k] for k in after}
    if launches["B1"] or launches["B2"]:
        raise AssertionError(f"--pb-direct launched {launches}")
    return {"goldens": "byte-identical",
            "vs_bigmat_u_o": "byte-identical uncondensed-final-tree.nh and "
                             "pb, unsharded and --mesh-devices "
                             f"{MESH_SHARDS}",
            "bigmat_builds": builds, "bigmat_device": "cuda",
            "launches": launches}


def phase_direct_realistic(kern, pb, vcf, dense_out, n_samples, batch_size):
    """The realistic pb and its samples through --pb-direct -s, in the
    synchronous order and with USHER_TPU_DIRECT_PIPE=1 (the next batch's
    scoring enqueued before this batch's host corrections): both must
    write realistic_e2e's placement_stats.tsv, final-tree.nh and
    mutation-paths.txt.  Then once more synchronously with USHER_TPU_SEG=1
    (the scoring calls through X9, counted from outside): the same files.
    Per mode: the CLI wall, the pb load and BigMAT build, place_all,
    samples/s, full host re-scores and the peak device memory; the window
    launches no B1 and no B2, and the X9 run none of the five kernels."""
    before = kern.counts()
    modes = {}
    for mode, env in (("sync", None),
                      ("pipelined", {"USHER_TPU_DIRECT_PIPE": "1"}),
                      ("seg", {"USHER_TPU_SEG": "1"})):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = os.path.join(WORK, "realistic", f"direct_{mode}")
        calls, k0 = [], kern.counts()
        with seg_spy(calls):
            wall, times, seen, rescores, line = run_direct(
                ["-i", pb, "-v", vcf, "-d", out, "-s", "--batch-size",
                 str(batch_size), "--mesh-devices", "0"], env)
        peak = torch.cuda.max_memory_allocated()
        k1 = kern.counts()
        same_files(out, dense_out, zip(PLACE_FILES, PLACE_FILES))
        if bool(calls) != (mode == "seg"):
            raise AssertionError(f"--pb-direct {mode}: {len(calls)} X9 "
                                 "calls")
        modes[mode] = dict(
            cli_seconds=wall, seconds=times,
            samples_per_s=n_samples / times["place_all_s"],
            full_host_rescores=rescores, rescore_line=line,
            peak_device_bytes=peak, bigmat_builds=len(seen))
        if mode == "seg":
            same_files(out, os.path.join(WORK, "realistic", "direct_sync"),
                       zip(PLACE_FILES, PLACE_FILES))
            modes[mode].update(x9_calls=len(calls), launches={
                k: k1[k] - k0[k] for k in k1})
    after = kern.counts()
    launches = {k: after[k] - before[k] for k in after}
    if launches["B1"] or launches["B2"]:
        raise AssertionError(f"--pb-direct launched {launches}")
    return {"vs_realistic_e2e": "byte-identical " + ", ".join(PLACE_FILES)
            + " (sync, pipelined and USHER_TPU_SEG=1)", "samples": n_samples,
            "batch_size": batch_size, "launches": launches,
            "place_all_s": {m: modes[m]["seconds"]["place_all_s"]
                            for m in modes}, **modes}


def synth_bigmat(rng, N, P, n_mut=2, device=None):
    """bench.py's synth_bigmat recipe (random recursive tree, n_mut branch
    mutations at random columns per non-root node) with chain-consistent
    mutations: mut_par is the path state above the mutation (the mut of
    the nearest ancestor mutation in the same column, else ref), and mut
    is a different base.  Columns are distinct within a node."""
    parent = np.zeros(N, dtype=np.int32)
    parent[1:] = (rng.random(N - 1) * np.arange(1, N)).astype(np.int32)
    return chain_bigmat(rng, parent, P, n_mut, device)


def chain_bigmat(rng, parent, P, n_mut, device):
    """A BigMAT over the topology `parent` (parents before children) with
    n_mut chain-consistent branch mutations at distinct random columns a
    non-root node (synth_bigmat's recipe)."""
    from usher_tpu_torch.core.bigmat import BigMAT
    N = len(parent)
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


def phase_bigmat_pandemic(kern, device, keep, n_nodes=1_000_000,
                          n_sites=30_000):
    """The phase of the module docstring; leaves its BigMAT in keep["big"]
    for optimize_pandemic."""
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
    keep["big"] = big
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


# --- matOptimize (optimize/, cli/matoptimize_cli.py) -----------------------

# (module, function, name, the argument whose shape is recorded: the leaf
# masks [N, S] of X3, the subtree masks g [B, P] of X11 and X12, the entry
# slots pos [B, K] of X7's device path, add0 [B] of its host path)
OPT_PROGRAMS = (("fitch", "_fs_chunk", "X3", 0),
                ("fitch", "_min_back_chunk", "X3 min-back", 0),
                ("spr", "_score_moves", "X11", 4),
                ("epp", "_tie_matrix", "X12", 4),
                ("interval", "interval_spr_dev", "X7 device", 6),
                ("interval", "interval_spr", "X7 host", 11))


@contextlib.contextmanager
def optimize_spies(rec):
    """Record each call of the slice's device programs (X3, X11, X12, X7),
    from outside the package: the device of its first tensor argument, its
    synchronized wall ms and the shape of its OPT_PROGRAMS argument; and
    after each BigMoveFinder.find_moves the paths its chunks took."""
    from usher_tpu_torch.ops import interval
    from usher_tpu_torch.optimize import epp, fitch, spr, spr_big
    mods = {"fitch": fitch, "spr": spr, "epp": epp, "interval": interval}
    saved = []

    def wrap(orig, name, arg):
        def spy(*a, **k):
            first = next(x for x in a if isinstance(x, torch.Tensor))
            cuda = first.device.type == "cuda"
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*a, **k)
            if cuda:
                torch.cuda.synchronize()
            r = rec.setdefault(name, {"ms": [], "devices": [], "shapes": []})
            r["ms"].append((time.perf_counter() - t0) * 1e3)
            if first.device.type not in r["devices"]:
                r["devices"].append(first.device.type)
            r["shapes"].append(list(a[arg].shape))
            return out
        return spy

    for mod, attr, name, arg in OPT_PROGRAMS:
        orig = getattr(mods[mod], attr)
        saved.append((mods[mod], attr, orig))
        setattr(mods[mod], attr, wrap(orig, name, arg))
    find = spr_big.BigMoveFinder.find_moves

    def find_spy(self, *a, **k):
        out = find(self, *a, **k)
        paths = rec.setdefault("X7 paths", {})
        for p, n in self.paths.items():
            paths[p] = paths.get(p, 0) + n
        return out

    spr_big.BigMoveFinder.find_moves = find_spy
    try:
        yield
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)
        spr_big.BigMoveFinder.find_moves = find


def spy_summary(rec):
    """Per program: calls, devices, median and total ms, the shapes seen."""
    out = {}
    for name, r in rec.items():
        if name == "X7 paths":
            out[name] = dict(r)
            continue
        shapes = sorted({tuple(s) for s in r["shapes"]})
        out[name] = {"calls": len(r["ms"]), "devices": r["devices"],
                     "median_ms": statistics.median(r["ms"]),
                     "total_ms": sum(r["ms"]),
                     "shapes": [list(s) for s in shapes[:4]]}
    return out


def on_cuda_only(rec, names):
    """Fails unless each named program ran, and ran on cuda only."""
    for name in names:
        devs = rec.get(name, {}).get("devices")
        if devs != ["cuda"]:
            raise AssertionError(f"{name} ran on {devs}, expected ['cuda']")


def run_opt(argv):
    from usher_tpu_torch.cli.matoptimize_cli import main
    rc = main(argv)
    if rc != 0:
        raise AssertionError(f"matOptimize {argv} returned {rc}")


CPU_OPT = """
import sys
from usher_tpu_torch.cli.matoptimize_cli import main
for argv in {runs!r}:
    if main(argv) != 0:
        sys.exit(1)
"""


def phase_optimize_fixture(built_pb, card):
    """matOptimize -N 2 -r 4 on the pb fixture_e2e built, dense, with
    --spr-backend big, --stream-states, --mesh-devices 4 and big with
    --mesh-devices 4, and -E, on the card and (in a subprocess) on the CPU:
    every output byte-equal, and parsimony 500 -> at most 494."""
    from usher_tpu_torch.io.pbio import load_mat_pb
    out = os.path.join(WORK, "optimize_fixture")
    os.makedirs(out, exist_ok=True)
    mesh = ["--mesh-devices", str(MESH_SHARDS)]
    modes = {"dense": [], "big": ["--spr-backend", "big"],
             "stream": ["--stream-states"], "mesh": mesh,
             "big_mesh": ["--spr-backend", "big"] + mesh}

    def runs(plat):
        r = [["-i", built_pb, "-o", os.path.join(out, f"{plat}_{m}.pb"),
              "-N", "2", "-r", "4"] + flags for m, flags in modes.items()]
        os.makedirs(os.path.join(out, f"{plat}_E"), exist_ok=True)
        return r + [["-i", built_pb, "-o", os.path.join(out, "x.pb"), "-E",
                     os.path.join(out, f"{plat}_E", "epp.nwk"), "-r", "4"]]

    rec = {}
    t0 = time.perf_counter()
    with optimize_spies(rec):
        for argv in runs("cuda"):
            run_opt(argv)
    cuda_s = time.perf_counter() - t0
    on_cuda_only(rec, ("X3", "X3 min-back", "X11", "X12", "X7 device",
                       "X7 host"))
    if not rec["X7 paths"].get("mesh"):
        raise AssertionError("no X7 chunk went over the batch mesh")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", CPU_OPT.format(runs=runs("cpu"))],
                   env=dict(os.environ, USHER_TPU_PLATFORM="cpu",
                            PYTHONPATH=REPO), check=True, timeout=900,
                   stdout=subprocess.DEVNULL)
    cpu_s = time.perf_counter() - t0
    pbs = [os.path.join(out, f"{p}_{m}.pb") for p in ("cuda", "cpu")
           for m in modes]
    same_files(out, out, [(os.path.basename(pbs[0]), os.path.basename(p))
                          for p in pbs[1:]])
    same_files(os.path.join(out, "cuda_E"), os.path.join(out, "cpu_E"),
               [("epp.nwk", "epp.nwk"), ("epps_dump", "epps_dump")])
    before = load_mat_pb(built_pb).get_parsimony_score()
    after = load_mat_pb(pbs[0]).get_parsimony_score()
    if before != 500 or after > 494:
        raise AssertionError(f"parsimony {before} -> {after}, expected "
                             "500 -> at most 494")
    return {"card": card, "parsimony": [before, after],
            "outputs": f"{len(pbs)} pbs byte-equal ("
                       + ", ".join(modes) + "; cuda and cpu); -E newick "
                       "and epps_dump equal on cuda and cpu",
            "cuda_runs_s": cuda_s, "cpu_runs_s": cpu_s,
            "programs": spy_summary(rec)}


def phase_optimize_realistic(pb, card):
    """matOptimize -N 1 -r 4 -z 0.002 -y 0 on the realistic pb (100,000
    nodes x 30,000 sites, ~200 sources), dense and with --spr-backend big:
    byte-equal output pbs; per mode the CLI wall, the optimizer's spans,
    the programs' ms and the peak device memory.  Each run takes 85-115 s
    on the card (host bound); the streamed run (~115 s) is left out to keep
    the script near ten minutes, and optimize_fixture runs it on the
    card."""
    modes = {"dense": [], "big": ["--spr-backend", "big"]}
    from usher_tpu_torch.utils.instrument import Instrumentor
    out = os.path.join(WORK, "optimize_realistic")
    os.makedirs(out, exist_ok=True)
    inst = Instrumentor.get()
    res = {"card": card}
    for m, flags in modes.items():
        rec = {}
        trace = os.path.join(out, f"trace_{m}.json")
        torch.cuda.reset_peak_memory_stats()
        inst.begin_session(trace)
        t0 = time.perf_counter()
        try:
            with optimize_spies(rec):
                run_opt(["-i", pb, "-o", os.path.join(out, f"{m}.pb"),
                         "-N", "1", "-r", "4", "-z", "0.002", "-y", "0"]
                        + flags)
        finally:
            inst.end_session()
        wall = time.perf_counter() - t0
        on_cuda_only(rec, ("X3", "X3 min-back")
                     + (("X11",) if m == "dense" else ("X7 device",)))
        stages = stage_seconds(trace)
        progs = spy_summary(rec)
        res[m] = {"cli_s": wall,
                  "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
                  "spans_s": {k: round(v, 3) for k, v in stages.items()},
                  "programs": progs}
        if m != "dense" and not rec.get("X7 paths", {}).get("device"):
            raise AssertionError(f"{m}: no X7 chunk took the device path")
        log(f"  optimize_realistic {m}: {json.dumps(res[m])}")
    names = [f"{m}.pb" for m in modes]
    same_files(out, out, [(names[0], n) for n in names[1:]])
    res["outputs"] = "byte-equal pbs: " + ", ".join(modes)
    return res


def pandemic_chunk(big, idxs, K):
    """bench.py's pandemic_optimize chunk: each source's own branch
    mutations (up to K) as its deviation entries, its ancestor-interval
    count events and its DFS rows: (pos, gval [B, K], cnt, src [4, B])."""
    B = len(idxs)
    pos = np.full((B, K), big.P, np.int32)
    gval = np.zeros((B, K), np.uint8)
    src = np.zeros((4, B), np.int32)
    anc = []
    for b, si in enumerate(idxs.tolist()):
        lo, hi = int(big.mut_ptr[si]), int(big.mut_ptr[si + 1])
        k = min(K, hi - lo)
        pos[b, :k] = big.mut_col[lo:lo + k]
        gval[b, :k] = big.mut_mut[lo:lo + k]
        src[:, b] = (big.level[si], big.dfs_of[si], big.dfs_end_of[si],
                     big.dfs_of[int(big.parent[si])])
        p = int(big.parent[si])
        while True:
            anc.append((big.dfs_of[p], big.dfs_end_of[p], b))
            if p == int(big.parent[p]):
                break
            p = int(big.parent[p])
    ar = np.asarray(anc, np.int32)
    cnt = (np.r_[ar[:, 0], ar[:, 1]], np.r_[ar[:, 2], ar[:, 2]],
           np.r_[np.ones(len(ar), np.int32), -np.ones(len(ar), np.int32)])
    return pos, gval, cnt, src


def phase_optimize_pandemic(big, card, n_srcs=2048, chunk=512, radius=8,
                            K=32):
    """bench.py's pandemic_optimize shape on the 1M-node BigMAT of
    bigmat_pandemic: 2,048 sources in chunks of 512, radius 8, K 32,
    through X7's device expansion (interval_spr_dev), held against X7 over
    host-expanded events on the card for every source and against a
    CPU-tensor run of interval_spr_dev for the first 16."""
    from usher_tpu_torch.ops import interval as iv
    rng = np.random.default_rng(1234)
    sources = rng.integers(1, big.N, size=n_srcs)
    meta = big._dfs_meta(spr=True)
    keys = ("num_mut", "is_root", "active", "num_leaves", "bfs_rank",
            "level")
    csc = big._csc_dev()
    mc = int(np.diff(big.csc_ptr).max())
    t = big._t

    def dev_call(pos, gval, cnt, src, on=None):
        d = on or big.device
        m = meta if on is None else {k: v.to(d) for k, v in meta.items()}
        c = csc if on is None else [x.to(d) for x in csc]
        return iv.interval_spr_dev(
            *c, t(pos, d), t(gval, d), *(t(a, d) for a in cnt),
            m["base"], m["nc_base"], *(m[k] for k in keys),
            *(t(a, d) for a in src), radius, big.N, len(pos), mc)

    dev_call(*pandemic_chunk(big, sources[:chunk], K))      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    chunks, chunk_ms, host_prep_ms, results = [], [], [], []
    t_all = time.perf_counter()
    for c0 in range(0, n_srcs, chunk):
        t0 = time.perf_counter()
        chunks.append(pandemic_chunk(big, sources[c0:c0 + chunk], K))
        t1 = time.perf_counter()
        out = dev_call(*chunks[-1])
        results.append(torch.stack([o.to(torch.int32) for o in out]).cpu())
        t2 = time.perf_counter()
        host_prep_ms.append((t1 - t0) * 1e3)
        chunk_ms.append((t2 - t1) * 1e3)
    total_s = time.perf_counter() - t_all
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # host-expanded events (interval_spr) on the card, every source
    host_ms = []
    for ch, want in zip(chunks, results):
        pos, gval, cnt, src = ch
        t0 = time.perf_counter()
        *ev, add0 = big._events(pos, gval, np.zeros(pos.shape, bool),
                                spr=True)
        got = iv.interval_spr(
            *(t(a) for a in iv.pad_events(*ev[:3], big.N)),
            *(t(a) for a in iv.pad_events(*ev[3:6], big.N)),
            *(t(a) for a in cnt), meta["base"], meta["nc_base"],
            t(add0.astype(np.int32)), *(meta[k] for k in keys),
            *(t(a) for a in src), radius, big.N, len(pos))
        got = torch.stack([o.to(torch.int32) for o in got]).cpu()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        if not torch.equal(got, want):
            raise AssertionError("X7 device expansion != host events")
    # a CPU-tensor run on the first 16 sources
    pos, gval, cnt, src = pandemic_chunk(big, sources[:16], K)
    t0 = time.perf_counter()
    cpu = torch.stack([o.to(torch.int32) for o in dev_call(
        pos, gval, cnt, src, on=torch.device("cpu"))])
    cpu_s = time.perf_counter() - t0
    if not torch.equal(cpu, results[0][:, :16]):
        raise AssertionError("X7 on the card != X7 on CPU tensors")
    with_dest = int(sum(int((r[0] < (1 << 29)).sum()) for r in results))
    if any(x.device.type != "cuda" for x in (*csc, *meta.values())):
        raise AssertionError("X7's inputs were not on cuda")
    return {"card": card, "N": big.N, "P": big.P, "sources": n_srcs,
            "chunk": chunk, "radius": radius, "K": K, "mc": mc,
            "chunk_ms": chunk_ms, "ms_per_chunk": statistics.median(chunk_ms),
            "host_prep_ms": host_prep_ms,
            "nodes_searched_per_min": n_srcs / total_s * 60,
            "device_nodes_per_min": n_srcs / sum(chunk_ms) * 6e4,
            "peak_device_gb": peak_gb,
            "host_events_ms_per_chunk": statistics.median(host_ms),
            "cpu_16_sources_s": cpu_s,
            "sources_with_a_destination": with_dest,
            "checks": "device expansion == host events (2,048 sources, on "
                      "the card) == CPU tensors (first 16)"}


# --- the compiled host scanners -------------------------------------------------

@contextlib.contextmanager
def pure_python_scanners():
    """The port as it runs where native/ could not be built."""
    from usher_tpu_torch import native
    loaded = native._loaded
    native._loaded = lambda: (None, "pure-Python comparison run")
    try:
        yield
    finally:
        native._loaded = loaded


def timed_s(fn, *a):
    t0 = time.perf_counter()
    out = fn(*a)
    return out, time.perf_counter() - t0


def same_pb_arrays(nat, py):
    """ext.pb_to_arrays's raw tuple against _py_pb_to_arrays's arrays."""
    if nat[0] != py[0] or nat[6:8] != py[6:8] or (nat[9] or b"") != py[9]:
        raise AssertionError("pb_to_arrays: newick, chrom, condensed or "
                             "annotations differ")
    for k, dt in ((1, np.int32), (2, np.int32), (3, np.int8), (4, np.int8),
                  (5, np.uint8), (8, np.int32)):
        arr = np.frombuffer(nat[k], dt) if nat[k] else np.zeros(0, dt)
        if not np.array_equal(arr, py[k]):
            raise AssertionError(f"pb_to_arrays field {k} differs")


def same_newick_arrays(nat, py):
    n, parent, names, blen = nat
    if (n != py[0] or names != py[2]
            or not np.array_equal(np.frombuffer(parent, np.int32), py[1])
            or not np.array_equal(np.frombuffer(blen, np.float64), py[3])):
        raise AssertionError("newick_to_arrays differs from pure Python")


def vcf_rows(vcf):
    return (vcf.sample_ids, [(s.chrom, s.position, s.ref_nuc, s.variants)
                             for s in vcf.sites])


def raw_vcf_rows(parsed):
    ids, sites = parsed
    return ids, [(c, int(p), int(r), [(int(a), int(b)) for a, b in v])
                 for c, p, r, v in sites]


def fixture_pb(out):
    """The fixture MAT as a pb, built by the usher CLI (no sample to
    place, so no kernel launch)."""
    fx = os.path.join(REPO, "tests", "fixtures")
    run_cli(["-t", os.path.join(fx, "global_phylo.nh"), "-v",
             os.path.join(fx, "global_samples.vcf"), "-o",
             os.path.join(out, "fixture.pb"), "-d", os.path.join(out, "b"),
             "--mesh-devices", "0"])
    return os.path.join(out, "fixture.pb")


def phase_native(kern, pb, vcf):
    """Build native/src/usher_native.cpp with g++ (the first use of the
    scanner in this run), then on the realistic pb and VCF and on the
    fixture: the compiled pb_to_arrays, newick_to_arrays, parse_vcf,
    parse_vcf_mt, read_vcf_sites, load_mat_arrays and the transposed codec
    (bytes and a round trip) equal to the pure-Python scanners, each timed
    on both sides.  No kernel runs here."""
    from usher_tpu_torch import native
    from usher_tpu_torch.io import pb_arrays, transpose
    from usher_tpu_torch.io.vcf import read_vcf_sites
    from usher_tpu_torch.native import _build
    before = kern.counts()
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the compiled scanner did not build:\n"
                             f"{native.build_error()}")
    res = {"build_s": time.perf_counter() - t0,
           "library": os.path.relpath(str(_build.library_path()), REPO)}
    ext = native.ext
    out = os.path.join(WORK, "native")
    os.makedirs(out, exist_ok=True)
    fx = os.path.join(REPO, "tests", "fixtures")
    inputs = {"realistic": (pb, vcf),
              "fixture": (fixture_pb(out),
                          os.path.join(fx, "global_samples.vcf"))}
    for tag, (pb_path, vcf_path) in inputs.items():
        r = {}
        with open(pb_path, "rb") as f:
            buf = f.read()
        nat, r["pb_to_arrays_s"] = timed_s(ext.pb_to_arrays, buf)
        py, r["pb_to_arrays_py_s"] = timed_s(pb_arrays._py_pb_to_arrays, buf)
        same_pb_arrays(nat, py)
        nwk, r["newick_to_arrays_s"] = timed_s(ext.newick_to_arrays, nat[0])
        pnwk, r["newick_to_arrays_py_s"] = timed_s(
            pb_arrays._py_newick_to_arrays, nat[0])
        same_newick_arrays(nwk, pnwk)
        arrays, r["load_mat_arrays_s"] = timed_s(pb_arrays.load_mat_arrays,
                                                 pb_path)
        with pure_python_scanners():
            parrays, r["load_mat_arrays_py_s"] = timed_s(
                pb_arrays.load_mat_arrays, pb_path)
        for k in ("parent", "blen", "mut_ptr", "mut_col", "mut_par",
                  "mut_mut", "positions", "ref", "ann_counts"):
            if not np.array_equal(getattr(arrays, k), getattr(parrays, k)):
                raise AssertionError(f"{tag}: load_mat_arrays.{k} differs")
        del nat, py, nwk, pnwk, arrays, parrays, buf
        with pure_python_scanners():
            want, r["read_vcf_sites_py_s"] = timed_s(read_vcf_sites, vcf_path)
        got, r["read_vcf_sites_s"] = timed_s(read_vcf_sites, vcf_path)
        want_rows = vcf_rows(want)
        if vcf_rows(got) != want_rows:
            raise AssertionError(f"{tag}: read_vcf_sites differs")
        for name, call in (("parse_vcf", lambda: ext.parse_vcf(vcf_path)),
                           ("parse_vcf_mt",
                            lambda: ext.parse_vcf_mt(vcf_path))):
            parsed, r[name + "_s"] = timed_s(call)
            if raw_vcf_rows(parsed) != want_rows:
                raise AssertionError(f"{tag}: {name} differs")
            del parsed
        samples = transpose.samples_from_vcf(want)
        del got, want, want_rows
        a, b = (os.path.join(out, f"{tag}_{s}.tvcf") for s in ("c", "py"))
        _, r["transpose_encode_s"] = timed_s(transpose.encode, samples, a)
        _, r["transpose_encode_py_s"] = timed_s(transpose._encode_py,
                                                samples, b)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError(f"{tag}: transposed bytes differ")
        back, r["transpose_decode_s"] = timed_s(transpose.decode, a)
        pback, r["transpose_decode_py_s"] = timed_s(transpose._decode_py, a)
        if not back == pback == [(n, list(m), list(x))
                                 for n, m, x in samples]:
            raise AssertionError(f"{tag}: transposed round trip differs")
        r["vcf_samples"], r["tvcf_bytes"] = len(samples), os.path.getsize(a)
        res[tag] = r
    after = kern.counts()
    launches = {k: after[k] - before[k] for k in after}
    if any(launches.values()):
        raise AssertionError(f"the scanner phase launched {launches}")
    res["equal"] = ("pb_to_arrays, newick_to_arrays, load_mat_arrays, "
                    "parse_vcf, parse_vcf_mt, read_vcf_sites, transposed "
                    "bytes and round trip: compiled == pure Python")
    return res


# --- usher-sampled and the servers ------------------------------------------------

@contextlib.contextmanager
def sampled_spies(rec):
    """Count, from outside the package, PlacementEngine.score_samples calls
    (with and without a mesh: each call is one fused B1 launch, or one a
    shard), their synchronized ms, and the BatchPlacementStats of every
    place_batch of the usher-sampled CLI."""
    from usher_tpu_torch.cli import usher_sampled_cli as cli
    from usher_tpu_torch.placement.driver import PlacementEngine
    score = PlacementEngine.score_samples
    place = cli.place_batch

    def score_spy(self, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = score(self, *a, **k)
        torch.cuda.synchronize()
        key = "mesh" if self.mesh is not None else "plain"
        rec.setdefault("score_ms", []).append(
            (time.perf_counter() - t0) * 1e3)
        rec["calls_" + key] = rec.get("calls_" + key, 0) + 1
        if self.mesh is not None:
            rec["shards"] = self.mesh.shape["data"] * self.mesh.shape["model"]
        return out

    def place_spy(*a, **k):
        st = place(*a, **k)
        for f in ("placed", "retried", "ignored", "parsimony_increase"):
            rec[f] = rec.get(f, 0) + getattr(st, f)
        return st

    PlacementEngine.score_samples = score_spy
    cli.place_batch = place_spy
    try:
        yield
    finally:
        PlacementEngine.score_samples = score
        cli.place_batch = place


def expected_b1(rec):
    """B1 launches the score_samples calls of `rec` make."""
    return rec.get("calls_plain", 0) + rec.get("calls_mesh", 0) * rec.get(
        "shards", 0)


def run_sampled(argv, rec, trace=None):
    """The usher-sampled CLI under sampled_spies, its stderr captured (and
    its tail passed on): (wall s, stderr, spans by name)."""
    import io
    from usher_tpu_torch.cli.usher_sampled_cli import main
    from usher_tpu_torch.utils.instrument import Instrumentor
    inst = Instrumentor.get()
    if trace:
        inst.begin_session(trace)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with sampled_spies(rec), contextlib.redirect_stderr(buf):
            rc = main(argv)
    finally:
        if trace:
            inst.end_session()
    wall = time.perf_counter() - t0
    err = buf.getvalue()
    sys.stderr.write(err[-1500:])
    if rc != 0:
        raise AssertionError(f"usher-sampled {argv} returned {rc}")
    return wall, err, stage_seconds(trace) if trace else {}


def dir_files(d):
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


def pruned_newick(path):
    """The fixture newick with every fifth leaf pruned (85 of 422 leaves):
    built with global_samples.vcf, the pruned samples are new and fill more
    than one chunk of 64 (--batch_size_per_process 1)."""
    from usher_tpu_torch.io.newick import parse_newick, write_newick
    T = parse_newick(os.path.join(REPO, "tests", "fixtures",
                                  "global_phylo.nh"))
    for leaf in T.get_leaves()[::5]:
        T.remove_node(leaf.identifier, True)
    T.remove_single_child_nodes()
    with open(path, "w") as f:
        f.write(write_newick(T, print_branch_len=True) + "\n")
    return path


def fixture_diff(path, vcf_path):
    """The new samples of a VCF as a MAPLE diff."""
    from usher_tpu_torch.core.nuc import char_from_nuc_id
    from usher_tpu_torch.io.vcf import read_vcf_sites
    vcf = read_vcf_sites(vcf_path)
    lines = []
    for j, name in enumerate(vcf.sample_ids):
        lines.append(f">{name}")
        for site in vcf.sites:
            v = dict(site.variants).get(j)
            if v is not None and v != site.ref_nuc:
                lines.append(f"n\t{site.position}" if v == 0xF else
                             f"{char_from_nuc_id(v)}\t{site.position}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


CPU_SAMPLED = """
import sys
from usher_tpu_torch.cli.usher_sampled_cli import main
for argv in {runs!r}:
    if main(argv) != 0:
        sys.exit(1)
"""


def phase_sampled_fixture(kern, built_pb):
    """usher-sampled-torch on the fixture, on the card and (in a subprocess)
    with USHER_TPU_PLATFORM=cpu: VCF with -B, --diff, -A -k -K, -M 2,
    --bigmat, --mesh-devices 4, and the pruned tree (85 new samples in
    chunks of 64 under --parsimony_threshold 1) that reaches the
    interleaved optimization and a final round.  Every output file
    byte-equal between card and CPU; B1 launches == score_samples calls
    (one a shard under the mesh)."""
    fx = os.path.join(REPO, "tests", "fixtures")
    out = os.path.join(WORK, "sampled_fixture")
    os.makedirs(out, exist_ok=True)
    new_vcf = os.path.join(fx, "new_samples.vcf")
    diff = fixture_diff(os.path.join(out, "new.diff"), new_vcf)
    pruned = pruned_newick(os.path.join(out, "pruned.nh"))
    modes = {
        "vcf_B": ["-i", built_pb, "-v", new_vcf, "-B"],
        "diff": ["-i", built_pb, "--diff", diff, "--ref",
                 os.path.join(fx, "NC_045512v2.fa")],
        "A_k_K": ["-i", built_pb, "-v", new_vcf, "-A", "-k", "10", "-K",
                  "4"],
        "M2": ["-i", built_pb, "-v", new_vcf, "-M", "2"],
        "bigmat": ["-i", built_pb, "-v", new_vcf, "--bigmat", "-s"],
        "mesh": ["-i", built_pb, "-v", new_vcf, "--mesh-devices",
                 str(MESH_SHARDS), "-s"],
        "interleaved": ["-t", pruned, "-v", os.path.join(
            fx, "global_samples.vcf"), "--batch_size_per_process", "1",
            "--parsimony_threshold", "1", "--optimization_radius", "2",
            "--optimization_minutes", "1", "--last_optimization_minutes",
            "1"]}

    def runs(plat):
        return [argv + ["-d", os.path.join(out, plat, m), "-o",
                        os.path.join(out, plat, m, "o.pb")]
                for m, argv in modes.items()]

    before = kern.counts()
    rec = {}
    walls, errs = {}, {}
    for m, argv in zip(modes, runs("cuda")):
        walls[m], errs[m], _ = run_sampled(argv, rec)
    after = kern.counts()
    launches = {k: after[k] - before[k] for k in after}
    if "Cumulative parsimony increase" not in errs["interleaved"]:
        raise AssertionError("the interleaved optimization was not reached")
    if launches["B1"] != expected_b1(rec) or not launches["B1"]:
        raise AssertionError(f"B1 launches {launches['B1']} != the "
                             f"score_samples calls' {expected_b1(rec)}")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c",
                    CPU_SAMPLED.format(runs=runs("cpu"))],
                   env=dict(os.environ, USHER_TPU_PLATFORM="cpu",
                            PYTHONPATH=REPO), check=True, timeout=900,
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    cpu_s = time.perf_counter() - t0
    n_files = 0
    for m in modes:
        cuda = dir_files(os.path.join(out, "cuda", m))
        if not cuda or cuda != dir_files(os.path.join(out, "cpu", m)):
            raise AssertionError(f"sampled_fixture {m}: card and CPU "
                                 "files differ")
        n_files += len(cuda)
    return {"outputs": f"{n_files} files byte-equal, card and CPU ("
                       + ", ".join(modes) + ")",
            "interleaved": [l for l in errs["interleaved"].splitlines()
                            if l.startswith(("Cumulative", "Final parsimony",
                                             "The parsimony"))],
            "card_s": walls, "cpu_subprocess_s": cpu_s,
            "score_samples_calls": {k: rec.get(k, 0) for k in (
                "calls_plain", "calls_mesh")},
            "retried": rec.get("retried", 0), "placed": rec.get("placed", 0),
            "launches": launches}


def subset_vcf(src, dst, first, count):
    """The VCF `src` with sample columns first..first+count-1 only."""
    with open(src) as f, open(dst, "w") as out:
        for line in f:
            if line.startswith("##"):
                out.write(line)
                continue
            w = line.rstrip("\n").split("\t")
            out.write("\t".join(w[:9] + w[9 + first:9 + first + count])
                      + "\n")
    return dst


def phase_sampled_realistic(kern, pb, vcf, n_samples):
    """usher-sampled-torch -s on the realistic pb (the tree is not cut) and
    the first n_samples of the realistic VCF, dense and --bigmat: byte-equal
    files; per mode the wall, the spans, score_samples calls (== B1
    launches, dense), stale retries, and the peak device memory."""
    out = os.path.join(WORK, "sampled_realistic")
    os.makedirs(out, exist_ok=True)
    sub = subset_vcf(vcf, os.path.join(out, "samples.vcf"), 0, n_samples)
    res = {"samples": n_samples}
    launches = {}
    for m, flags in (("dense", []), ("bigmat", ["--bigmat"])):
        rec = {}
        before = kern.counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wall, _, spans = run_sampled(
            ["-i", pb, "-v", sub, "-d", os.path.join(out, m), "-s", *flags],
            rec, trace=os.path.join(out, f"trace_{m}.json"))
        after = kern.counts()
        launches[m] = {k: after[k] - before[k] for k in after}
        ms = rec.get("score_ms", [])
        res[m] = {"cli_s": wall,
                  "spans_s": {k: round(v, 3) for k, v in spans.items()},
                  "score_samples_calls": rec.get("calls_plain", 0),
                  "score_samples_median_ms": (statistics.median(ms)
                                              if ms else None),
                  "placed": rec.get("placed", 0),
                  "retried": rec.get("retried", 0),
                  "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
                  "launches": launches[m]}
        log(f"  sampled_realistic {m}: {json.dumps(res[m])}")
        if rec.get("placed") != n_samples:
            raise AssertionError(f"{m}: placed {rec.get('placed')}")
    dense = launches["dense"]
    if dense["B1"] != res["dense"]["score_samples_calls"] or not dense["B1"]:
        raise AssertionError(f"dense: B1 launches {dense['B1']} != "
                             f"score_samples calls "
                             f"{res['dense']['score_samples_calls']}")
    if launches["bigmat"]["B1"] or launches["bigmat"]["B2"]:
        raise AssertionError(f"--bigmat launched {launches['bigmat']}")
    same_files(os.path.join(out, "dense"), os.path.join(out, "bigmat"),
               [(f, f) for f in PLACE_FILES])
    res["outputs"] = "dense == --bigmat: " + ", ".join(PLACE_FILES)
    res["launches"] = {k: dense[k] + launches["bigmat"][k] for k in dense}
    return res


@contextlib.contextmanager
def request_spy(module, name, rec):
    """Time each call of module.<name> (a server's per-request function)
    and read the device memory after it: the peak since the window began
    and what is still allocated."""
    orig = getattr(module, name)

    def spy(*a, **k):
        t0 = time.perf_counter()
        out = orig(*a, **k)
        torch.cuda.synchronize()
        rec.append({"wall_s": time.perf_counter() - t0,
                    "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "allocated_gb": torch.cuda.memory_allocated() / 1e9})
        return out

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, orig)


def socket_client(sock_path, fifo_path, requests, replies):
    """Send each request (argument lists) on its own connection, collect
    the replies, then stop the server through its FIFO."""
    import socket as so
    for args in requests:
        for _ in range(600):
            if os.path.exists(sock_path):
                break
            time.sleep(0.1)
        c = so.socket(so.AF_UNIX, so.SOCK_STREAM)
        c.settimeout(600)
        c.connect(sock_path)
        c.sendall(("".join(a + "\n" for a in args) + "\n").encode())
        buf = b""
        while not buf.endswith(b"\x04\n"):
            chunk = c.recv(65536)
            if not chunk:
                break
            buf += chunk
        c.close()
        replies.append(buf)
    with open(fifo_path, "w") as f:
        f.write("stop\n")


def phase_server_realistic(kern, pb, vcf, n_samples):
    """The two servers on the realistic pb (pre-loaded) with requests of
    n_samples each.  usher_server --once: two argument files, the second
    with -s (B2), each == the usher CLI's files on the same inputs.  The
    socket server (one process, requests served in turn against a
    Tree.copy()): two identical requests, whose replies and files must be
    equal to each other and to usher-sampled's on the same samples (its
    place_batch batch of 256, as the server's).  Per request its wall and
    the device memory after it."""
    from usher_tpu_torch.cli import usher_server_cli as userver
    from usher_tpu_torch.cli import usher_socket_server_cli as usock
    out = os.path.join(WORK, "server")
    os.makedirs(out, exist_ok=True)
    vcfs = [subset_vcf(vcf, os.path.join(out, f"s{i}.vcf"),
                       256 + i * n_samples, n_samples) for i in range(2)]
    res = {"samples_per_request": n_samples}

    # --- usher_server --once: the counters cover the served requests ----
    arg_dir = os.path.join(out, "args")
    os.makedirs(arg_dir)
    jobs = [f"-i {pb} -v {vcfs[0]} -d {out}/srv0",
            f"-i {pb} -v {vcfs[1]} -d {out}/srv1 -s"]
    for i, job in enumerate(jobs):
        with open(os.path.join(arg_dir, f"job{i}.txt"), "w") as f:
            f.write(job + "^\n")
    mat_list = os.path.join(out, "mats.txt")
    with open(mat_list, "w") as f:
        f.write(pb + "\n")
    store = userver.MatStore(mat_list)
    t0 = time.perf_counter()
    if not store.load_list():
        raise AssertionError("usher_server: MAT list not loaded")
    res["usher_server_preload_s"] = time.perf_counter() - t0
    reqs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kern.reset_counts()
    t0 = time.perf_counter()
    with request_spy(userver, "run_request", reqs):
        if userver.serve(arg_dir, store, 10, 94, once=True) != 0:
            raise AssertionError("usher_server returned non-zero")
    res["usher_server_s"] = time.perf_counter() - t0
    server_counts = kern.counts()
    # ----------------------------------------------------------------------
    if os.listdir(arg_dir) or len(reqs) != 2:
        raise AssertionError(f"usher_server served {len(reqs)} requests")
    if server_counts["B2"] < 1 or server_counts["B1"] < 2:
        raise AssertionError(f"usher_server launches {server_counts}")
    res["usher_server_requests"] = reqs
    res["usher_server_launches"] = server_counts
    del store
    for i, flags in enumerate(([], ["-s"])):
        run_cli(["-i", pb, "-v", vcfs[i], "-d", f"{out}/cli{i}",
                 "--mesh-devices", "0", *flags])
        same_files(f"{out}/srv{i}", f"{out}/cli{i}",
                   [(f, f) for f in PLACE_FILES])
    res["usher_server_outputs"] = ("== usher CLI, both requests: "
                                   + ", ".join(PLACE_FILES))

    # --- the socket server: the counters cover its two requests ---------
    import threading
    sock_path = os.path.join(out, "s.sock")
    fifo_path = os.path.join(out, "mgr.fifo")
    t0 = time.perf_counter()
    trees = usock.TreeCollection([pb])
    res["socket_preload_s"] = time.perf_counter() - t0
    server = usock.SocketServer(sock_path, fifo_path, trees, timeout_s=900)
    req = [["-i", pb, "-v", vcfs[0], "-d", f"{out}/sock{i}"]
           for i in range(2)]
    replies, sreqs = [], []
    client = threading.Thread(target=socket_client,
                              args=(sock_path, fifo_path, req, replies))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kern.reset_counts()
    client.start()
    try:
        with request_spy(usock, "handle_request", sreqs):
            server.serve_forever()
    finally:
        server.close()
        client.join(timeout=600)
    sock_counts = kern.counts()
    # ----------------------------------------------------------------------
    if client.is_alive() or len(replies) != 2 or len(sreqs) != 2:
        raise AssertionError("socket server: requests not served")
    if replies[0] != replies[1] or b"Sample name:" not in replies[0]:
        raise AssertionError("socket server: the two replies differ")
    same_files(f"{out}/sock0", f"{out}/sock1", [(f, f) for f in PLACE_FILES])
    peaks = [r["peak_device_gb"] for r in sreqs]
    if peaks[1] > peaks[0] * 1.05:
        raise AssertionError(f"socket server: peak device memory grew from "
                             f"{peaks[0]:.3f} to {peaks[1]:.3f} GB")
    if sock_counts["B1"] < 2:
        raise AssertionError(f"socket server launches {sock_counts}")
    res["socket_requests"] = sreqs
    res["socket_launches"] = sock_counts
    rec = {}
    _, err, _ = run_sampled(["-i", pb, "-v", vcfs[0], "-d", f"{out}/sampled",
                             "--batch_size_per_process", "32"], rec)
    same_files(f"{out}/sock0", f"{out}/sampled",
               [(f, f) for f in PLACE_FILES])
    lines = [l for l in err.splitlines() if l.startswith("Sample name:")]
    if "".join(l + "\n" for l in lines) + "\n" != \
            replies[0][:-2].decode():
        raise AssertionError("socket reply != usher-sampled's sample lines")
    res["socket_outputs"] = ("two replies equal; files equal to each other "
                             "and to usher-sampled --batch_size_per_process "
                             "32: " + ", ".join(PLACE_FILES))
    return res


# --- matUtils (matutils/, cli/matutils_cli.py) -----------------------------

# the device entry points of the matUtils modes, spied on from outside the
# package: score_samples is one fused B1 launch a call (no mesh here)
MU_ENTRY_POINTS = (("placement.driver", "PlacementEngine", "score_samples",
                    "score_samples"),
                   ("ops.interval", None, "interval_place_flatgrp_dev", "X6"),
                   ("ops.interval", None, "interval_place_dev", "X5"),
                   ("ops.interval", None, "interval_place", "X8"))


@contextlib.contextmanager
def matutils_spies(rec):
    """rec[name] = [calls, synchronized ms] of each MU_ENTRY_POINTS entry
    while the context is open."""
    import importlib
    saved = []
    for mod, cls, attr, name in MU_ENTRY_POINTS:
        m = importlib.import_module("usher_tpu_torch." + mod)
        obj = getattr(m, cls) if cls else m
        fn = getattr(obj, attr)
        saved.append((obj, attr, fn))

        def spy(*a, _fn=fn, _name=name, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            c = rec.setdefault(_name, [0, 0.0])
            c[0] += 1
            c[1] += (time.perf_counter() - t0) * 1e3
            return out
        setattr(obj, attr, spy)
    try:
        yield
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)


def spy_calls(rec, before=None):
    """{name: calls} of a matutils_spies record (since `before`)."""
    before = before or {}
    return {name: rec.get(name, [0])[0] - before.get(name, [0])[0]
            for *_, name in MU_ENTRY_POINTS}


class Captured:
    """stdout of the CLI runs of a phase, read and cleared by each step
    (matutils_cases.run_steps), and their stderr, of which the tail is
    shown when a run fails."""

    def __init__(self):
        import io
        self.out, self.err = io.StringIO(), io.StringIO()

    def stdout(self):
        text = self.out.getvalue()
        self.out.seek(0)
        self.out.truncate(0)
        return text

    @contextlib.contextmanager
    def capture(self):
        try:
            with contextlib.redirect_stdout(self.out), \
                    contextlib.redirect_stderr(self.err):
                yield
        except BaseException:
            sys.stderr.write(self.err.getvalue()[-3000:])
            raise


def mkdir(path):
    os.makedirs(path, exist_ok=True)
    return path


CPU_MATUTILS = """
import contextlib, io, json, sys
sys.path.insert(0, {tests!r})
import matutils_cases as mc
from usher_tpu_torch.cli.matutils_cli import main
with open({plan!r}) as f:
    plan = json.load(f)
buf = io.StringIO()
def stdout():
    text = buf.getvalue()
    buf.seek(0)
    buf.truncate(0)
    return text
got = {{}}
with contextlib.redirect_stdout(buf):
    for case, d, steps in plan:
        got[case] = mc.run_steps(main, d, steps, stdout)[0]
with open({result!r}, "w") as f:
    json.dump(got, f)
"""

# cases whose Tree path scores on the card through PlacementEngine (B1):
# uncertainty, annotate (-c and -M), merge and extract -e
MU_B1_CASES = ("uncertainty", "annotate_by_nid_and_sample_clades",
               "annotate_clade_mutations", "merge", "extract_max_epps")


def phase_matutils_fixture(kern):
    """Every matUtils invocation of the port's CPU tests
    (tests/matutils_cases.py: each subcommand, with --pb-direct where it
    has one, and the summary and extract goldens) on the card, and again
    in a CPU subprocess: exit codes, stdout and every output file
    byte-equal; the goldens and each case's own Tree == --pb-direct pairs
    hold on the card.  B1 launches == score_samples calls in every case,
    > 0 for uncertainty, annotate, merge and extract -e; X6 ran for
    uncertainty --pb-direct."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import matutils_cases as mc
    from usher_tpu_torch.cli.matutils_cli import main as mu
    out = os.path.join(WORK, "matutils_fixture")
    fx = mc.Fixtures(lambda name: mkdir(os.path.join(out, "fx", name)),
                     "cuda")
    cap = Captured()
    rec, plan, card, per_case = {}, [], {}, {}
    t0 = time.perf_counter()
    with matutils_spies(rec):
        for case in sorted(mc.CASES):
            with cap.capture():
                spec = mc.CASES[case](mkdir(os.path.join(out, "in", case)),
                                      fx)
                cap.stdout()          # what building the inputs printed
                before, calls0 = kern.counts(), dict(
                    (k, list(v)) for k, v in rec.items())
                got, files = mc.run_steps(
                    mu, os.path.join(out, "cuda", case), spec["steps"],
                    cap.stdout)
            mc.check_run(spec, got, files)
            after = kern.counts()
            n = dict(spy_calls(rec, calls0),
                     B1=after["B1"] - before["B1"],
                     B2=after["B2"] - before["B2"])
            if n["B1"] != n["score_samples"]:
                raise AssertionError(f"matutils_fixture {case}: B1 launches "
                                     f"{n['B1']} != score_samples calls "
                                     f"{n['score_samples']}")
            per_case[case] = n
            card[case] = (json.loads(json.dumps(got)), files)
            plan.append((case, os.path.join(out, "cpu", case),
                         spec["steps"]))
    card_s = time.perf_counter() - t0
    for case in MU_B1_CASES:
        if not per_case[case]["B1"]:
            raise AssertionError(f"matutils_fixture {case}: no B1 launch")
    if not per_case["uncertainty_pb_direct"]["X6"]:
        raise AssertionError("uncertainty --pb-direct never reached X6")
    plan_path = os.path.join(out, "plan.json")
    result_path = os.path.join(out, "cpu.json")
    with open(plan_path, "w") as f:
        json.dump(plan, f)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", CPU_MATUTILS.format(
        tests=os.path.join(REPO, "tests"), plan=plan_path,
        result=result_path)],
        env=dict(os.environ, USHER_TPU_PLATFORM="cpu", PYTHONPATH=REPO),
        check=True, timeout=900, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    cpu_s = time.perf_counter() - t0
    with open(result_path) as f:
        cpu = json.load(f)
    n_files = n_steps = 0
    for case, (got, files) in card.items():
        if cpu[case] != got:
            raise AssertionError(f"matutils_fixture {case}: exit codes or "
                                 "stdout differ between card and CPU")
        if dir_files(os.path.join(out, "cpu", case)) != files:
            raise AssertionError(f"matutils_fixture {case}: files differ "
                                 "between card and CPU")
        n_files += len(files)
        n_steps += len(got)
    totals = {k: sum(n[k] for n in per_case.values())
              for k in next(iter(per_case.values()))}
    return {"outputs": f"{len(card)} cases, {n_steps} invocations, "
                       f"{n_files} files byte-equal, card and CPU; goldens "
                       "and Tree == --pb-direct pairs hold on the card",
            "card_s": card_s, "cpu_subprocess_s": cpu_s,
            "device_cases": {c: n for c, n in per_case.items()
                             if any(n.values())},
            "totals": totals,
            "device_ms": {k: round(v[1], 3) for k, v in rec.items()}}


def mu_run(name, argv, kern, env=None):
    """One matUtils CLI run on the card under matutils_spies: its wall,
    kernel launches, entry-point calls and ms, the wall share outside
    those calls (host_share: the calls hold host work of their own, so
    it is a lower limit) and the peak device memory."""
    from usher_tpu_torch.cli.matutils_cli import main as mu
    rec = {}
    cap = Captured()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = kern.counts()
    t0 = time.perf_counter()
    with patched_env(env), matutils_spies(rec), cap.capture():
        rc = mu(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        sys.stderr.write(cap.err.getvalue()[-3000:])
        raise AssertionError(f"matUtils {argv} returned {rc}")
    after = kern.counts()
    dev_ms = sum(v[1] for v in rec.values())
    res = {"wall_s": wall,
           "launches": {k: after[k] - before[k] for k in ("B1", "B2")},
           "calls": spy_calls(rec),
           "calls_ms": {k: round(v[1], 3) for k, v in rec.items()},
           "host_share": 1 - dev_ms / 1e3 / wall,
           "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9}
    if res["launches"]["B1"] != res["calls"]["score_samples"]:
        raise AssertionError(f"{name}: B1 launches {res['launches']} != "
                             f"score_samples calls {res['calls']}")
    log(f"  matutils_realistic {name}: {json.dumps(res)}")
    return res


def phase_matutils_realistic(kern, pb, vcf, n_leaves=1024, n_clades=8,
                             n_merge=256):
    """matUtils on the realistic pb: uncertainty -e -o on n_leaves of its
    leaves by the Tree path (B1, batches of 64) and by --pb-direct with
    USHER_TPU_GROUPED=1 (X6) and =0 (X5), all three byte-equal; annotate
    -c with n_clades clades of the tree's own subtrees (one B1 launch a
    clade); merge of the two trees that usher --pb-direct makes from the
    pb with samples 0..n_merge-1 and n_merge..2*n_merge-1, by the Tree
    path and by --pb-direct, byte-equal pbs.  Per run its wall, launches,
    calls, host share and peak device memory."""
    from usher_tpu_torch.io.pbio import load_mat_pb
    out = mkdir(os.path.join(WORK, "matutils_realistic"))
    rng = np.random.default_rng(12)
    T = load_mat_pb(pb)
    T.uncondense_leaves()
    leaves = T.get_leaves_ids()
    chosen = [leaves[i] for i in sorted(rng.choice(len(leaves), n_leaves,
                                                   replace=False).tolist())]
    sf = os.path.join(out, "samples.txt")
    with open(sf, "w") as f:
        f.write("".join(s + "\n" for s in chosen))
    # clades: random internal nodes of 20..400 leaves, members all of them
    size = {}
    for node in reversed(T.breadth_first_expansion()):
        size[node.identifier] = (1 if node.is_leaf() else
                                 sum(size[c.identifier]
                                     for c in node.children))
    cands = [n for n, k in size.items() if 20 <= k <= 400 and k > 1]
    picks = [cands[i] for i in rng.choice(len(cands), n_clades,
                                          replace=False).tolist()]
    clades = os.path.join(out, "clades.tsv")
    with open(clades, "w") as f:
        for k, nid in enumerate(picks):
            for m in T.get_leaves_ids(nid):
                f.write(f"clade_{k}\t{m}\n")
    del T, size, cands
    res = {"leaves": n_leaves, "clades": n_clades, "merge_new": n_merge}
    res["uncertainty_tree"] = mu_run(
        "uncertainty_tree", ["uncertainty", "-i", pb, "-s", sf, "-e",
                             f"{out}/t_epps.tsv", "-o", f"{out}/t_locs.tsv"],
        kern)
    for g in ("1", "0"):
        res[f"uncertainty_direct_grouped{g}"] = mu_run(
            f"uncertainty_direct_grouped{g}",
            ["uncertainty", "-i", pb, "-s", sf, "--pb-direct", "-e",
             f"{out}/a{g}_epps.tsv", "-o", f"{out}/a{g}_locs.tsv"], kern,
            env={"USHER_TPU_GROUPED": g})
    same_files(out, out, [(f"t_{f}", f"a{g}_{f}") for f in (
        "epps.tsv", "locs.tsv") for g in "10"])
    want_b1 = -(-n_leaves // 64)
    if res["uncertainty_tree"]["launches"]["B1"] != want_b1:
        raise AssertionError(f"uncertainty: B1 launches "
                             f"{res['uncertainty_tree']['launches']}, "
                             f"expected {want_b1}")
    if not res["uncertainty_direct_grouped1"]["calls"]["X6"] or \
            res["uncertainty_direct_grouped0"]["calls"]["X6"]:
        raise AssertionError("USHER_TPU_GROUPED did not pick X6 / X5")
    res["annotate"] = mu_run(
        "annotate", ["annotate", "-i", pb, "-o", f"{out}/ann.pb",
                     "-c", clades], kern)
    if res["annotate"]["launches"]["B1"] != n_clades:
        raise AssertionError(f"annotate: launches "
                             f"{res['annotate']['launches']}")
    # the merge inputs: two --pb-direct placements of disjoint samples
    t0 = time.perf_counter()
    trees = []
    for k in range(2):
        sub = subset_vcf(vcf, os.path.join(out, f"merge{k}.vcf"),
                         k * n_merge, n_merge)
        trees.append(os.path.join(out, f"merge{k}.pb"))
        with Captured().capture():
            run_cli(["-i", pb, "-v", sub, "-o", trees[-1], "-d",
                     os.path.join(out, f"merge{k}"), "--pb-direct"])
    res["merge_inputs_s"] = time.perf_counter() - t0
    res["merge_tree"] = mu_run(
        "merge_tree", ["merge", "-1", trees[0], "-2", trees[1], "-o",
                       f"{out}/mt.pb"], kern)
    res["merge_direct"] = mu_run(
        "merge_direct", ["merge", "-1", trees[0], "-2", trees[1],
                         "--pb-direct", "-o", f"{out}/ma.pb"], kern)
    same_files(out, out, [("mt.pb", "ma.pb")])
    if not res["merge_tree"]["launches"]["B1"]:
        raise AssertionError("merge (Tree path) launched no B1")
    res["outputs"] = ("uncertainty Tree == --pb-direct grouped == plain "
                      "(epps, locs); merge Tree == --pb-direct (pb)")
    res["launches"] = {k: sum(r["launches"][k] for r in res.values()
                              if isinstance(r, dict) and "launches" in r)
                       for k in ("B1", "B2")}
    return res


def synth_lineage_bigmat(rng, N, P, device, n_lineages=64, stem=30,
                         n_mut=2):
    """bench.py's lineage-structured MAT (n_lineages stems of `stem`
    chained branches below the root, each carrying a random recursive
    subtree, so the tree's own leaves share their lineage's stem), with
    synth_bigmat's chain-consistent mutations."""
    parent = np.zeros(N, dtype=np.int32)
    idx = 1
    stem_end = np.zeros(n_lineages, np.int32)
    for li in range(n_lineages):
        prev = 0
        for _ in range(stem):
            parent[idx] = prev
            prev = idx
            idx += 1
        stem_end[li] = prev
    rem = N - idx
    i_arr = np.arange(rem)
    li_arr = i_arr % n_lineages
    t_arr = i_arr // n_lineages
    u = (rng.random(rem) * (t_arr + 1)).astype(np.int64)
    parent[idx:] = np.where(u == 0, stem_end[li_arr],
                            idx + (u - 1) * n_lineages + li_arr)
    return chain_bigmat(rng, parent, P, n_mut, device)


def device_profile(fn, top=6):
    """One call of fn under torch.profiler: its device ms in all (the self
    device time of the aten ops, which own the kernels they launch) and
    the `top` ops by self device ms."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = {}
    for e in prof.key_averages():
        if e.key.startswith("aten::"):
            ops[e.key] = getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0)) / 1e3
    ranked = sorted(ops.items(), key=lambda kv: -kv[1])
    return {"device_ms": sum(ops.values()),
            "top_ms": {k: round(v, 3) for k, v in ranked[:top]}}


def phase_grouped_pandemic(device, n_nodes=1_000_000, n_sites=30_000,
                           n_leaves=1024, min_group=3):
    """bench.py's replace_1m_grouped shape: n_leaves of the lineage MAT's
    own leaves re-placed in chunks of 512 and in one chunk of 1,024, by
    place_arrays (X5) on their full ancestral sets and by
    place_arrays_grouped (X6) on group_ancestral_batch's inputs:
    bit-identical (winner and runner-up), ms a chunk of each (median of 3
    passes), the host grouping seconds, the peak device memory of each;
    at 1,024 a device profile of one call of each."""
    from usher_tpu_torch.matutils.arrays import _ancestral_set_triplets
    rng = np.random.default_rng(13)
    t0 = time.perf_counter()
    big = synth_lineage_bigmat(rng, n_nodes, n_sites, device)
    res = {"N": big.N, "P": big.P, "build_s": time.perf_counter() - t0,
           "max_occupancy": int(np.diff(big.csc_ptr).max()),
           "leaves": n_leaves, "min_group": min_group}
    slots = rng.choice(np.nonzero(big.is_leaf)[0], size=n_leaves,
                       replace=False).tolist()

    def full_inputs(chunk):
        full = [_ancestral_set_triplets(big, s) for s in chunk]
        K = max(len(f) for f in full)
        pos = np.full((len(chunk), K), big.P, np.int32)
        gval = np.zeros((len(chunk), K), np.uint8)
        for i, f in enumerate(full):
            for k, (c, v) in enumerate(f):
                pos[i, k] = c
                gval[i, k] = v
        return pos, gval, np.zeros((len(chunk), K), bool)

    for cb in (512, 1024):
        chunks = [slots[o:o + cb] for o in range(0, n_leaves, cb)]
        t0 = time.perf_counter()
        grouped = [big.group_ancestral_batch(c, min_group=min_group)
                   for c in chunks]
        group_s = time.perf_counter() - t0
        plain = [full_inputs(c) for c in chunks]
        for pi, gi in zip(plain, grouped):
            same_arrays(f"X6 vs X5 (chunk {cb})",
                        [a for t in big.place_arrays_grouped(
                            *gi, with_second=True) for a in t],
                        [a for t in big.place_arrays(
                            *pi, with_second=True) for a in t])
        row = {"chunks": len(chunks), "group_host_s": group_s,
               "K_full": max(p[0].shape[1] for p in plain),
               "K_res": max(g[0].shape[1] for g in grouped),
               "groups": sum(g[4].shape[0] for g in grouped),
               "K_grp": max(g[4].shape[1] for g in grouped)}
        for name, fn in (("x5", lambda: [big.place_arrays(*p)
                                         for p in plain]),
                         ("x6", lambda: [big.place_arrays_grouped(*g)
                                         for g in grouped])):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            row[f"{name}_ms_per_chunk"] = median_ms(fn, runs=3) / len(chunks)
            row[f"{name}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if cb == n_leaves:
            row["x5_profile"] = device_profile(lambda: big.place_arrays(
                *plain[0]))
            row["x6_profile"] = device_profile(
                lambda: big.place_arrays_grouped(*grouped[0]))
        res[f"chunk_{cb}"] = row
        log(f"  grouped_pandemic chunk {cb}: {json.dumps(row)}")
        del grouped, plain
    res["checks"] = ("place_arrays_grouped == place_arrays (winner and "
                     "runner-up 4-tuples) on every chunk of both sizes")
    return res


# --- the segment-query engine X9 (USHER_TPU_SEG) ----------------------------

@contextlib.contextmanager
def seg_spy(calls):
    """Count the calls of X9 (ops/interval.interval_place_seg_dev) while
    the context is open, from outside the package."""
    from usher_tpu_torch.ops import interval as iv
    fn = iv.interval_place_seg_dev

    def spy(*a, **k):
        calls.append(1)
        return fn(*a, **k)
    iv.interval_place_seg_dev = spy
    try:
        yield
    finally:
        iv.interval_place_seg_dev = fn


def pair_bound(big, pos):
    """The largest per-sample count of (entry, column mutation) pairs of a
    batch: X9's ecap (core/bigmat.py computes the same on the host)."""
    pe = np.minimum(pos, big.P - 1).astype(np.int64)
    cnt = big.csc_ptr[pe + 1] - big.csc_ptr[pe]
    return int(np.where(pos < big.P, cnt, 0).sum(axis=1).max())


def placed_inserts(big, pos, gval, kmiss, slots):
    """Child inserts of samples at their placements (a leaf's parent where
    the winner is a leaf): per sample (internal slot, [(col, par, mut)])
    of its entries against the slot's path state."""
    out = []
    for b, u in enumerate(slots.tolist()):
        u = int(big.parent[u]) if big.is_leaf[u] else int(u)
        state, x = {}, u
        while True:
            lo, hi = int(big.mut_ptr[x]), int(big.mut_ptr[x + 1])
            for c, v in zip(big.mut_col[lo:hi].tolist(),
                            big.mut_mut[lo:hi].tolist()):
                state.setdefault(c, v)
            if int(big.parent[x]) == x:
                break
            x = int(big.parent[x])
        muts = []
        for c, v, miss in zip(pos[b].tolist(), gval[b].tolist(),
                              kmiss[b].tolist()):
            par = state.get(c, int(big.ref[c])) if c < big.P else None
            if c < big.P and not miss and v != par:
                muts.append((c, par, v))
        out.append((u, muts))
    return out


def phase_seg_pandemic(big, n_samples=1024, K=24, K_slots=32, n_append=256):
    """X9 against X5 on bigmat_pandemic's 1,000,000-node x 30,000-site
    BigMAT: 1,024 samples of 24 entries in 32 slots, place_arrays with
    USHER_TPU_SEG=1 (X9) and unset (X5), without and with the runner-up,
    every output field equal; the same after an overlay append of 256 of
    the samples at their placements.  Per engine: ms a call (median of 3)
    and peak device memory; ecap and the true pair bound; the device ms
    by op of one X9 call (torch.profiler)."""
    rng = np.random.default_rng(17)
    pos, gval, kmiss = big_samples(rng, big, n_samples, K, K_slots)
    res = {"N": big.N, "P": big.P, "B": n_samples, "K": K,
           "K_slots": K_slots,
           "mc": int(np.diff(big.csc_ptr).max())}

    def both(tag, second):
        out, calls = {}, []
        for name, env in (("x5", {"USHER_TPU_SEG": "0"}),
                          ("x9", {"USHER_TPU_SEG": "1"})):
            n0 = len(calls)
            with patched_env(env), seg_spy(calls):
                got = big.place_arrays(pos, gval, kmiss, with_second=second)
            if len(calls) - n0 != (name == "x9"):
                raise AssertionError(f"seg_pandemic {tag}: X9 calls "
                                     f"{len(calls) - n0} under {env}")
            out[name] = got if second else (got,)
        same_arrays(f"X9 vs X5 ({tag}, second={second})",
                    [a for t in out["x9"] for a in t],
                    [a for t in out["x5"] for a in t])
        return out["x5"][0]

    for tag in ("snapshot", "overlay"):
        if tag == "overlay":
            # the first n_append samples at their snapshot placements
            t0 = time.perf_counter()
            for u, muts in placed_inserts(big, pos[:n_append],
                                          gval[:n_append],
                                          kmiss[:n_append],
                                          placed[1][:n_append]):
                big.queue_child_insert(u, muts)
            big._flush()
            res["append_s"] = time.perf_counter() - t0
            res["N_after_append"] = big.N
        placed = both(tag, False)
        both(tag, True)
        bound = pair_bound(big, pos)
        row = {"true_pair_bound": bound, "ecap": max(1, bound),
               "expansion_width": K_slots * int(np.diff(big.csc_ptr).max())}
        for name, env in (("x5", {"USHER_TPU_SEG": "0"}),
                          ("x9", {"USHER_TPU_SEG": "1"})):
            with patched_env(env):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                row[f"{name}_ms"] = median_ms(
                    lambda: big.place_arrays(pos, gval, kmiss), runs=3)
                row[f"{name}_peak_gb"] = (torch.cuda.max_memory_allocated()
                                          / 1e9)
                row[f"{name}_second_ms"] = median_ms(
                    lambda: big.place_arrays(pos, gval, kmiss,
                                             with_second=True), runs=3)
        if tag == "snapshot":
            with patched_env({"USHER_TPU_SEG": "1"}):
                row["x9_profile"] = device_profile(
                    lambda: big.place_arrays(pos, gval, kmiss))
        res[tag] = row
        log(f"  seg_pandemic {tag}: {json.dumps(row)}")
    res["checks"] = ("X9 == X5 in all 4 (8 with the runner-up) output "
                     "fields, before and after the overlay append")
    return res


# --- RIPPLES and the tools (ripples/, cli/ripples*_cli.py, the dispatcher) ---

@contextlib.contextmanager
def x13_spy(rec, keep=False):
    """Record each call of X13's device form (ripples/detect._cost_matrix)
    from outside the package: the device, the synchronized ms, the bytes
    its outputs take to the host; with keep, its inputs and outputs for a
    comparison with the plain version afterwards."""
    from usher_tpu_torch.ripples import detect
    fn = detect._cost_matrix

    def spy(st, stp, ref, g, E, miss, cols):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(st, stp, ref, g, E, miss, cols)
        torch.cuda.synchronize()
        rec.setdefault("device", set()).add(st.device.type)
        rec.setdefault("ms", []).append((time.perf_counter() - t0) * 1e3)
        rec.setdefault("d2h_bytes", []).append(
            sum(t.numel() * t.element_size() for t in out))
        rec["shape"] = [int(st.shape[0]), int(st.shape[1])]
        rec.setdefault("gathered_columns", []).append(int(cols.shape[0]))
        if keep:
            rec.setdefault("calls", []).append(
                ((st, stp, ref, g, E, miss, cols), out))
        return out
    detect._cost_matrix = spy
    try:
        yield
    finally:
        detect._cost_matrix = fn


def recombinant_tree(clean=False):
    """tests/test_ripples.py's two constructed trees with the port's
    classes: a recombinant leaf R under the root carrying donor clade d1's
    mutations below 15,000 and acceptor clade a1's above; or (clean) two
    unrelated long branches and no recombinant."""
    from usher_tpu_torch.core.tree import Mutation, Tree

    def mk(pos, mut):
        return Mutation(chrom="c", position=pos, ref_nuc=1, par_nuc=1,
                        mut_nuc=mut)
    T = Tree()
    root = T.create_node("root")
    if clean:
        b1 = T.create_node("b1", root)
        b1.mutations = [mk(1000, 4), mk(2000, 4), mk(3000, 4)]
        T.create_node("L1", b1).mutations = [mk(30000, 2)]
        T.create_node("L2", b1).mutations = [mk(30001, 2)]
        b2 = T.create_node("b2", root)
        b2.mutations = [mk(15000, 2), mk(16000, 2), mk(17000, 2)]
        T.create_node("L3", b2).mutations = [mk(30002, 2)]
        T.create_node("L4", b2).mutations = [mk(30003, 2)]
        return T
    d1 = T.create_node("d1", root)
    d1.mutations = [mk(1100, 4), mk(2200, 4), mk(3300, 4)]
    T.create_node("D1", d1).mutations = [mk(20000, 2)]
    T.create_node("D2", d1).mutations = [mk(20001, 2)]
    a1 = T.create_node("a1", root)
    a1.mutations = [mk(15100, 2), mk(15200, 2), mk(15300, 2)]
    T.create_node("A1", a1).mutations = [mk(20002, 2)]
    T.create_node("A2", a1).mutations = [mk(20003, 2)]
    T.create_node("R", root).mutations = [
        mk(1100, 4), mk(2200, 4), mk(3300, 4),
        mk(15100, 2), mk(15200, 2), mk(15300, 2)]
    T.create_node("X", root).mutations = [mk(25000, 8)]
    return T


def run_plan(plan, root):
    """Run each (step, directory, argv, inputs) of a plan through the
    port's dispatcher (python -m usher_tpu_torch <tool> ...) with cwd
    root/directory, after writing its inputs there: {step: [exit code,
    stdout, stderr]}."""
    import io
    from usher_tpu_torch import __main__ as dispatch
    got = {}
    for step, d, argv, inputs in plan:
        wd = mkdir(os.path.join(root, d))
        for name, text in inputs.items():
            with open(os.path.join(wd, name), "w") as f:
                f.write(text)
        out, err = io.StringIO(), io.StringIO()
        old = sys.argv
        sys.argv = ["usher_tpu_torch", *argv]
        try:
            with contextlib.chdir(wd), contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = dispatch.main()
        finally:
            sys.argv = old
        got[step] = [rc, out.getvalue(), err.getvalue()]
    return got


CPU_PLAN = """
import json, sys
sys.path.insert(0, {repo!r})
import chip_smoke
with open({plan!r}) as f:
    plan = json.load(f)
with open({result!r}, "w") as f:
    json.dump(chip_smoke.run_plan(plan, {root!r}), f)
"""


def rows_of(root, d, name="recombination.tsv"):
    with open(os.path.join(root, d, "out", name)) as f:
        return [l for l in f.read().splitlines()[1:] if l]


def phase_ripples_fixture(kern, built_pb, placed_pb):
    """ripples on tests/test_ripples.py's two trees and on the fixture's
    pb (the defaults, -n 1 -l 2, -S/-E halves of -n 1 -l 1 -p 1, -s),
    then ripplesInit, ripplesUtils and ripples-filter on them, and
    transpose_vcf (round trip), compareVCF and check_samples_place on the
    fixture VCF and pbs, all through the port's dispatcher, on the card
    and in a USHER_TPU_PLATFORM=cpu subprocess: exit codes, stdout,
    stderr and every file byte-equal; R found, the clean tree quiet, the
    halves the whole; X13 ran on cuda; no kernel launched."""
    from usher_tpu_torch.io.pbio import load_mat_pb, save_mat_pb
    fx = os.path.join(REPO, "tests", "fixtures")
    gvcf = os.path.join(fx, "global_samples.vcf")
    nvcf = os.path.join(fx, "new_samples.vcf")
    ref_fa = os.path.join(fx, "NC_045512v2.fa")
    out = os.path.join(WORK, "ripples_fixture")
    ins = mkdir(os.path.join(out, "in"))
    pbs = {}
    for name, T in (("recomb", recombinant_tree()),
                    ("clean", recombinant_tree(clean=True))):
        pbs[name] = os.path.join(ins, f"{name}.pb")
        save_mat_pb(T, pbs[name])
    T = load_mat_pb(built_pb)
    T.uncondense_leaves()
    leaves = T.get_leaves_ids()
    samples = "".join(leaves[i] + "\n" for i in (0, 97, 301))
    recomb_leaves = recombinant_tree().get_leaves_ids()
    pvals = ("#recomb\ta\tb\tdonor\tdsib\tc\tacceptor\tasib\n"
             f"{recomb_leaves[0]}\tx\tx\t{recomb_leaves[1]}\ty\tx\td1\tn\n"
             f"R\tx\tx\td1\ty\tx\ta1\ty\n")
    halves = ["-n", "1", "-l", "1", "-p", "1"]
    rip = ["ripples", "-d", "out", "-i"]
    plan = [
        ("recomb", "recomb", [*rip, pbs["recomb"], "-n", "1", "-l", "3",
                              "-p", "3"], {}),
        ("clean", "clean", [*rip, pbs["clean"], "-n", "1", "-l", "3",
                            "-p", "3"], {}),
        ("fx_defaults", "fx_defaults", [*rip, built_pb], {}),
        ("fx_n1_l2", "fx_n1_l2", [*rip, built_pb, "-n", "1", "-l", "2"], {}),
        ("fx_S0_E30", "fx_S0_E30", [*rip, built_pb, *halves, "-S", "0",
                                    "-E", "30"], {}),
        ("fx_S30_E60", "fx_S30_E60", [*rip, built_pb, *halves, "-S", "30",
                                      "-E", "60"], {}),
        ("fx_S0_E60", "fx_S0_E60", [*rip, built_pb, *halves, "-S", "0",
                                    "-E", "60"], {}),
        ("fx_samples", "fx_samples", [*rip, built_pb, "-n", "2", "-l", "1",
                                      "-s", "s.txt"], {"s.txt": samples}),
        ("init_recomb", "init_recomb", ["ripplesInit", "-i", pbs["recomb"],
                                        "-l", "3", "-n", "2"], {}),
        ("init_fx", "init_fx", ["ripplesInit", "-i", built_pb], {}),
        ("utils_recomb", "utils_recomb", [
            "ripplesUtils", pbs["recomb"], "--pvals", "pvals.txt",
            "--data-dir", "data"], {"pvals.txt": pvals}),
        ("filter_recomb", "filter_recomb", [
            "ripples-filter", "-i", pbs["recomb"], "-r",
            "../recomb/out/recombination.tsv", "-o", "filtered.tsv"], {}),
        ("filter_fx", "filter_fx", [
            "ripples-filter", "-i", built_pb, "-r",
            "../fx_S0_E60/out/recombination.tsv", "-o", "filtered.tsv"], {}),
        ("tv_encode", "tv", ["transpose_vcf", "encode", "-v", gvcf, "-o",
                             "g.tvcf"], {}),
        ("tv_names", "tv", ["transpose_vcf", "print_name", "-i", "g.tvcf"],
         {}),
        ("tv_to_vcf", "tv", ["transpose_vcf", "to_vcf", "-i", "g.tvcf",
                             "-o", "back.vcf", "-r", ref_fa], {}),
        ("tv_to_fa", "tv", ["transpose_vcf", "to_fa", "-i", "g.tvcf", "-o",
                            "back.fa", "-r", ref_fa], {}),
        ("tv_compare", "tv", ["compareVCF", gvcf, "back.vcf"], {}),
        ("compare_same", "compare", ["compareVCF", nvcf, nvcf], {}),
        ("compare_disjoint", "compare", ["compareVCF", nvcf, gvcf], {}),
        ("check_placed", "check", ["check_samples_place", "-i", built_pb,
                                   "-v", nvcf, "-o", placed_pb], {}),
        ("check_not_placed", "check", ["check_samples_place", "-v", nvcf,
                                       "-o", built_pb], {}),
    ]
    rec = {}
    before = kern.counts()
    t0 = time.perf_counter()
    with x13_spy(rec):
        card = run_plan(plan, os.path.join(out, "cuda"))
    card_s = time.perf_counter() - t0
    after = kern.counts()
    launches = {k: after[k] - before[k] for k in after}
    plan_path = os.path.join(out, "plan.json")
    result_path = os.path.join(out, "cpu.json")
    with open(plan_path, "w") as f:
        json.dump(plan, f)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", CPU_PLAN.format(
        repo=REPO, plan=plan_path, result=result_path,
        root=os.path.join(out, "cpu"))],
        env=dict(os.environ, USHER_TPU_PLATFORM="cpu", PYTHONPATH=REPO),
        check=True, timeout=600, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    cpu_s = time.perf_counter() - t0
    with open(result_path) as f:
        cpu = json.load(f)
    for step, *_ in plan:
        if card[step] != cpu[step]:
            raise AssertionError(f"ripples_fixture {step}: exit code or "
                                 "output differs between card and CPU")
    card_files = dir_files(os.path.join(out, "cuda"))
    if card_files != dir_files(os.path.join(out, "cpu")):
        raise AssertionError("ripples_fixture: files differ between card "
                             "and CPU")
    want_rc = {"check_not_placed": 1}
    bad = {s: r[0] for s, r in card.items() if r[0] != want_rc.get(s, 0)}
    if bad:
        raise AssertionError(f"ripples_fixture exit codes {bad}")
    root = os.path.join(out, "cuda")
    if {r.split("\t")[0] for r in rows_of(root, "recomb")} != {"R"}:
        raise AssertionError("ripples_fixture: R not reported alone")
    if rows_of(root, "clean"):
        raise AssertionError("ripples_fixture: the clean tree reported")
    for name in ("recombination.tsv", "descendants.tsv"):
        if (rows_of(root, "fx_S0_E30", name) + rows_of(root, "fx_S30_E60",
                                                       name)
                != rows_of(root, "fx_S0_E60", name)):
            raise AssertionError(f"ripples_fixture: -S/-E halves of {name} "
                                 "are not the whole")
    if rec.get("device") != {"cuda"} or any(launches.values()):
        raise AssertionError(f"ripples_fixture: X13 on {rec.get('device')},"
                             f" launches {launches}")
    return {"outputs": f"{len(plan)} dispatcher runs, {len(card_files)} "
                       "files byte-equal, card and CPU",
            "card_s": card_s, "cpu_subprocess_s": cpu_s,
            "x13_calls": len(rec["ms"]),
            "rows": {s: len(rows_of(root, d)) for s, d, a, _ in plan
                     if a[0] == "ripples"},
            "launches": launches}


def plant_recombinants(pb, out_pb, n_planted, seed, split=15_000,
                       min_leaves=10, max_leaves=400):
    """The realistic pb with n_planted recombinant leaves under the root
    (build_recombinant_tree's shape at full size): each takes a donor
    node's path genotype at positions below `split` and a disjoint
    acceptor node's at or above it, donor and acceptor being clades of
    min_leaves to max_leaves leaves with at least 3 path mutations on
    their side of the split spanning 1,000 bases or more (ripples' -l 3
    and -r 1000 defaults).  Returns the planted names and set-up seconds."""
    from usher_tpu_torch.core.tree import Mutation
    from usher_tpu_torch.io.pbio import load_mat_pb, save_mat_pb
    from usher_tpu_torch.ripples.detect import pruned_sample_mutations
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    T = load_mat_pb(pb)
    nodes = T.depth_first_expansion()
    leaves = {}
    for nd in reversed(nodes):
        leaves[nd.identifier] = (1 if nd.is_leaf() else
                                 sum(leaves[c.identifier]
                                     for c in nd.children))
    clades = [nd for nd in nodes[1:]
              if min_leaves <= leaves[nd.identifier] <= max_leaves]
    planted, used = [], []

    def disjoint(a, b):
        return (a.dfs_end_idx <= b.dfs_idx or b.dfs_end_idx <= a.dfs_idx)
    for _ in range(100_000):
        if len(planted) == n_planted:
            break
        d, a = (clades[int(i)] for i in rng.integers(0, len(clades), 2))
        if not disjoint(d, a) or any(not disjoint(x, y) for x in (d, a)
                                     for y in used):
            continue
        low = [m for m in pruned_sample_mutations(d) if m.position < split]
        high = [m for m in pruned_sample_mutations(a)
                if m.position >= split]
        if (len(low) < 3 or len(high) < 3
                or low[-1].position - low[0].position < 1000):
            continue
        r = T.create_node(f"recomb_{len(planted)}", T.root)
        for m in low + high:
            r.add_mutation(Mutation(m.chrom, m.position, m.ref_nuc,
                                    m.ref_nuc, m.mut_nuc))
        used += [d, a]
        planted.append(r.identifier)
    if len(planted) < n_planted:
        raise AssertionError(f"planted {len(planted)} of {n_planted} "
                             "recombinants: too few donor/acceptor clades")
    save_mat_pb(T, out_pb)
    return planted, time.perf_counter() - t0


def run_ripples(argv):
    """The port's ripples CLI on the card, its stderr kept: (wall s, stderr
    text); the CLI must exit 0."""
    import io
    from usher_tpu_torch.cli.ripples_cli import main
    err = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        sys.stderr.write(err.getvalue()[-3000:])
        raise AssertionError(f"ripples {argv} returned {rc}")
    return wall, err.getvalue()


def phase_ripples_realistic(kern, pb, n_planted=4, seed=23):
    """ripples on the realistic pb (100,000 nodes x 30,000 sites, full
    width): a day's new samples checked for recombination (-s with
    n_planted recombinant leaves planted under the root, the -l 3 -n 10
    -p 3 defaults), each planted leaf reported with recomb_parsimony + 3
    <= original_parsimony, and ripples-filter on that run's
    recombination.tsv; one fleet worker's share (-S 0 -E 32 on the
    unplanted pb), whose rows are those of -S 0 -E 16 then -S 16 -E 32;
    X13 on the card against _cost_matrix_plain at the gathered columns for
    every candidate of the -S 0 -E 16 run, bit for bit, and the device ms
    by op of one X13 call.  Per run: wall, candidates, X13 ms a candidate,
    bytes copied to the host a candidate, host share (wall outside X13)
    and peak device memory."""
    from usher_tpu_torch.ripples.detect import _cost_matrix_plain
    out = os.path.join(WORK, "ripples_realistic")
    planted_pb = os.path.join(mkdir(out), "planted.pb")
    planted, plant_s = plant_recombinants(pb, planted_pb, n_planted, seed)
    with open(os.path.join(out, "planted.txt"), "w") as f:
        f.write("".join(p + "\n" for p in planted))
    before = kern.counts()
    res = {"planted": planted, "plant_setup_s": plant_s}
    runs = (("samples", planted_pb, ["-s", os.path.join(out, "planted.txt")]),
            ("S0_E32", pb, ["-S", "0", "-E", "32"]),
            ("S0_E16", pb, ["-S", "0", "-E", "16"]),
            ("S16_E32", pb, ["-S", "16", "-E", "32"]))
    kept = None
    for name, src, args in runs:
        rec = {}
        with x13_spy(rec, keep=name == "S0_E16"):
            wall, err = run_ripples(["-i", src, "-d",
                                     os.path.join(out, name, "out"), *args])
        peak = torch.cuda.max_memory_allocated() / 1e9
        x13_s = sum(rec.get("ms", [])) / 1e3
        n = len(rec.get("ms", []))
        res[name] = {
            "wall_s": wall,
            "candidates": int(err.split("Found ")[1].split()[0]),
            "x13_calls": n, "x13_device": sorted(rec.get("device", [])),
            "x13_ms_per_candidate": (statistics.median(rec["ms"]) if n
                                     else None),
            "d2h_bytes_per_candidate": (statistics.median(rec["d2h_bytes"])
                                        if n else None),
            "gathered_columns": rec.get("gathered_columns"),
            "host_share": 1 - x13_s / wall, "peak_device_gb": peak,
            "rows": len(rows_of(out, name))}
        if rec.get("device", {"cuda"}) != {"cuda"} or not n:
            raise AssertionError(f"ripples_realistic {name}: X13 calls "
                                 f"{n} on {rec.get('device')}")
        if name == "S0_E16":
            kept = rec["calls"]
        log(f"  ripples_realistic {name}: {json.dumps(res[name])}")
    # every planted leaf reported, each with the improvement
    found = {}
    for r in rows_of(out, "samples"):
        f = r.split("\t")
        if int(f[11]) + 3 > int(f[9]):
            raise AssertionError(f"ripples_realistic row {f}: no "
                                 "improvement of 3")
        found.setdefault(f[0], []).append(f)
    if set(planted) - set(found):
        raise AssertionError(f"ripples_realistic: planted {planted}, "
                             f"reported {sorted(found)}")
    res["samples"]["reported"] = {p: len(found[p]) for p in planted}
    for name in ("recombination.tsv", "descendants.tsv"):
        if (rows_of(out, "S0_E16", name) + rows_of(out, "S16_E32", name)
                != rows_of(out, "S0_E32", name)):
            raise AssertionError(f"ripples_realistic: -S/-E halves of "
                                 f"{name} are not the whole")
    # X13 against its plain version on the card, at the gathered columns
    plain_ms = []
    for (st, stp, ref, g, E, miss, cols), got in kept:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        csum, total, hu = _cost_matrix_plain(st, stp, ref, None, g[None],
                                             E[None], miss[None])
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
        if not (torch.equal(csum[:, cols], got[0])
                and torch.equal(total, got[1]) and torch.equal(hu, got[2])):
            raise AssertionError("X13 device form != _cost_matrix_plain")
        del csum, total, hu
    from usher_tpu_torch.ripples.detect import _cost_matrix
    res["x13_vs_plain"] = {"candidates": len(kept), "max_abs_err": 0,
                           "plain_ms_per_candidate":
                               statistics.median(plain_ms),
                           "x13_profile": device_profile(
                               lambda: _cost_matrix(*kept[-1][0]))}
    del kept
    torch.cuda.empty_cache()
    # ripples-filter on the -s run's candidates
    from usher_tpu_torch.cli.ripples_filter_cli import main as rfilter
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(sys.stdout):
        rc = rfilter(["-i", planted_pb, "-r",
                      os.path.join(out, "samples", "out",
                                   "recombination.tsv"),
                      "-o", os.path.join(out, "filtered.tsv")])
    if rc != 0:
        raise AssertionError(f"ripples-filter returned {rc}")
    with open(os.path.join(out, "filtered.tsv")) as f:
        frows = [l.split("\t") for l in f.read().splitlines()[1:] if l]
    res["filter"] = {"wall_s": time.perf_counter() - t0,
                     "trios": len(frows),
                     "significant": sum(r[-1] == "yes" for r in frows)}
    after = kern.counts()
    res["launches"] = {k: after[k] - before[k] for k in after}
    return res


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
    wide = Kernels(ps, pmesh)
    wide_res = phase("kernel_wide", phase_kernel_wide, wide, device)

    # set-up of the realistic run (tree, pb, VCF) before the main path
    T, pb, vcf, setup = realistic_setup(genome, 1024, 5)
    log(f"realistic setup: {json.dumps(setup)}")

    # --- the compiled host scanners: built here, at their first use; every
    # --- CLI below reads its VCF (and --pb-direct its pb) through them ---
    phase("native", phase_native, kern, pb, vcf)

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
    keep = {}
    pandemic = phase("bigmat_pandemic", phase_bigmat_pandemic, kern, device,
                     keep)
    big_counts = pandemic["launches"]
    # ----------------------------------------------------------------------

    # --- the --pb-direct path: the counters cover its CLI runs, which ----
    # --- launch neither B1 nor B2 (BigMAT's X5 and X8 score them) --------
    kern.reset_counts()
    phase("direct_fixture", phase_direct_fixture, kern,
          os.path.join(WORK, "fixture", "out.pb"))
    direct_real = phase("direct_realistic", phase_direct_realistic, kern,
                        pb, vcf, out_dir, 1024, 64)
    direct_counts = kern.counts()
    log(f"--pb-direct path launches: {json.dumps(direct_counts)}")
    setup_spans = {
        "realistic_e2e": {k: round(stages.get(k, 0.0), 3)
                          for k in ("cli:load_pb", "cli:read_vcf")},
        "direct_realistic": {
            m: {k: round(direct_real[m]["seconds"][k], 3) for k in (
                "load_mat_arrays_s", "read_vcf_s", "placer_init_s")}
            for m in ("sync", "pipelined")}}
    log(f"set-up with the compiled scanner: {json.dumps(setup_spans)}")
    # ----------------------------------------------------------------------

    # --- the matOptimize path: the counters cover its three phases, which --
    # --- score with torch ops (X3, X11, X7, X12) and launch none of the ----
    # --- five kernels --------------------------------------------------------
    kern.reset_counts()
    phase("optimize_fixture", phase_optimize_fixture,
          os.path.join(WORK, "fixture", "out.pb"), smi)
    phase("optimize_realistic", phase_optimize_realistic, pb, smi)
    phase("optimize_pandemic", phase_optimize_pandemic, keep["big"], smi)
    opt_counts = kern.counts()
    log(f"matOptimize path launches: {json.dumps(opt_counts)}")
    if any(opt_counts.values()):
        raise AssertionError(f"matOptimize path: launches {opt_counts}")
    # ----------------------------------------------------------------------

    # --- X9 on the same BigMAT: after optimize_pandemic, whose check of ----
    # --- X7's device expansion against host events would not hold over ----
    # --- the overlay this phase appends; its own window of launches --------
    kern.reset_counts()
    phase("seg_pandemic", phase_seg_pandemic, keep.pop("big"))
    seg_counts = kern.counts()
    # ----------------------------------------------------------------------

    # --- the usher-sampled path: the counters cover its CLI runs on the ----
    # --- card (B1 == score_samples calls, checked in each phase) -----------
    kern.reset_counts()
    sampled_fx = phase("sampled_fixture", phase_sampled_fixture, kern,
                       os.path.join(WORK, "fixture", "out.pb"))
    phase("sampled_realistic", phase_sampled_realistic, kern, pb, vcf, 256)
    sampled_counts = kern.counts()
    log(f"usher-sampled path launches: {json.dumps(sampled_counts)}")
    # ----------------------------------------------------------------------

    # --- the servers: server_realistic zeroes the counters before each -----
    # --- daemon serves and reads them after ----------------------------------
    server = phase("server_realistic", phase_server_realistic, kern, pb, vcf,
                   64)
    # ----------------------------------------------------------------------

    # --- the matUtils path: the counters cover its fixture and realistic ---
    # --- runs on the card (B1 == score_samples calls, checked per run) -----
    kern.reset_counts()
    mu_fx = phase("matutils_fixture", phase_matutils_fixture, kern)
    mu_real = phase("matutils_realistic", phase_matutils_realistic, kern, pb,
                    vcf)
    mu_counts = kern.counts()
    log(f"matUtils path launches: {json.dumps(mu_counts)}")
    mu_calls = mu_fx["totals"]["score_samples"] + sum(
        r["calls"]["score_samples"] for r in mu_real.values()
        if isinstance(r, dict) and "calls" in r)
    if mu_counts["B1"] != mu_calls or not mu_calls:
        raise AssertionError(f"matUtils path: B1 launches {mu_counts} != "
                             f"score_samples calls {mu_calls}")
    # ----------------------------------------------------------------------
    phase("grouped_pandemic", phase_grouped_pandemic, device)

    # --- RIPPLES and the tools: the counters cover ripples_fixture and -----
    # --- ripples_realistic, whose device work (X13) is torch ops; with ----
    # --- seg_pandemic and the X9 run of direct_realistic they make the ----
    # --- new paths, which must launch none of the five kernels ------------
    kern.reset_counts()
    phase("ripples_fixture", phase_ripples_fixture, kern,
          os.path.join(WORK, "fixture", "out.pb"),
          os.path.join(WORK, "fixture", "out2.pb"))
    phase("ripples_realistic", phase_ripples_realistic, kern, pb)
    rip_counts = kern.counts()
    new_path_counts = {k: rip_counts[k] + seg_counts[k]
                       + direct_real["seg"]["launches"][k]
                       for k in rip_counts}
    log(f"RIPPLES, X9 and tools path launches: {json.dumps(new_path_counts)}")
    if any(new_path_counts.values()):
        raise AssertionError(f"RIPPLES / X9 paths: launches "
                             f"{new_path_counts}")
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
    if direct_counts["B1"] or direct_counts["B2"]:
        raise AssertionError(f"--pb-direct path: launches {direct_counts}")
    main_shapes = results["realistic_e2e"]["main_shapes"]
    log("parent_states at the main-path shape: "
        f"{main_shapes['parent_states_ms']:.3f} ms")
    one_segment = {
        "headline": {k: results["kernel_headline"][k] for k in (
            "B1_ms", "B1_fused_ms", "B2_ms", "B2_fused_ms")},
        "genome": {k: results["kernel_genome"][k] for k in (
            "B1_ms", "B1_fused_ms", "B2_ms", "B2_fused_ms")},
        "main_path": {name: {k: main_shapes[name][k]
                             for k in ("ms", "fused_ms")}
                      for name in ("B1", "B2")}}
    log(f"one-segment plans (ms): {json.dumps(one_segment)}")
    genome_ms = kern.ms["kernel_genome"]
    genome_bound = kern.bounds["kernel_genome"]
    mesh_ms = kern.ms["mesh_kernel"]
    src = "usher_tpu_torch/csrc/placement_sparse.cu"

    def entry(name, replaces, launches, err, ms, plain_ms, bnd, **more):
        # library_ms is null throughout: no single PyTorch call computes
        # the sparse placement score or its tie-broken argmin.  The
        # RIPPLES, X9 and tools paths' count is the kernel's own (mesh B1
        # launches the B1 kernel), checked to be 0 above
        kernel = name.split()[0] if name.split()[0] != "mesh" else "B1"
        return dict(name=name, route="cuda", source=src, replaces=replaces,
                    launches=launches, max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=bnd["bound_ms"],
                    bound_by=bnd["bound_by"], library_ms=None,
                    bytes_ms=bnd["bytes_ms"], ops_ms=bnd["ops_ms"],
                    ripples_path_launches=new_path_counts[kernel], **more)

    def fused(name):
        """fused_ms, fused_bound_ms, the main-path shape's numbers and the
        wide widths' (column segments)."""
        main = main_shapes[name]
        by_width = {P: {k: dict(v, bound=v["bound"]["bound_ms"])
                        for k, v in res.items() if k.startswith(name)}
                    for P, res in wide_res["by_width"].items()}
        return dict(wide_widths=list(WIDE_WIDTHS),
                    wide_max_abs_err=max(wide.err[name],
                                         wide.err[name + " fused"]),
                    wide=by_width,
                    fused_ms=genome_ms[name + " fused"][0],
                    fused_bound_ms=genome_bound[name + " fused"]["bound_ms"],
                    fused_max_abs_err=kern.err[name + " fused"],
                    main_path=dict(main, bound_ms=main["bound"]["bound_ms"],
                                   fused_bound_ms=main["fused_bound"][
                                       "bound_ms"]))

    # launches of the usher-sampled and server paths beside the dense one's
    mesh_shard_launches = (sampled_fx["score_samples_calls"]["calls_mesh"]
                           * MESH_SHARDS)
    new_paths = {
        k: {"sampled_path_launches": sampled_counts[k],
            "usher_server_launches": server["usher_server_launches"][k],
            "socket_server_launches": server["socket_launches"][k]}
        for k in ("B1", "B2")}
    kernels = [
        entry("B1 score_entries_T",
              "usher_tpu/ops/placement_pallas.py:176", counts["B1"],
              max(kern.err["B1"], kern.err["B1 fused"]), *genome_ms["B1"],
              genome_bound["B1"], shape="kernel_genome", **fused("B1"),
              matutils_path_launches=mu_counts["B1"], **new_paths["B1"]),
        entry("B2 placement_reduce",
              "usher_tpu/ops/placement_pallas.py:119", counts["B2"],
              max(kern.err["B2"], kern.err["B2 fused"]), *genome_ms["B2"],
              genome_bound["B2"], shape="kernel_genome",
              mesh_path_launches=mesh_counts["B2"], **fused("B2"),
              **new_paths["B2"]),
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
              one_shard_ms=mesh_ms["one_shard_b1_kernel_ms"],
              one_shard_bound_ms=kern.bounds["mesh_kernel"][
                  "one_shard_B1"]["bound_ms"],
              main_shapes=mesh_real["main_shapes"],
              sampled_path_launches=mesh_shard_launches,
              wrapper="usher_tpu_torch/parallel/mesh.py"),
        entry("B1-3d score_entries_3d",
              "usher_tpu/ops/placement_pallas.py:300",
              counts["B1-3d"] + mesh_counts["B1-3d"] + big_counts["B1-3d"],
              kern.err["B1-3d"], *genome_ms["B1-3d"], genome_bound["B1-3d"],
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
