"""Sparse-sample placement scoring (counterpart of
usher_tpu/ops/placement_pallas.py).

A sample has a few dozen VCF entries out of P segregating sites, and at every
no-entry position the (sample, node) term does not depend on the sample.  So

  score[n,b] = base[n]    + sum_k corr(n, b, pos[b,k])
  nc[n,b]    = nc_base[n] + sum_k corr_nc(n, b, pos[b,k])

with per-node row sums base, nc_base (and node_num_mut, the branch-mutation
count) and corrections that read st/stp at the K entry columns only.
Hand-written CUDA kernels (csrc/placement_sparse.cu) evaluate both:

  B1     ``score_entries_T``  the [N, B] score and num_common matrices, with
                              base/nc_base given by the caller; replaces
                              placement_pallas._score_entries_T
         ``score_sparse_stp_T``  the fused call of the main path: one B1
                              launch that also sums base, nc_base and
                              node_num_mut from the rows it stages
  B1-spr ``score_entries_T(spr=True)``, reached through ``score_cols_T``:
                              B1 with the SPR base semantics, over the
                              pointer-doubled column states of a CSR BigMAT
                              (caller-given full-genome base/nc_base);
                              replaces placement_pallas.score_cols_T
  B1-3d  ``score_entries_3d`` B1 / B1-spr with the outputs left in
                              sample-tile-major tiles [bt, n_pad, tb];
                              replaces placement_pallas._score_entries_3d
  B2     ``placement_reduce`` B1 plus validity and the tie-broken argmin,
                              through one partial per kernel block
                              (``placement_partials``) merged here; with
                              ``base=None`` the row sums are taken in the
                              kernel; replaces the kernel of
                              placement_pallas.placement_step_sparse

parallel/mesh.py runs the fused B1 and the fused B2 partials once per shard
of a device mesh (mesh B1), on the shard's own device and stream.

What bounds the kernels on an H100: reading st and stp once (2 bytes per node
and column) at a wide position axis and a small batch, the integer work of
the (node, sample, entry) triples at a narrow axis or a large batch.  The
design (details and the ptxas report in the source note of the .cu file):
one persistent block per SM walks row groups through a ring of shared-memory
stages that one thread fills with asynchronous bulk copies, so loading
overlaps scoring; lanes of a warp split a sample's K slots and fold their
sums with shuffles, so a batch of 64 fills a block as a batch of 1,024 does;
and while a stage is resident the block sweeps it against ``ref``, four cells
per 32-bit word, for the three row sums, which therefore cost no second pass
over device memory.  Four slots of a sample (a quad of the slot table) are
scored at once with byte-parallel arithmetic.  ``launch_plan`` chooses rows
per group, ring stages, lanes per sample and the grid from the shapes and
the device's limits; where one row of st and stp (and ref) does not fit a
stage, a row is cut into column segments that the kernels score one after
another and add up, so any position width is taken.  ptxas (sm_90a, CUDA
12.8, 1,024 threads a block, so at most 64 registers a thread): the B1
kernel 62 registers where a stage holds fewer than four rows and 64 where it
holds more or holds a column segment, no spills, in each of its spr and
tiled instantiations; the B2 kernel 64 registers with 8 to 124 bytes spilt.

Each kernel has a plain PyTorch twin (``*_plain``) built from column gathers
``st[:, pos_chunk]``, chunked over the batch; ``row_reductions`` is the
plain twin of the kernels' folded row sums and counts its calls in
``row_reductions.calls`` (no CUDA main path reaches it).  The wrappers run
the kernel on CUDA tensors and the plain twin on CPU tensors, and never fall
back from one to the other; each counts its kernel launches in
``<wrapper>.launches`` (``score_entries_T.launches`` counts every B1 launch,
the fused ones included, and ``score_entries_T.launches_spr`` the spr=True
ones apart).  The kernels read raw pointers, so a wrapper raises on a CUDA
tensor that is not contiguous or lies on another device than ``st``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core.nuc import N as NUC_N
from ._build import check, load_library
from .placement import BIG, parent_states, reduce_best, valid_mask

CHUNK_ELEMS = 1 << 26   # elements of one [N, Bc, K] gathered block (plain)
POS_BITS = 22           # position field of the kernels' slot word
MAX_ROWS = 32           # node rows of one ring stage, at most
MAX_STAGES = 3          # ring stages the plan asks for
ROW_CHUNK = 4           # rows that share one decoded slot word
SLOTS_PER_LANE = 8      # slots a lane walks before more lanes pay (measured)


# --- host-side slot encoding ----------------------------------------------

def _k_slots(kmax: int, k_slots) -> int:
    K = k_slots or 8
    while K < max(kmax, 1):
        K *= 2
    return K


def sparsify(samples_mutations, pos_index, P, k_slots=None):
    """Mutation lists -> (pos [B,K] int32, gval [B,K] uint8, kmiss [B,K]
    bool), numpy, with K the smallest power of two >= 8 holding every
    sample's entries.  Padding slots carry pos = P."""
    B = len(samples_mutations)
    lens = np.fromiter((len(m) for m in samples_mutations),
                       dtype=np.int64, count=B)
    K = _k_slots(int(lens.max()) if B else 1, k_slots)
    pos = np.full((B, K), P, dtype=np.int32)
    gval = np.zeros((B, K), dtype=np.uint8)
    kmiss = np.zeros((B, K), dtype=bool)
    total = int(lens.sum())
    if total:
        flat = [m for muts in samples_mutations for m in muts]
        try:
            fpos = np.fromiter((pos_index[m.position] for m in flat),
                               dtype=np.int32, count=total)
        except KeyError:
            bad = next(m.position for m in flat
                       if m.position not in pos_index)
            raise KeyError(f"sample position {bad} not in MAT")
        fmiss = np.fromiter((m.is_missing for m in flat),
                            dtype=bool, count=total)
        fval = np.fromiter((m.mut_nuc for m in flat),
                           dtype=np.uint8, count=total)
        b_idx = np.repeat(np.arange(B), lens)
        starts = np.cumsum(lens) - lens
        k_idx = np.arange(total) - np.repeat(starts, lens)
        pos[b_idx, k_idx] = fpos
        gval[b_idx, k_idx] = np.where(fmiss, NUC_N, fval)
        kmiss[b_idx, k_idx] = fmiss
    return pos, gval, kmiss


def sparsify_dense(g, E, miss, k_slots=None):
    """Dense (g, E, miss) encoding -> sparse slot arrays, numpy.  Requires
    g == ref at ~E positions (FlatMAT.encode_samples guarantees it)."""
    g = np.asarray(g)
    E = np.asarray(E)
    miss = np.asarray(miss)
    B, P = g.shape
    counts = E.sum(1)
    K = _k_slots(int(counts.max()) if B else 1, k_slots)
    pos = np.full((B, K), P, dtype=np.int32)
    gval = np.zeros((B, K), dtype=np.uint8)
    kmiss = np.zeros((B, K), dtype=bool)
    b_idx, p_idx = np.nonzero(E)          # row-major: sorted by (b, p)
    if len(b_idx):
        starts = np.cumsum(counts) - counts
        k_idx = np.arange(len(b_idx)) - starts[b_idx]
        pos[b_idx, k_idx] = p_idx
        gval[b_idx, k_idx] = g[b_idx, p_idx]
        kmiss[b_idx, k_idx] = miss[b_idx, p_idx]
    return pos, gval, kmiss


# --- per-node row reductions (torch ops on either device) ------------------

def row_reductions(st, stp, ref):
    """(base, nc_base, node_num_mut) [N] int32: the no-entry (g == ref) score
    and num_common of every node, and its branch-mutation count.  Chunked
    over rows so the [rows, P] temporaries stay within ``CHUNK_ELEMS``.  The
    plain twin of the sums the fused kernels take from their staged rows."""
    row_reductions.calls += 1
    N, P = st.shape
    out = torch.empty((3, N), dtype=torch.int32, device=st.device)
    r = ref[None, :]
    rc = max(1, CHUNK_ELEMS // max(1, P))
    for n0 in range(0, N, rc):
        s, sp = st[n0:n0 + rc], stp[n0:n0 + rc]
        bm = s != sp
        matched0 = (r & s) != 0
        out[0, n0:n0 + rc] = torch.where(bm & ~matched0, sp != r,
                                         s != r).sum(1, dtype=torch.int32)
        out[1, n0:n0 + rc] = (bm & matched0).sum(1, dtype=torch.int32)
        out[2, n0:n0 + rc] = bm.sum(1, dtype=torch.int32)
    return out[0], out[1], out[2]


row_reductions.calls = 0


def _slot_fields(P, ref, pos):
    """(kvalid, position clipped to the table, ref nibble at it) per slot."""
    pos = pos.long()
    kvalid = (pos >= 0) & (pos < P)
    pc = torch.where(kvalid, pos, 0)
    return kvalid, pc, ref[pc]


# --- B1: [N, B] score / num_common ------------------------------------------

def score_entries_T_plain(st, stp, ref, base, nc_base, pos, gval, kmiss,
                          spr: bool = False):
    """Plain twin of B1 (spr=False) and B1-spr (spr=True).  st/stp [N,P]
    uint8, ref [P] uint8, base/nc_base [N] int32, pos [B,K] int (slots with
    pos outside [0, P) are padding), gval [B,K] uint8, kmiss [B,K] bool.
    spr selects what an entry column takes out of base: the placement
    no-entry term (A_r != ref) or the SPR E=1-everywhere term
    ((ref & A_r) == 0).  Returns (score_T, nc_T) [N,B] int32."""
    N, P = st.shape
    B, K = pos.shape
    kvalid, pc, refk = _slot_fields(P, ref, pos)
    score_t = torch.empty((N, B), dtype=torch.int32, device=st.device)
    nc_t = torch.empty((N, B), dtype=torch.int32, device=st.device)
    bc = max(1, min(B, CHUNK_ELEMS // max(1, N * K)))
    for b0 in range(0, B, bc):
        sl = slice(b0, b0 + bc)
        cols = pc[sl]
        n_b = cols.shape[0]
        s = st[:, cols.reshape(-1)].view(N, n_b, K)        # [N,Bc,K]
        sp = stp[:, cols.reshape(-1)].view(N, n_b, K)
        gv, rk = gval[sl][None], refk[sl][None]
        kv, km = kvalid[sl][None], kmiss[sl][None]
        bm = s != sp
        matched = (gv & s) != 0
        matched_r = (rk & s) != 0
        a = torch.where(bm & ~matched, sp, s)
        term1 = kv & ~km & ((gv & a) == 0)
        a_r = torch.where(bm & ~matched_r, sp, s)
        sub = kv & (((rk & a_r) == 0) if spr else (a_r != rk))
        nca = kv & bm & matched
        ncb = kv & bm & matched_r
        score_t[:, sl] = (base[:, None] + term1.sum(-1, dtype=torch.int32)
                          - sub.sum(-1, dtype=torch.int32))
        nc_t[:, sl] = (nc_base[:, None] + nca.sum(-1, dtype=torch.int32)
                       - ncb.sum(-1, dtype=torch.int32))
    return score_t, nc_t


def _check_state(st, stp, ref, base, nc_base, pos, gval, kmiss):
    N, P = st.shape
    for name, t, dt in (("st", st, torch.uint8), ("stp", stp, torch.uint8),
                        ("ref", ref, torch.uint8), ("gval", gval, torch.uint8),
                        ("kmiss", kmiss, torch.bool)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
    if stp.shape != st.shape or ref.shape != (P,):
        raise ValueError(f"shapes st {tuple(st.shape)}, stp "
                         f"{tuple(stp.shape)}, ref {tuple(ref.shape)}")
    if (base is None) != (nc_base is None):
        raise ValueError("base and nc_base are given together or not at all")
    given = () if base is None else (("base", base), ("nc_base", nc_base))
    if any(t.shape != (N,) for _, t in given):
        raise ValueError("base/nc_base must be [N]")
    if pos.dim() != 2 or gval.shape != pos.shape or kmiss.shape != pos.shape:
        raise ValueError("pos/gval/kmiss must be [B,K] of one shape")
    if P >= 1 << POS_BITS:
        raise ValueError(f"P={P} exceeds the kernels' {POS_BITS}-bit "
                         "position field")
    for name, t in (("stp", stp), ("ref", ref), *given, ("pos", pos),
                    ("gval", gval), ("kmiss", kmiss)):
        if t.device != st.device:
            raise ValueError(f"{name} lies on {t.device}, st on {st.device}: "
                             "all inputs must lie on one device")
    if st.device.type == "cuda":
        # the kernels index st/stp through raw pointers with row pitch P: a
        # row slice of a wider tensor or a transposed view would be misread
        for name, t in (("st", st), ("stp", stp)):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous on a CUDA "
                                 "device")


def _slot_words(P, ref, pos, gval, kmiss):
    """The kernels' slot table, int32 [Q, 7, B] (layout in
    csrc/placement_sparse.cu): the K slots of a sample in Q = ceil(K / 4)
    quads of four, each quad the four positions and three words that hold
    one byte per slot (the sample's allele mask, the reference nibble, and
    flags: bit 7 missing, bit 6 the slot holds an entry); and qend [B]
    int32, one past each sample's last quad that holds an entry: the kernels
    walk quads below it only.  Few tensor operations: a scoring call pays
    their launches before its kernel starts."""
    B, K = pos.shape
    Q = -(-K // 4)
    pos = pos.to(torch.int32)
    kvalid = (pos >= 0) & (pos < P)
    pc = pos * kvalid
    fields = torch.stack([
        gval & 0xF, ref[pc.long()] & 0xF,
        torch.where(kmiss, 0xC0, 0x40).to(torch.uint8)]) * kvalid  # [3, B, K]
    if Q * 4 != K:
        pc = torch.nn.functional.pad(pc, (0, Q * 4 - K))
        fields = torch.nn.functional.pad(fields, (0, Q * 4 - K))
    # four uint8 in slot order are one little-endian int32
    packed = fields.view(torch.int32)                            # [3, B, Q]
    table = torch.cat([pc.view(B, Q, 4).permute(1, 2, 0),
                       packed.permute(2, 0, 1)], dim=1)          # [Q, 7, B]
    q1 = torch.arange(1, Q + 1, dtype=torch.int32, device=pos.device)
    qend = ((packed[2] != 0) * q1).amax(1) if Q else \
        torch.zeros(B, dtype=torch.int32, device=pos.device)
    return table, qend.to(torch.int32)


class Limits(NamedTuple):
    """What a launch plan needs to know of a device."""
    sms: int          # streaming multiprocessors: the grid of a launch
    threads: int      # threads of a kernel block
    smem_max: int     # dynamic shared memory a block may have, bytes
    smem_header: int  # bytes a block keeps beside its ring and ref row


H100 = Limits(sms=132, threads=1024, smem_max=232448, smem_header=2048)


class Plan(NamedTuple):
    """How a launch cuts st/stp [N, P] and the batch (the kernels' source
    note says what each choice does)."""
    rows: int     # node rows of a row group
    stages: int   # ring stages
    vec: int      # 1: asynchronous bulk copies fill the ring; 0: thread copies
    lanes: int    # lanes of a warp that split one sample's K slots
    grid: int     # persistent blocks
    seg: int      # columns of a segment; P where one segment holds the row

    def segments(self, P: int) -> int:
        """Column segments of a row of P columns."""
        return -(-P // self.seg) if self.seg and P > self.seg else 1


def launch_plan(P: int, B: int, K: int, fused: bool, aligned: bool = True,
                per_sample_state: bool = False,
                limits: Limits = H100) -> Plan:
    """The plan of a B1 launch (B2 with per_sample_state) over P columns and
    B samples of K slots.  A stage holds ``rows`` rows of st and of stp, a
    fused launch also the reference row; up to ``MAX_STAGES`` stages share
    what the header leaves of the block's shared memory, a multiple of
    ``ROW_CHUNK`` rows each where that many fit.  Bulk copies need P % 16 ==
    0 and aligned bases; otherwise one stage that the threads fill.  Where
    not even one row of st and stp (and ref) fits, a row is cut into
    segments of equal width, a multiple of 16 columns: a stage then holds
    one row's segment of st, of stp and (fused) of ref, and the kernels add
    up a row's segments.  Lanes per sample: as many as give every (row
    chunk, sample) item of a stage a thread group in one pass, while a lane
    still walks ``SLOTS_PER_LANE`` slots (below that the shuffles and the
    per-item bookkeeping cost more than the lanes save); B2 keeps a sample's
    partial in one thread group for the whole launch, so it takes the most
    lanes that still give every sample a group."""
    pitch = (P + 15) // 16 * 16
    pairs = (limits.smem_max - limits.smem_header
             - (pitch if fused else 0)) // (2 * pitch)
    vec = int(aligned and P % 16 == 0)
    seg = P
    if pairs >= 1:
        stages = min(MAX_STAGES, pairs) if vec else 1
        per_stage = pairs // stages
        rows = (min(MAX_ROWS, per_stage // ROW_CHUNK * ROW_CHUNK)
                if per_stage >= ROW_CHUNK else per_stage)
    else:
        stages = MAX_STAGES if vec else 1
        rows = 1
        room = (limits.smem_max - limits.smem_header) // stages
        widest = room // (3 if fused else 2) // 16 * 16
        nseg = -(-P // widest)
        seg = (-(-P // nseg) + 15) // 16 * 16
    # thread groups that have an item in one pass over a stage: B2 keeps a
    # sample's partial in one group for the whole launch
    items = B if per_sample_state else \
        (rows // ROW_CHUNK if rows % ROW_CHUNK == 0 else rows) * B
    lanes = 1
    while (lanes < 32 and items * lanes * 2 <= limits.threads
           and K >= SLOTS_PER_LANE * lanes * 2):
        lanes *= 2
    return Plan(rows, stages, vec, lanes, limits.sms, seg)


@functools.lru_cache(maxsize=None)
def device_limits(device_index: int) -> Limits:
    """The ``Limits`` of a CUDA device, from the kernel library."""
    out = [ctypes.c_int() for _ in range(4)]
    check(load_library().usher_launch_limits(
        device_index, *(ctypes.byref(x) for x in out)), "usher_launch_limits")
    return Limits(*(x.value for x in out))


def _device_args(st):
    """(device ordinal, stream handle) of st's device for a C launcher: the
    launch goes to st's own device and its current stream, whichever device
    is current in the calling thread."""
    dev = st.device.index
    if dev is None:
        dev = torch.cuda.current_device()
    return dev, torch.cuda.current_stream(st.device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


class _Launch(NamedTuple):
    """The arguments every C launcher takes first (st, stp, ref, base,
    nc_base, slot table, qend, N, P, B and the plan) and last (device,
    stream), the plan, and the tensors behind the pointers, which must stay
    alive until the launch call returns."""
    head: tuple
    tail: tuple
    plan: Plan
    keep: tuple


def _launch_args(st, stp, ref, base, nc_base, pos, gval, kmiss,
                 per_sample_state=False) -> _Launch:
    """base None selects the fused form: the kernel is given ref and sums
    base and nc_base itself; otherwise it gets no ref."""
    N, P = st.shape
    B, K = pos.shape
    fused = base is None
    tail = _device_args(st)
    aligned = st.data_ptr() % 16 == 0 and stp.data_ptr() % 16 == 0
    plan = launch_plan(P, B, K, fused, aligned, per_sample_state,
                       device_limits(tail[0]))
    table, qend = _slot_words(P, ref, pos, gval, kmiss)
    if fused:
        ref = ref.contiguous()
        if ref.data_ptr() % 16:
            # a segmented launch copies ref's segments with bulk copies
            ref = ref.clone()
        keep = (ref, None, None, table, qend)
    else:
        keep = (None, base.to(torch.int32).contiguous(),
                nc_base.to(torch.int32).contiguous(), table, qend)
    head = (st.data_ptr(), stp.data_ptr(), *(_ptr(t) for t in keep), N, P, B,
            *plan)
    return _Launch(head, tail, plan, keep)


def _score_entries_cuda(st, stp, ref, base, nc_base, pos, gval, kmiss, spr):
    """One B1 launch: (score_T, nc_T, sums), sums [3, N] int32 (base,
    nc_base, node_num_mut) from the kernel when base is None, else None.
    Without rows, or without samples when the sums are given, there is
    nothing to write and nothing is launched; a fused call without samples
    still launches for its sums."""
    N, B = st.shape[0], pos.shape[0]
    score_t = torch.empty((N, B), dtype=torch.int32, device=st.device)
    nc_t = torch.empty((N, B), dtype=torch.int32, device=st.device)
    sums = (torch.empty((3, N), dtype=torch.int32, device=st.device)
            if base is None else None)
    if N == 0 or (B == 0 and base is not None):
        return score_t, nc_t, sums
    lib = load_library()
    launch = _launch_args(st, stp, ref, base, nc_base, pos, gval, kmiss)
    err = lib.usher_score_entries_T(
        *launch.head, int(spr), score_t.data_ptr(), nc_t.data_ptr(),
        _ptr(sums), *launch.tail)
    check(err, "usher_score_entries_T")
    score_entries_T.launches += 1
    if spr:
        score_entries_T.launches_spr += 1
    return score_t, nc_t, sums


def score_entries_T(st, stp, ref, base, nc_base, pos, gval, kmiss,
                    spr: bool = False):
    """B1 / B1-spr wrapper with caller-given base/nc_base: the CUDA kernel
    for CUDA tensors, the plain twin for CPU tensors.  Same signature and
    outputs as ``score_entries_T_plain``."""
    if base is None or nc_base is None:
        raise ValueError("score_entries_T takes base and nc_base; "
                         "score_sparse_stp_T is the fused call")
    _check_state(st, stp, ref, base, nc_base, pos, gval, kmiss)
    if st.device.type == "cpu":
        return score_entries_T_plain(st, stp, ref, base, nc_base, pos, gval,
                                     kmiss, spr=spr)
    if st.device.type != "cuda":
        raise ValueError(f"no B1 kernel for device {st.device}")
    return _score_entries_cuda(st, stp, ref, base, nc_base, pos, gval, kmiss,
                               spr)[:2]


score_entries_T.launches = 0
score_entries_T.launches_spr = 0


# --- B1-3d: the same scores in sample-tile-major tiles ----------------------

def tiles_from_T(mat_t, tb: int, n_pad: int):
    """[N, B] -> [bt, n_pad, tb] tiles with tile[b // tb, n, b % tb] =
    mat_t[n, b]; rows >= N and samples >= B are zero."""
    N, B = mat_t.shape
    bt = -(-B // tb)
    out = torch.zeros((n_pad, bt * tb), dtype=mat_t.dtype,
                      device=mat_t.device)
    out[:N, :B] = mat_t
    return out.view(n_pad, bt, tb).permute(1, 0, 2).contiguous()


def tiles_to_T(tiles, N: int, B: int):
    """The [N, B] matrix held by [bt, n_pad, tb] tiles (inverse of
    ``tiles_from_T`` on the real rows and samples)."""
    bt, n_pad, tb = tiles.shape
    return tiles.permute(1, 0, 2).reshape(n_pad, bt * tb)[:N, :B].contiguous()


def _tile_shape(N, B, tb, n_pad):
    if tb < 1:
        raise ValueError(f"tb={tb}: a tile holds at least one sample")
    n_pad = N if n_pad is None else n_pad
    if n_pad < N:
        raise ValueError(f"n_pad={n_pad} is below N={N}")
    bt = -(-B // tb)
    return bt, n_pad, bt * tb


def score_entries_3d_plain(st, stp, ref, base, nc_base, pos, gval, kmiss,
                           tb: int, spr: bool = False, n_pad=None):
    """Plain twin of B1-3d: ``score_entries_T_plain`` re-laid into tiles.
    Same outputs as ``score_entries_3d``; here the unspecified rows and
    samples of a tile are zero."""
    N, B = st.shape[0], pos.shape[0]
    _, n_pad, b_pad = _tile_shape(N, B, tb, n_pad)
    score_t, nc_t = score_entries_T_plain(st, stp, ref, base, nc_base, pos,
                                          gval, kmiss, spr=spr)
    return (tiles_from_T(score_t, tb, n_pad), tiles_from_T(nc_t, tb, n_pad),
            N, B, n_pad, b_pad)


def score_entries_3d(st, stp, ref, base, nc_base, pos, gval, kmiss, tb: int,
                     spr: bool = False, n_pad=None):
    """B1-3d wrapper (counterpart of placement_pallas._score_entries_3d):
    B1's scores, or B1-spr's when spr, left in sample-tile-major tiles so
    that a consumer reducing over nodes reads one contiguous [n_pad, tb]
    slab per sample tile.  tb is the samples per tile, n_pad (default N) the
    rows of a tile.  Returns (score3, nc3 [bt, n_pad, tb] int32, N, B,
    n_pad, b_pad) with score3[b // tb, n, b % tb] = score_T[n, b]; rows >= N
    and samples >= B of a tile are unspecified.  The CUDA kernel for CUDA
    tensors, the plain twin for CPU tensors."""
    if base is None or nc_base is None:
        raise ValueError("score_entries_3d takes base and nc_base")
    _check_state(st, stp, ref, base, nc_base, pos, gval, kmiss)
    if st.device.type == "cpu":
        return score_entries_3d_plain(st, stp, ref, base, nc_base, pos, gval,
                                      kmiss, tb, spr=spr, n_pad=n_pad)
    if st.device.type != "cuda":
        raise ValueError(f"no B1-3d kernel for device {st.device}")
    lib = load_library()
    N, B = st.shape[0], pos.shape[0]
    bt, n_pad, b_pad = _tile_shape(N, B, tb, n_pad)
    launch = _launch_args(st, stp, ref, base, nc_base, pos, gval, kmiss)
    score3 = torch.empty((bt, n_pad, tb), dtype=torch.int32, device=st.device)
    nc3 = torch.empty((bt, n_pad, tb), dtype=torch.int32, device=st.device)
    err = lib.usher_score_entries_3d(
        *launch.head, int(spr), tb, n_pad, score3.data_ptr(), nc3.data_ptr(),
        None, *launch.tail)
    check(err, "usher_score_entries_3d")
    score_entries_3d.launches += 1
    return score3, nc3, N, B, n_pad, b_pad


score_entries_3d.launches = 0


def score_sparse_stp_T_plain(st, stp, ref, pos, gval, kmiss):
    """Plain twin of the fused B1 call: ``row_reductions``, then B1's plain
    twin.  Same outputs as ``score_sparse_stp_T``."""
    base, nc_base, node_num_mut = row_reductions(st, stp, ref)
    score_t, nc_t = score_entries_T_plain(st, stp, ref, base, nc_base, pos,
                                          gval, kmiss)
    return score_t, nc_t, node_num_mut


def score_sparse_stp_T(st, stp, ref, pos, gval, kmiss):
    """Node-major sparse scoring given the parent states.  Returns
    (score_T [N,B], num_common_T [N,B], node_num_mut [N]) int32: the dense
    score_batch outputs transposed, without inactive-slot masking.  On CUDA
    tensors one fused B1 launch, which sums base, nc_base and node_num_mut
    from the rows it stages; on CPU tensors the plain twin."""
    _check_state(st, stp, ref, None, None, pos, gval, kmiss)
    if st.device.type == "cpu":
        return score_sparse_stp_T_plain(st, stp, ref, pos, gval, kmiss)
    if st.device.type != "cuda":
        raise ValueError(f"no B1 kernel for device {st.device}")
    score_t, nc_t, sums = _score_entries_cuda(st, stp, ref, None, None, pos,
                                              gval, kmiss, False)
    return score_t, nc_t, sums[2]


def score_sparse_T(st, parent, root_slot, ref, pos, gval, kmiss):
    """score_sparse_stp_T with stp = st[parent] (root row its own)."""
    stp = parent_states(st, parent, root_slot)
    return score_sparse_stp_T(st, stp, ref, pos, gval, kmiss)


# --- B1-spr: the CSR BigMAT column path -------------------------------------

def cols_states(m0, anc, parent, root_slot, ref_cols):
    """Path states of every node at a batch's C columns, from the nodes'
    own branch-mutation alleles m0 [N, C] uint8 (0 = none) by pointer
    doubling over the 2^k-ancestor tables anc [n_anc, N] (root -> itself).
    Returns (st_cols, stp_cols) [N, C] uint8."""
    val = m0
    for k in range(anc.shape[0]):
        val = torch.where(val > 0, val, val[anc[k].long()])
    st_cols = torch.where(val > 0, val, ref_cols[None, :])
    return st_cols, parent_states(st_cols, parent, root_slot)


def score_cols_T(m0, anc, parent, root_slot, ref_cols, base, nc_base,
                 pos, gval, kmiss, spr: bool = False):
    """Column-subset scoring for CSR-backed MATs (core/bigmat.py), the
    counterpart of placement_pallas.score_cols_T: the path states at the
    batch's columns (``cols_states``, torch ops) scored by B1, or by B1-spr
    when spr.  ref_cols [C] uint8; base/nc_base [N] int32 are the
    full-genome no-entry aggregates; pos [B, K] holds COLUMN indices
    (>= C marks padding).  Returns (score_T, num_common_T) [N, B] int32."""
    st_cols, stp_cols = cols_states(m0, anc, parent, root_slot, ref_cols)
    return score_entries_T(st_cols, stp_cols, ref_cols, base, nc_base,
                           pos, gval, kmiss, spr=spr)


# --- B2: fused validity + tie-broken argmin -------------------------------

def placement_reduce_plain(st, stp, ref, base, nc_base, node_num_mut, active,
                           is_leaf, is_root_mask, num_leaves, bfs_rank, pos,
                           gval, kmiss):
    """Plain twin of B2: B1's plain twin, then validity and the argmin over
    the whole [N, B] matrices.  Returns (best_score, best_row, num_best)
    [B] int32."""
    score_t, nc_t = score_entries_T_plain(st, stp, ref, base, nc_base, pos,
                                          gval, kmiss)
    valid, _ = valid_mask(score_t.T, nc_t.T, node_num_mut, is_root_mask,
                          is_leaf, active)
    return reduce_best(score_t.T, valid, num_leaves, bfs_rank)


def partials_plain(score_t, nc_t, node_num_mut, active, is_leaf,
                   is_root_mask, num_leaves, bfs_rank):
    """The tie-break partials of a block of node rows from its [n, B]
    score/num_common matrices, as one row [4, 1, B] int32 of what the B2
    kernel writes per block: min valid score, rows at it, max leaves among
    them, max (rank * 2 | has_unique) among those."""
    valid, hu = valid_mask(score_t.T, nc_t.T, node_num_mut, is_root_mask,
                           is_leaf, active)
    valid, hu = valid.T, hu.T                                  # [n, B]
    B = score_t.shape[1]
    if score_t.shape[0] == 0:
        out = torch.full((4, 1, B), -1, dtype=torch.int32,
                         device=score_t.device)
        out[0] = BIG
        out[1] = 0
        return out
    best = torch.where(valid, score_t, BIG).min(0).values
    is_best = valid & (score_t == best[None, :])
    cnt = is_best.sum(0, dtype=torch.int32)
    q1 = torch.where(is_best, num_leaves[:, None], -1).max(0).values
    is_best &= num_leaves[:, None] == q1[None, :]
    rank2 = bfs_rank.to(torch.int32)[:, None] * 2 + hu.to(torch.int32)
    q2 = torch.where(is_best, rank2, -1).max(0).values
    return torch.stack([best, cnt, q1.to(torch.int32), q2])[:, None, :]


def merge_partials(pbest, pcnt, p1, p2):
    """Exact merge of tie-break partials [n_parts, B] over the parts
    (node blocks of one kernel launch, or node shards of a device mesh;
    placement_pallas.py:557-570): the min score, the count summed over the
    parts that reach it, the max leaves among them, then the max BFS rank.
    Returns (best_score, best_rank, num_best) [B] int32."""
    gbest = pbest.min(0).values
    m = pbest == gbest[None, :]
    num_best = torch.where(m, pcnt, 0).sum(0, dtype=torch.int32)
    g1 = torch.where(m, p1, -1).max(0).values
    g2 = torch.where(m & (p1 == g1[None, :]), p2, -1).max(0).values
    return gbest, torch.clamp(g2 >> 1, min=0), num_best


def row_of_rank(rank, bfs_rank, N):
    """The node row holding each BFS rank of ``rank`` [B]."""
    # the inverse rank permutation; inactive slots (bfs_rank -1) write a
    # dump entry at N that is never read
    dest = torch.where(bfs_rank >= 0, bfs_rank, N).long()
    table = torch.zeros(N + 1, dtype=torch.int32, device=rank.device)
    table[dest] = torch.arange(N, dtype=torch.int32, device=rank.device)
    return table[torch.clamp(rank, max=N - 1).long()]


def placement_partials(st, stp, ref, base, nc_base, node_num_mut, active,
                       is_leaf, is_root_mask, num_leaves, bfs_rank, pos, gval,
                       kmiss):
    """The B2 kernel alone: tie-break partials [4, n_parts, B] int32 (best,
    count, leaves, rank * 2 | has_unique) of the node rows of st, for
    ``merge_partials``.  bfs_rank holds the rows' GLOBAL ranks, so the
    partials of several node shards merge into the global winner.  base,
    nc_base and node_num_mut are given together, or all None: then the CUDA
    kernel sums them from the rows it stages (``row_reductions`` for CPU
    tensors).  The CUDA kernel writes one part per block of its grid (the
    identity of the merge from a block without rows, so also when N is 0);
    for CPU tensors one part from the plain B1 twin."""
    if not ((base is None) == (nc_base is None) == (node_num_mut is None)):
        raise ValueError("base, nc_base and node_num_mut are given together "
                         "or not at all")
    _check_state(st, stp, ref, base, nc_base, pos, gval, kmiss)
    N = st.shape[0]
    for t in (node_num_mut, active, is_leaf, is_root_mask, num_leaves,
              bfs_rank):
        if t is not None and (t.shape != (N,) or t.device != st.device):
            raise ValueError("per-node inputs must be [N] on st's device")
    if st.device.type == "cpu":
        if base is None:
            base, nc_base, node_num_mut = row_reductions(st, stp, ref)
        score_t, nc_t = score_entries_T_plain(st, stp, ref, base, nc_base,
                                              pos, gval, kmiss)
        return partials_plain(score_t, nc_t, node_num_mut, active, is_leaf,
                              is_root_mask, num_leaves, bfs_rank)
    if st.device.type != "cuda":
        raise ValueError(f"no B2 kernel for device {st.device}")
    B = pos.shape[0]
    if B == 0:
        return torch.empty((4, 1, 0), dtype=torch.int32, device=st.device)
    lib = load_library()
    flags = (active.to(torch.int32)
             | (is_leaf.to(torch.int32) << 1)
             | (is_root_mask.to(torch.int32) << 2))
    nodemeta = torch.stack([num_leaves.to(torch.int32),
                            bfs_rank.to(torch.int32),
                            flags.new_zeros(N) if node_num_mut is None
                            else node_num_mut.to(torch.int32), flags],
                           dim=1).contiguous()
    launch = _launch_args(st, stp, ref, base, nc_base, pos, gval, kmiss,
                          per_sample_state=True)
    parts = torch.empty((4, launch.plan.grid, B), dtype=torch.int32,
                        device=st.device)
    err = lib.usher_placement_partials(
        *launch.head, nodemeta.data_ptr(), parts.data_ptr(), *launch.tail)
    check(err, "usher_placement_partials")
    placement_reduce.launches += 1
    return parts


def placement_reduce(st, stp, ref, base, nc_base, node_num_mut, active,
                     is_leaf, is_root_mask, num_leaves, bfs_rank, pos, gval,
                     kmiss):
    """B2 wrapper: the CUDA kernel plus the exact partial merge for CUDA
    tensors, the plain twin for CPU tensors.  base, nc_base and
    node_num_mut all None: the fused form, as in ``placement_partials``.
    ``placement_reduce.launches`` counts the kernel's launches, those made
    through ``placement_partials`` included."""
    if st.device.type == "cpu":
        _check_state(st, stp, ref, base, nc_base, pos, gval, kmiss)
        if base is None:
            base, nc_base, node_num_mut = row_reductions(st, stp, ref)
        return placement_reduce_plain(st, stp, ref, base, nc_base,
                                      node_num_mut, active, is_leaf,
                                      is_root_mask, num_leaves, bfs_rank,
                                      pos, gval, kmiss)
    parts = placement_partials(st, stp, ref, base, nc_base, node_num_mut,
                               active, is_leaf, is_root_mask, num_leaves,
                               bfs_rank, pos, gval, kmiss)
    best, rank, num_best = merge_partials(*parts)
    return (best, row_of_rank(rank, bfs_rank.to(torch.int32), st.shape[0]),
            num_best)


placement_reduce.launches = 0


def placement_step_sparse(st, parent, root_slot, ref, active, is_leaf,
                          is_root_mask, num_leaves, bfs_rank, pos, gval,
                          kmiss):
    """Sparse counterpart of ops.placement.placement_step: the row sums,
    scoring, validity and the tie-broken argmin with the [N, B] matrices
    never written (one fused B2 launch on CUDA).  Returns (best_score,
    best_row, num_best) [B] int32."""
    stp = parent_states(st, parent, root_slot)
    return placement_reduce(st, stp, ref, None, None, None, active, is_leaf,
                            is_root_mask, num_leaves, bfs_rank, pos, gval,
                            kmiss)
