"""Sparse-sample placement scoring (counterpart of
usher_tpu/ops/placement_pallas.py).

A sample has a few dozen VCF entries out of P segregating sites, and at every
no-entry position the (sample, node) term does not depend on the sample.  So

  score[n,b] = base[n]    + sum_k corr(n, b, pos[b,k])
  nc[n,b]    = nc_base[n] + sum_k corr_nc(n, b, pos[b,k])

with per-node row reductions base, nc_base (torch ops here) and corrections
that read st/stp at the K entry columns only.  Hand-written CUDA kernels
(csrc/placement_sparse.cu) evaluate the corrections:

  B1     ``score_entries_T``  the [N, B] score and num_common matrices
  B1-spr ``score_entries_T(spr=True)``, reached through ``score_cols_T``:
                              B1 with the SPR base semantics, over the
                              pointer-doubled column states of a CSR BigMAT
  B1-3d  ``score_entries_3d`` B1 / B1-spr with the outputs left in
                              sample-tile-major tiles [bt, n_pad, tb]
  B2     ``placement_reduce`` B1 plus validity and the tie-broken argmin,
                              through per-node-block partials
                              (``placement_partials``) merged here

parallel/mesh.py runs B1 and the B2 partials once per shard of a device
mesh (mesh B1), on the shard's own device and stream.

Each has a plain PyTorch twin (``*_plain``) built from column gathers
``st[:, pos_chunk]``, chunked over the batch.  The wrappers run the kernel on
CUDA tensors and the plain twin on CPU tensors, and never fall back from one
to the other; each counts its kernel launches in ``<wrapper>.launches``
(``score_entries_T.launches_spr`` counts the spr=True launches apart).  The
kernels read raw pointers, so a wrapper raises on a CUDA tensor that is not
contiguous or lies on another device than ``st``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.nuc import N as NUC_N
from ._build import check, load_library
from .placement import BIG, parent_states, reduce_best, valid_mask

CHUNK_ELEMS = 1 << 26   # elements of one [N, Bc, K] gathered block (plain)
POS_BITS = 22           # position field of the kernels' slot word
SMEM_ROWS_BYTES = 96 * 1024  # shared memory a block spends on staged rows
MAX_ROWS = 32


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
    over rows so the [rows, P] temporaries stay within ``CHUNK_ELEMS``."""
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
        cols = pc[sl].reshape(-1)
        s = st[:, cols].view(N, -1, K)                     # [N,Bc,K]
        sp = stp[:, cols].view(N, -1, K)
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
    if base.shape != (N,) or nc_base.shape != (N,):
        raise ValueError("base/nc_base must be [N]")
    if pos.dim() != 2 or gval.shape != pos.shape or kmiss.shape != pos.shape:
        raise ValueError("pos/gval/kmiss must be [B,K] of one shape")
    if P >= 1 << POS_BITS:
        raise ValueError(f"P={P} exceeds the kernels' {POS_BITS}-bit "
                         "position field")
    for name, t in (("stp", stp), ("ref", ref), ("base", base),
                    ("nc_base", nc_base), ("pos", pos), ("gval", gval),
                    ("kmiss", kmiss)):
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
    """The kernels' packed slot words, k-major [K, B] int32 (layout in
    csrc/placement_sparse.cu)."""
    kvalid, pc, refk = _slot_fields(P, ref, pos)
    w = (pc
         | ((gval.long() & 0xF) << 22)
         | (kmiss.long() << 26)
         | (kvalid.long() << 27)
         | ((refk.long() & 0xF) << 28))
    # values fill 32 bits: reinterpret the low word as int32
    w = torch.where(w >= 1 << 31, w - (1 << 32), w)
    return w.to(torch.int32).t().contiguous()


def rows_per_block(P: int) -> int:
    """Node rows a kernel block stages in shared memory (P bytes each)."""
    pitch = (P + 15) // 16 * 16
    return max(1, min(MAX_ROWS, SMEM_ROWS_BYTES // pitch))


def _device_args(st):
    """(device ordinal, stream handle) of st's device for a C launcher: the
    launch goes to st's own device and its current stream, whichever device
    is current in the calling thread."""
    dev = st.device.index
    if dev is None:
        dev = torch.cuda.current_device()
    return dev, torch.cuda.current_stream(st.device).cuda_stream


def score_entries_T(st, stp, ref, base, nc_base, pos, gval, kmiss,
                    spr: bool = False):
    """B1 / B1-spr wrapper: the CUDA kernel for CUDA tensors, the plain twin
    for CPU tensors.  Same signature and outputs as
    ``score_entries_T_plain``."""
    _check_state(st, stp, ref, base, nc_base, pos, gval, kmiss)
    if st.device.type == "cpu":
        return score_entries_T_plain(st, stp, ref, base, nc_base, pos, gval,
                                     kmiss, spr=spr)
    if st.device.type != "cuda":
        raise ValueError(f"no B1 kernel for device {st.device}")
    lib = load_library()
    N, P = st.shape
    B, K = pos.shape
    base = base.to(torch.int32).contiguous()
    nc_base = nc_base.to(torch.int32).contiguous()
    slots = _slot_words(P, ref, pos, gval, kmiss)
    score_t = torch.empty((N, B), dtype=torch.int32, device=st.device)
    nc_t = torch.empty((N, B), dtype=torch.int32, device=st.device)
    err = lib.usher_score_entries_T(
        st.data_ptr(), stp.data_ptr(), base.data_ptr(), nc_base.data_ptr(),
        slots.data_ptr(), N, P, B, K, rows_per_block(P), int(spr),
        score_t.data_ptr(), nc_t.data_ptr(), *_device_args(st))
    check(err, "usher_score_entries_T")
    score_entries_T.launches += 1
    if spr:
        score_entries_T.launches_spr += 1
    return score_t, nc_t


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
    _check_state(st, stp, ref, base, nc_base, pos, gval, kmiss)
    if st.device.type == "cpu":
        return score_entries_3d_plain(st, stp, ref, base, nc_base, pos, gval,
                                      kmiss, tb, spr=spr, n_pad=n_pad)
    if st.device.type != "cuda":
        raise ValueError(f"no B1-3d kernel for device {st.device}")
    lib = load_library()
    N, P = st.shape
    B, K = pos.shape
    bt, n_pad, b_pad = _tile_shape(N, B, tb, n_pad)
    base = base.to(torch.int32).contiguous()
    nc_base = nc_base.to(torch.int32).contiguous()
    slots = _slot_words(P, ref, pos, gval, kmiss)
    score3 = torch.empty((bt, n_pad, tb), dtype=torch.int32, device=st.device)
    nc3 = torch.empty((bt, n_pad, tb), dtype=torch.int32, device=st.device)
    err = lib.usher_score_entries_3d(
        st.data_ptr(), stp.data_ptr(), base.data_ptr(), nc_base.data_ptr(),
        slots.data_ptr(), N, P, B, K, rows_per_block(P), int(spr), tb, n_pad,
        score3.data_ptr(), nc3.data_ptr(), *_device_args(st))
    check(err, "usher_score_entries_3d")
    score_entries_3d.launches += 1
    return score3, nc3, N, B, n_pad, b_pad


score_entries_3d.launches = 0


def score_sparse_stp_T(st, stp, ref, pos, gval, kmiss):
    """Node-major sparse scoring given the parent states.  Returns
    (score_T [N,B], num_common_T [N,B], node_num_mut [N]) int32: the dense
    score_batch outputs transposed, without inactive-slot masking."""
    base, nc_base, node_num_mut = row_reductions(st, stp, ref)
    score_t, nc_t = score_entries_T(st, stp, ref, base, nc_base, pos, gval,
                                    kmiss)
    return score_t, nc_t, node_num_mut


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
    partials of several node shards merge into the global winner.  The
    CUDA kernel (one part per node block) for CUDA tensors; for CPU
    tensors one part from the plain B1 twin."""
    _check_state(st, stp, ref, base, nc_base, pos, gval, kmiss)
    for t in (node_num_mut, active, is_leaf, is_root_mask, num_leaves,
              bfs_rank):
        if t.shape != base.shape or t.device != st.device:
            raise ValueError("per-node inputs must be [N] on st's device")
    if st.device.type == "cpu":
        score_t, nc_t = score_entries_T_plain(st, stp, ref, base, nc_base,
                                              pos, gval, kmiss)
        return partials_plain(score_t, nc_t, node_num_mut, active, is_leaf,
                              is_root_mask, num_leaves, bfs_rank)
    if st.device.type != "cuda":
        raise ValueError(f"no B2 kernel for device {st.device}")
    lib = load_library()
    N, P = st.shape
    B, K = pos.shape
    base = base.to(torch.int32).contiguous()
    nc_base = nc_base.to(torch.int32).contiguous()
    flags = (active.to(torch.int32)
             | (is_leaf.to(torch.int32) << 1)
             | (is_root_mask.to(torch.int32) << 2))
    nodemeta = torch.stack([num_leaves.to(torch.int32),
                            bfs_rank.to(torch.int32),
                            node_num_mut.to(torch.int32), flags],
                           dim=1).contiguous()
    slots = _slot_words(P, ref, pos, gval, kmiss)
    rows = rows_per_block(P)
    n_blocks = -(-N // rows)
    parts = torch.empty((4, n_blocks, B), dtype=torch.int32,
                        device=st.device)
    err = lib.usher_placement_partials(
        st.data_ptr(), stp.data_ptr(), base.data_ptr(), nc_base.data_ptr(),
        nodemeta.data_ptr(), slots.data_ptr(), N, P, B, K, rows,
        *(part.data_ptr() for part in parts), *_device_args(st))
    check(err, "usher_placement_partials")
    placement_reduce.launches += 1
    return parts


def placement_reduce(st, stp, ref, base, nc_base, node_num_mut, active,
                     is_leaf, is_root_mask, num_leaves, bfs_rank, pos, gval,
                     kmiss):
    """B2 wrapper: the CUDA kernel plus the exact partial merge for CUDA
    tensors, the plain twin for CPU tensors.  ``placement_reduce.launches``
    counts the kernel's launches, those made through
    ``placement_partials`` included."""
    if st.device.type == "cpu":
        _check_state(st, stp, ref, base, nc_base, pos, gval, kmiss)
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
    """Sparse counterpart of ops.placement.placement_step: scoring,
    validity and the tie-broken argmin with the [N, B] matrices never
    written (through B2 on CUDA).  Returns (best_score, best_row, num_best)
    [B] int32."""
    stp = parent_states(st, parent, root_slot)
    base, nc_base, node_num_mut = row_reductions(st, stp, ref)
    return placement_reduce(st, stp, ref, base, nc_base, node_num_mut,
                            active, is_leaf, is_root_mask, num_leaves,
                            bfs_rank, pos, gval, kmiss)
