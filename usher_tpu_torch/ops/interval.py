"""DFS-interval scoring, the pandemic-scale placement engine (counterpart of
usher_tpu/ops/interval.py; the derivation is in its docstring).

At an entry column c the per-(sample, node) correction is a function of
(st, stp) at (node, c), and st is piecewise constant over the nested DFS
intervals that the column's branch mutations cut.  So for a batch

  score_T[n, b] = base[n] + add0[b] + cumsum_over_dfs(diff)[dfs(n), b]
  nc_T[n, b]    = nc_base[n] + point_scatter[dfs(n), b]

where ``diff`` gets, for every (sample entry, column mutation) pair, a range
delta over the mutation node's DFS interval and a width-1 delta at the node
itself.  Everything here is plain torch on the device of its inputs:

  X4 ``_scan_rows``        an inclusive int32 cumsum over DFS rows
  X8 ``interval_scores`` / ``interval_place``
                           host-expanded event streams -> matrices / winners
  X5 ``interval_place_dev``
                           the events expanded on the device from the
                           resident CSC index, then the same reduction
  X6 ``interval_place_flatgrp_dev``
                           shared-ancestry grouped placement: one flat,
                           signed entry list of sample residuals and group
                           rows, one scan over B + G columns, each sample
                           summing its anchor chain's group columns by a
                           closure product (``_closure_combine``)
  X7 ``interval_spr`` / ``interval_spr_dev`` / ``_spr_sharded_fn``
                           the SPR destination search (optimize/spr_big.py):
                           a source's ancestor-interval count rides in extra
                           columns of the same scan and bounds the radius
  X9 ``interval_place_seg_dev``
                           X5's winners without the [N, B] matrices: exact
                           scores at a sample's event rows and one sparse-
                           table range query per segment between them

Scatter-adds target an explicit dump row ``n_pad`` (row count n_pad + 1):
padding pairs and range ends past the last row land there and are never
read.  They accumulate through a flat ``index_add_`` on int32, where JAX
used ``.at[].add``.  ``_finish_place`` adds validity, the tie-broken argmin,
the optional runner-up and the optional tie-set clade histogram, so only
O(B) vectors leave the device.
"""

from __future__ import annotations

import numpy as np
import torch

BIG = 1 << 30
SCAN_BLOCK = 1024   # rows per block of the two-level scan


def _scan_rows(d):
    """Inclusive cumsum along axis 0 of an int32 [R, B] tensor, int32 out
    (torch.cumsum would widen to int64 without the dtype).

    Two torch.cumsum passes: within blocks of SCAN_BLOCK rows, then over
    the block totals.  torch scans the outer axis of an [R, B] tensor with
    one thread per column walking all R rows, so one pass over [1M, 1024]
    keeps only 1,024 threads busy; blocked, it runs R / SCAN_BLOCK times as
    many.  Integer adds, so the result is exact whatever the order."""
    R, B = d.shape
    nb = R // SCAN_BLOCK
    if nb < 2:
        return torch.cumsum(d, dim=0, dtype=torch.int32)
    body = nb * SCAN_BLOCK
    out = torch.empty((R, B), dtype=torch.int32, device=d.device)
    within = out[:body].view(nb, SCAN_BLOCK, B)
    torch.cumsum(d[:body].reshape(nb, SCAN_BLOCK, B), dim=1,
                 dtype=torch.int32, out=within)
    carry = torch.cumsum(within[:, -1, :], dim=0, dtype=torch.int32)
    within[1:] += carry[:-1, None, :]
    if body < R:
        torch.cumsum(d[body:], dim=0, dtype=torch.int32, out=out[body:])
        out[body:] += carry[-1]
    return out


def _scatter_add(dst, rows, cols, vals):
    """dst[rows, cols] += vals for a contiguous int32 [R, W] tensor;
    duplicate (row, col) pairs accumulate."""
    W = dst.shape[1]
    flat = rows.reshape(-1).long() * W + cols.reshape(-1).long()
    dst.view(-1).index_add_(0, flat, vals.reshape(-1).to(torch.int32))


def interval_scores(ev_idx, ev_b, ev_val, nc_idx, nc_b, nc_val,
                    base_dfs, nc_base_dfs, add0, n_pad: int, b_pad: int):
    """Score + num_common matrices in DFS order.

    ev_idx/ev_b/ev_val [R] int  difference-array events (idx in 0..n_pad;
                                idx == n_pad is the dump row)
    nc_*               [Rn] int num_common point events (idx in 0..n_pad)
    base_dfs, nc_base_dfs [n_pad] int32, add0 [b_pad] int32
    Returns (score_dfs [n_pad, b_pad], nc_dfs [n_pad, b_pad]) int32.
    """
    dev = base_dfs.device
    diff = torch.zeros((n_pad + 1, b_pad), dtype=torch.int32, device=dev)
    _scatter_add(diff, ev_idx, ev_b, ev_val)
    score = _scan_rows(diff[:n_pad])
    del diff
    score += base_dfs[:, None]
    score += add0[None, :]
    ncd = torch.zeros((n_pad + 1, b_pad), dtype=torch.int32, device=dev)
    _scatter_add(ncd, nc_idx, nc_b, nc_val)
    nc = ncd[:n_pad]
    nc += nc_base_dfs[:, None]
    return score, nc


def _tie_reduce(score, valid, num_leaves, bfs_rank):
    """Tie-broken argmin over the node axis (axis 0) of [N, B] inputs:
    min score, then max subtree leaves, then max BFS rank (the reference's
    sequential-order winner, usher_mapper.cpp:458-497).  The winner row is
    the first row holding the winning rank (torch.argmax returns the first
    maximum, as jnp.argmax does; it takes no bool, hence the uint8)."""
    best = torch.where(valid, score, BIG).min(0).values
    is_best = valid & (score == best[None, :])
    num_best = is_best.sum(0, dtype=torch.int32)
    best_leaves = torch.where(is_best, num_leaves[:, None], -1).max(0).values
    is_best &= num_leaves[:, None] == best_leaves[None, :]
    best_rank = torch.where(is_best, bfs_rank[:, None], -1).max(0).values
    is_best &= bfs_rank[:, None] == best_rank[None, :]
    best_row = torch.argmax(is_best.to(torch.uint8), dim=0)
    return best, best_row.to(torch.int32), num_best


def _clade_hist(score, nc, valid, hu, best, is_leaf_dfs,
                clade_self_dfs, clade_par_dfs, n_clades: int):
    """Per-sample clade histogram over the tie set: hist[a, c, b] = number
    of tied nodes whose clade in annotation column a is c.  A tied node
    counts its parent's clade when it is a leaf or has unique mutations
    (include_self = !leaf && !hu, usher_common.cpp:600-619)."""
    A = clade_self_dfs.shape[0]
    n_pad, b_pad = score.shape
    tie = (valid & (score == best[None, :])).to(torch.int32)
    use_par = is_leaf_dfs[:, None] | hu
    bcol = torch.arange(b_pad, device=score.device).expand(n_pad, b_pad)
    hists = []
    for a in range(A):
        sel = torch.where(use_par, clade_par_dfs[a][:, None],
                          clade_self_dfs[a][:, None])
        h = torch.zeros((n_clades, b_pad), dtype=torch.int32,
                        device=score.device)
        _scatter_add(h, sel, bcol, tie)
        hists.append(h)
    return torch.stack(hists)


def _finish_place(score, nc, num_mut_dfs, is_leaf_dfs, is_root_dfs,
                  active_dfs, num_leaves_dfs, bfs_rank_dfs,
                  second: bool = False, clades=None):
    """Placement validity (usher_mapper.cpp:452-455) + tie-broken argmin +
    the winner's has_unique.  Returns (best [B], best_row [B], num_best
    [B]) int32 and hu_best [B] bool.

    second=True appends the runner-up 4-tuple with the winner's row masked
    out; clades=(clade_self_dfs [A, n_pad], clade_par_dfs [A, n_pad],
    n_clades) appends the tie-set histogram [A, n_clades, b_pad]."""
    hu = nc < num_mut_dfs[:, None]
    nc_pos = nc > 0
    leaf = is_leaf_dfs[:, None]
    valid = (is_root_dfs[:, None]
             | (leaf & nc_pos)
             | (~leaf & hu & nc_pos)
             | (~leaf & ~hu)) & active_dfs[:, None]
    del nc_pos
    best, best_row, num_best = _tie_reduce(score, valid, num_leaves_dfs,
                                           bfs_rank_dfs)
    hu_best = torch.gather(hu, 0, best_row.long()[None, :])[0]
    out = (best, best_row, num_best, hu_best)
    if second:
        rows = torch.arange(score.shape[0], device=score.device)[:, None]
        valid2 = valid & (rows != best_row[None, :])
        best2, best_row2, num_best2 = _tie_reduce(
            score, valid2, num_leaves_dfs, bfs_rank_dfs)
        del valid2
        hu2 = torch.gather(hu, 0, best_row2.long()[None, :])[0]
        out = out + (best2, best_row2, num_best2, hu2)
    if clades is not None:
        clade_self_dfs, clade_par_dfs, n_clades = clades
        out = out + (_clade_hist(score, nc, valid, hu, best, is_leaf_dfs,
                                 clade_self_dfs, clade_par_dfs, n_clades),)
    return out


def interval_place(ev_idx, ev_b, ev_val, nc_idx, nc_b, nc_val,
                   base_dfs, nc_base_dfs, add0,
                   num_mut_dfs, is_leaf_dfs, is_root_dfs, active_dfs,
                   num_leaves_dfs, bfs_rank_dfs,
                   n_pad: int, b_pad: int, second: bool = False,
                   clade_self_dfs=None, clade_par_dfs=None,
                   n_clades: int = 0):
    """X8 fused: interval scoring of host-expanded events + placement
    validity + tie-broken argmin.  Returns (best_score [B], best_dfs_row
    [B], num_best [B], hu_best [B]); second=True appends the runner-up
    4-tuple, n_clades > 0 the tie-set clade histogram (_finish_place)."""
    score, nc = interval_scores(ev_idx, ev_b, ev_val, nc_idx, nc_b, nc_val,
                                base_dfs, nc_base_dfs, add0, n_pad, b_pad)
    clades = (None if n_clades == 0
              else (clade_self_dfs, clade_par_dfs, n_clades))
    return _finish_place(score, nc, num_mut_dfs, is_leaf_dfs, is_root_dfs,
                         active_dfs, num_leaves_dfs, bfs_rank_dfs,
                         second=second, clades=clades)


def _expand_events(csc_ptr, csc_node, csc_meta, pos, gval, kmiss, P: int,
                   mc: int):
    """Device-side expansion of every (entry, column-mutation) pair from the
    resident CSC index; mc bounds the column occupancy (pairs past a
    column's count are masked off).  csc_meta packs per-mutation fields
    am | ap<<4 | root<<8 | eff<<9 | dead<<10.  Returns the [B, K, mc]
    fields (u, am, ap, rootm, effm, pair_ok) and the [B, K, 1] gval/kmiss
    views (gv int32, km bool)."""
    valid_e = pos < P
    cols = pos.clamp(0, P - 1).long()
    lo = csc_ptr[cols].long()                              # [B, K]
    cnt = torch.where(valid_e, csc_ptr[cols + 1].long() - lo, 0)
    j = torch.arange(mc, device=pos.device)
    pair_ok = j < cnt[:, :, None]
    flat = (lo[:, :, None] + j).clamp(0, csc_node.shape[0] - 1)
    u = csc_node[flat].long()
    m = csc_meta[flat]
    am = m & 0xF
    ap = (m >> 4) & 0xF
    rootm = (m >> 8) & 1
    effm = (m >> 9) & 1
    pair_ok &= ((m >> 10) & 1) == 0                        # tombstoned
    gv = gval.to(torch.int32)[:, :, None]
    km = kmiss[:, :, None]
    return u, am, ap, rootm, effm, pair_ok, gv, km


def _entry_deltas(csc_ptr, csc_node, csc_meta, dfs_of, dfs_end_of,
                  ref_cols, pos, gval, kmiss, n_pad: int, mc: int,
                  spr: bool, sgn=None, col_offset: int = 0, col_index=None):
    """Expansion + delta evaluation for one entry batch (the case analysis
    of core/bigmat.py _events): returns (r, rend, flat_b, d_range,
    d_point, d_nc, add0) ready to scatter, with r/rend on the dump row
    n_pad for masked pairs.

    sgn [B, K] (+1/-1 an entry, int8) negates an entry's contributions
    (the signed residuals of the shared-ancestry decomposition, X6);
    col_offset shifts the scatter columns; col_index [B] replaces the
    row -> column iota altogether (X6's flat entry list: every row is one
    entry with its own target column)."""
    P = ref_cols.shape[0]
    B, K = pos.shape
    u, am, ap, rootm, effm, pair_ok, gv, km = _expand_events(
        csc_ptr, csc_node, csc_meta, pos, gval, kmiss, P, mc)
    valid_e = pos < P
    cols = pos.clamp(0, P - 1).long()
    rk_e = torch.where(valid_e, ref_cols[cols].to(torch.int32), 0)
    rk = rk_e[:, :, None]

    def corr_nobm(a):
        t1 = (~km & ((gv & a) == 0)).to(torch.int32)
        if spr:
            sub = ((rk & a) == 0).to(torch.int32)
        else:
            sub = (a != rk).to(torch.int32)
        return t1 - sub

    c_am = corr_nobm(am)
    d_range = c_am - corr_nobm(ap)
    matched = (gv & am) != 0
    a_eff = torch.where(matched, am, ap)
    t1_bm = (~km & ((gv & a_eff) == 0)).to(torch.int32)
    if spr:
        a_r = torch.where((rk & am) != 0, am, ap)
        sub_bm = ((rk & a_r) == 0).to(torch.int32)
    else:
        sub_bm = torch.where((rk & am) != 0, (am != rk).to(torch.int32),
                             (ap != rk).to(torch.int32))
    d_point = torch.where(rootm == 1, 0, (t1_bm - sub_bm) - c_am)
    d_nc = torch.where((effm == 1) & (rootm == 0),
                       matched.to(torch.int32)
                       - ((rk & am) != 0).to(torch.int32), 0)
    ok = pair_ok.to(torch.int32)
    if sgn is not None:
        sgn = sgn.to(torch.int32)      # int8 * int32 products in int32
        ok = ok * sgn[:, :, None]
    d_range = d_range * ok
    d_point = d_point * ok
    d_nc = d_nc * ok

    r = torch.where(pair_ok, dfs_of.long()[u], n_pad)
    rend = torch.where(pair_ok, dfs_end_of.long()[u], n_pad)
    if col_index is not None:
        flat_b = col_index.long()[:, None, None].expand(B, K, mc)
    else:
        flat_b = (torch.arange(B, device=pos.device)
                  + col_offset)[:, None, None].expand(B, K, mc)
    add0_ind = (~kmiss & valid_e
                & ((gval.to(torch.int32) & rk_e) == 0)).to(torch.int32)
    if sgn is not None:
        add0_ind = add0_ind * sgn
    add0 = add0_ind.sum(1, dtype=torch.int32)
    return r, rend, flat_b, d_range, d_point, d_nc, add0


def _dev_score_nc(csc_ptr, csc_node, csc_meta, dfs_of, dfs_end_of,
                  ref_cols, pos, gval, kmiss,
                  ov_idx, ov_b, ov_val, ovn_idx, ovn_b, ovn_val,
                  base_dfs, nc_base_dfs, n_pad: int, b_pad: int, mc: int,
                  spr: bool, extra_cols: int = 0, cnt=None):
    """Shared core of X5 and X7's device path: device expansion, delta
    evaluation, the three difference-array scatters and the nc point
    scatter (plus the host-expanded overlay events of incremental appends),
    cumsum, add0.  cnt=(idx, b, val) adds an extra channel of extra_cols
    columns past the b_pad score columns, folded into the same scan.
    Returns (score, nc) [n_pad, b_pad] int32 in DFS order, and the extra
    channel's running sums [n_pad, extra_cols] when cnt is given."""
    r, rend, flat_b, d_range, d_point, d_nc, add0 = _entry_deltas(
        csc_ptr, csc_node, csc_meta, dfs_of, dfs_end_of, ref_cols,
        pos, gval, kmiss, n_pad, mc, spr)
    dev = base_dfs.device
    diff = torch.zeros((n_pad + 1, b_pad + extra_cols), dtype=torch.int32,
                       device=dev)
    _scatter_add(diff, r, flat_b, d_range + d_point)
    _scatter_add(diff, rend, flat_b, -d_range)
    _scatter_add(diff, (r + 1).clamp(max=n_pad), flat_b, -d_point)
    _scatter_add(diff, ov_idx, ov_b, ov_val)
    if cnt is not None:
        cnt_idx, cnt_b, cnt_val = cnt
        _scatter_add(diff, cnt_idx, b_pad + cnt_b.long(), cnt_val)
    ncd = torch.zeros((n_pad + 1, b_pad), dtype=torch.int32, device=dev)
    _scatter_add(ncd, r, flat_b, d_nc)
    _scatter_add(ncd, ovn_idx, ovn_b, ovn_val)
    del r, rend, flat_b, d_range, d_point, d_nc
    run = _scan_rows(diff[:n_pad])
    del diff
    score = run[:, :b_pad]
    score += base_dfs[:, None]
    score[:, :add0.shape[0]] += add0[None, :]
    nc = ncd[:n_pad]
    nc += nc_base_dfs[:, None]
    if cnt is not None:
        return score, nc, run[:, b_pad:]
    return score, nc


def interval_place_dev(csc_ptr, csc_node, csc_meta, dfs_of, dfs_end_of,
                       ref_cols, pos, gval, kmiss,
                       ov_idx, ov_b, ov_val, ovn_idx, ovn_b, ovn_val,
                       base_dfs, nc_base_dfs,
                       num_mut_dfs, is_leaf_dfs, is_root_dfs, active_dfs,
                       num_leaves_dfs, bfs_rank_dfs,
                       n_pad: int, b_pad: int, mc: int, spr: bool = False,
                       second: bool = False,
                       clade_self_dfs=None, clade_par_dfs=None,
                       n_clades: int = 0):
    """X5: interval_place with the events expanded on the device from the
    resident CSC index, so a batch uploads only its [B, K] entry arrays
    plus the (small) overlay event streams of incremental appends.  Equal
    to the host-expansion path (tested).  second=True appends the
    runner-up 4-tuple; n_clades > 0 the tie-set clade histogram."""
    score, nc = _dev_score_nc(
        csc_ptr, csc_node, csc_meta, dfs_of, dfs_end_of, ref_cols,
        pos, gval, kmiss, ov_idx, ov_b, ov_val, ovn_idx, ovn_b, ovn_val,
        base_dfs, nc_base_dfs, n_pad, b_pad, mc, spr)
    clades = (None if n_clades == 0
              else (clade_self_dfs, clade_par_dfs, n_clades))
    return _finish_place(score, nc, num_mut_dfs, is_leaf_dfs, is_root_dfs,
                         active_dfs, num_leaves_dfs, bfs_rank_dfs,
                         second=second, clades=clades)


# --- X6: shared-ancestry grouped placement ---------------------------------

EXACT_F32 = 1 << 24   # integers below this are exact in float32


def _closure_combine(x, M):
    """x [R, G] int32 @ M [G, B] (0/1 float32) -> [R, B] int32, exactly.

    torch has no integer matmul on CUDA, so the product runs in float32
    with TF32 off (as JAX's Precision.HIGHEST).  It is exact while every
    partial sum stays below 2^24 in magnitude, whatever the order of the
    sum: a row's absolute sum times M's largest entry bounds them all, and
    a batch past it raises instead of rounding."""
    if x.shape[1] == 0:
        return torch.zeros((x.shape[0], M.shape[1]), dtype=torch.int32,
                           device=x.device)
    bound = int(x.abs().sum(1, dtype=torch.int64).max()) * int(M.abs().max())
    if bound >= EXACT_F32:
        raise OverflowError(f"closure combine: partial sums up to {bound} "
                            f"are not exact in float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.matmul(x.to(torch.float32), M).to(torch.int32)


def interval_place_flatgrp_dev(csc_ptr, csc_node, csc_meta, dfs_of,
                               dfs_end_of, ref_cols,
                               epos, egval, ekmiss, esgn, ecol, grp_of,
                               closure,
                               base_dfs, nc_base_dfs,
                               num_mut_dfs, is_leaf_dfs, is_root_dfs,
                               active_dfs, num_leaves_dfs, bfs_rank_dfs,
                               n_pad: int, b_pad: int, g_pad: int,
                               mc: int, second: bool = False):
    """X6: shared-ancestry scoring over one flat entry list.  Every entry,
    residual and group alike, is an [E, 1] row with an explicit target
    scan column ecol [E] (0..b_pad-1 the samples, b_pad.. the group
    columns) and a sign esgn [E].  One expansion of E x mc pairs, one set
    of scatters into [n_pad + 1, b_pad + g_pad] (row n_pad the dump row),
    one scan; then sample b adds the scanned columns of every group on its
    anchor chain, closure[:, grp_of[b]] (_closure_combine), and the
    winners are reduced as in X5 (_finish_place).  Equal to X5 on the
    reconstructed full entry sets (tests)."""
    r, rend, flat_b, d_range, d_point, d_nc, add0_e = _entry_deltas(
        csc_ptr, csc_node, csc_meta, dfs_of, dfs_end_of, ref_cols,
        epos, egval, ekmiss, n_pad, mc, False, sgn=esgn, col_index=ecol)
    dev = base_dfs.device
    width = b_pad + g_pad
    diff = torch.zeros((n_pad + 1, width), dtype=torch.int32, device=dev)
    _scatter_add(diff, r, flat_b, d_range + d_point)
    _scatter_add(diff, rend, flat_b, -d_range)
    _scatter_add(diff, (r + 1).clamp(max=n_pad), flat_b, -d_point)
    ncd = torch.zeros((n_pad + 1, width), dtype=torch.int32, device=dev)
    _scatter_add(ncd, r, flat_b, d_nc)
    del r, rend, flat_b, d_range, d_point, d_nc
    run = _scan_rows(diff[:n_pad])
    del diff
    add0 = torch.zeros(width, dtype=torch.int32, device=dev)
    add0.index_add_(0, ecol.long(), add0_e)
    M = closure.to(torch.float32)[:, grp_of.long()]          # [g_pad, b_pad]
    score = run[:, :b_pad] + _closure_combine(run[:, b_pad:], M)
    del run
    nc = ncd[:n_pad, :b_pad] + _closure_combine(ncd[:n_pad, b_pad:], M)
    del ncd
    # the [g_pad] group add0 through the closure in int64 (exact)
    add0_c = add0[:b_pad] + (add0[b_pad:].long()[:, None]
                             * M.long()).sum(0).to(torch.int32)
    score += base_dfs[:, None]
    score += add0_c[None, :]
    nc += nc_base_dfs[:, None]
    return _finish_place(score, nc, num_mut_dfs, is_leaf_dfs, is_root_dfs,
                         active_dfs, num_leaves_dfs, bfs_rank_dfs,
                         second=second)


def pad_events(idx, b, val, n_pad: int):
    """Host event arrays -> int32 numpy (idx, b, val).  The JAX engine
    padded them up a x1.5 length ladder so XLA would not recompile; eager
    torch takes any length, so nothing is added.  idx must lie in
    0..n_pad (n_pad is the dump row): an index past it would be a
    device-side assert on CUDA, so it raises here instead."""
    idx = np.asarray(idx, dtype=np.int32)
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) > n_pad):
        raise IndexError(f"event row outside 0..{n_pad}")
    return (idx, np.asarray(b, dtype=np.int32),
            np.asarray(val, dtype=np.int32))


# --- X7: the SPR destination search -----------------------------------------

def _finish_spr(score, nc, cnt, num_mut_dfs, is_root_dfs, active_dfs,
                num_leaves_dfs, bfs_rank_dfs, level_dfs,
                src_level, src_lo, src_hi, src_parent_row, radius: int,
                n_pad: int):
    """SPR validity + radius mask + tie-broken reduction, shared by the
    host- and device-expansion entry points.  The lca level of (src, dst)
    is cnt - 1 (cnt counts the source's ancestors whose DFS interval holds
    dst); src_lo/src_hi/src_parent_row are DFS rows (-1 for no parent row).
    Returns (best_cost [B], best_row [B] int32, hu_best [B] bool)."""
    hu = nc < num_mut_dfs[:, None]
    # dest leaves get sibling-split via has_unique (optimize/spr.py)
    valid = (is_root_dfs[:, None] | (hu & (nc > 0)) | ~hu) \
        & active_dfs[:, None]
    lca_lvl = cnt - 1
    dist = level_dfs[:, None] + src_level[None, :] - 2 * lca_lvl
    rows = torch.arange(n_pad, dtype=torch.int32,
                        device=score.device)[:, None]
    in_sub = (rows >= src_lo[None, :]) & (rows < src_hi[None, :])
    valid &= (dist <= radius) & ~in_sub & (rows != src_parent_row[None, :])
    del dist, in_sub
    best, best_row, _ = _tie_reduce(score, valid, num_leaves_dfs,
                                    bfs_rank_dfs)
    hu_best = torch.gather(hu, 0, best_row.long()[None, :])[0]
    return best, best_row, hu_best


def interval_spr_dev(csc_ptr, csc_node, csc_meta, dfs_of, dfs_end_of,
                     ref_cols, pos, gval,
                     cnt_idx, cnt_b, cnt_val,
                     base_dfs, nc_base_dfs,
                     num_mut_dfs, is_root_dfs, active_dfs,
                     num_leaves_dfs, bfs_rank_dfs, level_dfs,
                     src_level, src_lo, src_hi, src_parent_row, radius: int,
                     n_pad: int, b_pad: int, mc: int):
    """X7 with the events expanded on the device from the resident CSC
    index: a chunk uploads its [B, K] source-deviation arrays and the
    (small) ancestor-interval events, and the ancestor count rides in
    b_pad extra columns of the score scan.  Equal to interval_spr
    (tested)."""
    B, K = pos.shape
    kmiss = torch.zeros((B, K), dtype=torch.bool, device=pos.device)
    z = torch.zeros(0, dtype=torch.int64, device=pos.device)
    score, nc, cnt = _dev_score_nc(
        csc_ptr, csc_node, csc_meta, dfs_of, dfs_end_of, ref_cols,
        pos, gval, kmiss, z, z, z, z, z, z,
        base_dfs, nc_base_dfs, n_pad, b_pad, mc, spr=True,
        extra_cols=b_pad, cnt=(cnt_idx, cnt_b, cnt_val))
    return _finish_spr(score, nc, cnt, num_mut_dfs, is_root_dfs,
                       active_dfs, num_leaves_dfs, bfs_rank_dfs, level_dfs,
                       src_level, src_lo, src_hi, src_parent_row, radius,
                       n_pad)


def interval_spr(ev_idx, ev_b, ev_val, nc_idx, nc_b, nc_val,
                 cnt_idx, cnt_b, cnt_val,
                 base_dfs, nc_base_dfs, add0,
                 num_mut_dfs, is_root_dfs, active_dfs,
                 num_leaves_dfs, bfs_rank_dfs, level_dfs,
                 src_level, src_lo, src_hi, src_parent_row, radius: int,
                 n_pad: int, b_pad: int):
    """X7: the SPR destination search for a batch of pruned sources over
    host-expanded events.  The radius bound is a nested-interval count too:
    the lca level of (src, dst) for every dst is (#proper ancestors of src
    whose DFS interval holds dst) - 1, so cnt_* adds +1 over each ancestor
    interval in b_pad extra columns of the same difference array and scan
    (replacing the reference's per-node pointer walks,
    Profitable_Moves_Enumerators.hpp:166).  Returns (best_cost [B],
    best_dfs_row [B], hu_best [B])."""
    dev = base_dfs.device
    diff = torch.zeros((n_pad + 1, 2 * b_pad), dtype=torch.int32, device=dev)
    _scatter_add(diff, ev_idx, ev_b, ev_val)
    _scatter_add(diff, cnt_idx, b_pad + cnt_b.long(), cnt_val)
    run = _scan_rows(diff[:n_pad])
    del diff
    score = run[:, :b_pad]
    score += base_dfs[:, None]
    score += add0[None, :]
    ncd = torch.zeros((n_pad + 1, b_pad), dtype=torch.int32, device=dev)
    _scatter_add(ncd, nc_idx, nc_b, nc_val)
    nc = ncd[:n_pad]
    nc += nc_base_dfs[:, None]
    return _finish_spr(score, nc, run[:, b_pad:], num_mut_dfs, is_root_dfs,
                       active_dfs, num_leaves_dfs, bfs_rank_dfs, level_dfs,
                       src_level, src_lo, src_hi, src_parent_row, radius,
                       n_pad)


def shard_events(ev, nd: int, bl: int, n_pad: int):
    """Split host (idx, b, val) events by the shard that owns their source
    (b // bl) into nd runs, source ids made local; a list of nd int32
    (idx, b, val) triples.  The JAX version stacked the runs into one
    bucketed [nd, cap] array for shard_map; here each shard uploads its
    own run."""
    idx, b, val = pad_events(*ev, n_pad)
    owner = b // bl
    order = np.argsort(owner, kind="stable")
    idx, b, val, owner = idx[order], b[order], val[order], owner[order]
    cuts = np.searchsorted(owner, np.arange(nd + 1))
    return [(idx[cuts[k]:cuts[k + 1]], b[cuts[k]:cuts[k + 1]] - k * bl,
             val[cuts[k]:cuts[k + 1]]) for k in range(nd)]


def _spr_sharded_fn(mesh, n_pad: int, bl: int):
    """X7 over a 1-D batch mesh (the counterpart of the JAX shard_map of
    interval_spr): shard k scores the sources [k * bl, (k + 1) * bl) on
    its device and stream against its copy of the DFS metadata.  Returns
    fn(ev, nc, cnt, metas, add0, src_level, src_lo, src_hi,
    src_parent_row, radius) -> host int32 [3, B] (best_cost, best_row,
    hu_best): ev/nc/cnt are shard_events runs, metas one _dfs_meta dict a
    shard, the rest host [B] arrays."""
    from ..parallel.mesh import for_each_shard

    def fn(ev, nc, cnt, metas, add0, src_level, src_lo, src_hi,
           src_parent_row, radius: int):
        B = len(add0)

        def one(idx):
            k = idx[0]
            lo, hi = min(k * bl, B), min((k + 1) * bl, B)
            if hi == lo:
                return None
            device = mesh.devices[idx]
            meta = metas[k]

            def t(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(device)
            out = interval_spr(
                *(t(a) for a in ev[k]), *(t(a) for a in nc[k]),
                *(t(a) for a in cnt[k]), meta["base"], meta["nc_base"],
                t(add0[lo:hi]), meta["num_mut"], meta["is_root"],
                meta["active"], meta["num_leaves"], meta["bfs_rank"],
                meta["level"], t(src_level[lo:hi]), t(src_lo[lo:hi]),
                t(src_hi[lo:hi]), t(src_parent_row[lo:hi]), radius,
                n_pad, hi - lo)
            return torch.stack([o.to(torch.int32) for o in out])
        res = for_each_shard(mesh, one)
        return torch.cat([res[idx].cpu() for idx in mesh.indices()
                          if res[idx] is not None], dim=1).numpy()
    return fn


# --- X9: segment-query placement, O(events * log N), no [N, B] matrix -------
#
# The [N, B] score matrix is piecewise constant per sample: between a
# sample's difference-array event rows, score(n) = base(n) + add0 + R with R
# the event prefix at the segment, and nc(n) = nc_base(n) (nc point events
# only touch event rows).  So validity off event rows is the STATIC
# validity, and the tie-broken argmin over a segment is a range query of a
# monoid over (base, count@min, num_leaves, bfs_rank, row) restricted to
# statically-valid rows, answered from a sparse table.  Per sample the
# reduction touches its ~3 * pairs event rows exactly plus one table query a
# segment, with the results of X5 (bit-identical; tests).  Row N is the
# padding and sentinel row, as X5's dump row; every index into an [N] array
# is clamped first (an out-of-range index is a device assert on CUDA).


def _seg_combine(a, b):
    """Monoid combine for (key, cnt, lv, rk, row): min key; equal keys sum
    counts and keep the (num_leaves, bfs_rank)-max winner — the reference
    tie-break (usher_mapper.cpp:458-497)."""
    ka, ca, la, ra, wa = a
    kb, cb, lb, rb, wb = b
    key = torch.minimum(ka, kb)
    cnt = torch.where(ka == kb, ca + cb, torch.where(kb < ka, cb, ca))
    b_wins = (kb < ka) | ((kb == ka)
                          & ((lb > la) | ((lb == la) & (rb > ra))))
    lv = torch.where(b_wins, lb, la)
    rk = torch.where(b_wins, rb, ra)
    row = torch.where(b_wins, wb, wa)
    return key, cnt, lv, rk, row


def _build_seg_table(base_dfs, nc_base_dfs, num_mut_dfs, is_leaf_dfs,
                     is_root_dfs, active_dfs, num_leaves_dfs,
                     bfs_rank_dfs, n_pad: int):
    """Sparse table of the static-valid monoid over the n_pad DFS rows:
    T[k][i] summarizes rows [i, i + 2^k), cells past the end the identity.
    Returns the five [L, n_pad] int32 fields, the static has_unique [n_pad]
    and L."""
    dev = base_dfs.device
    hu_s = nc_base_dfs < num_mut_dfs
    ncp = nc_base_dfs > 0
    leaf = is_leaf_dfs
    static_valid = (is_root_dfs | (leaf & ncp) | (~leaf & hu_s & ncp)
                    | (~leaf & ~hu_s)) & active_dfs
    i32 = dict(dtype=torch.int32, device=dev)
    key0 = torch.where(static_valid, base_dfs.to(torch.int32), BIG)
    levels = [(key0, torch.ones(n_pad, **i32),
               num_leaves_dfs.to(torch.int32), bfs_rank_dfs.to(torch.int32),
               torch.arange(n_pad, **i32))]
    L = max(1, int(n_pad).bit_length())
    pad_cell = (BIG, 0, -1, -1, n_pad)
    for k in range(1, L):
        sh = 1 << (k - 1)
        prev = levels[-1]
        shifted = tuple(
            torch.cat([p[sh:], torch.full((min(sh, n_pad),), pc, **i32)])
            for p, pc in zip(prev, pad_cell))
        levels.append(_seg_combine(prev, shifted))
    return (tuple(torch.stack([lv[f] for lv in levels]) for f in range(5)),
            hu_s, L)


def _seg_query(table, L, l, r):
    """Range query over [l, r] (inclusive; empty when l > r) — a DISJOINT
    binary-lifting walk (the two-overlapping-lookup trick holds only for
    idempotent monoids; count@min is not one)."""
    tk, tc, tl, tr, tw = table
    n_pad = tk.shape[1]
    acc = (torch.full_like(l, BIG), torch.zeros_like(l),
           torch.full_like(l, -1), torch.full_like(l, -1),
           torch.full_like(l, n_pad))
    cur = l.clamp(0, n_pad)
    rem = (r - l + 1).clamp(min=0)
    for k in range(L - 1, -1, -1):
        step = 1 << k
        take = rem >= step
        idx = cur.clamp(0, n_pad - 1).long()
        cell = (tk[k][idx], tc[k][idx], tl[k][idx], tr[k][idx], tw[k][idx])
        cand = _seg_combine(acc, cell)
        acc = tuple(torch.where(take, c, a) for c, a in zip(cand, acc))
        cur = torch.where(take, cur + step, cur)
        rem = torch.where(take, rem - step, rem)
    return acc


def _seg_reduce(cands):
    """(best, best_row, num_best, hu_best) from candidate tuples
    (score, cnt, lv, rk, row, hu) each [B, S] — the min / count /
    (leaves, rank)-max semantics of _tie_reduce over full matrices.  The
    winner is the first candidate holding the winning rank (argmax over an
    int32 mask returns the first maximum)."""
    score, cnt, lv, rk, row, hu = cands
    best = score.min(1).values
    at = score == best[:, None]
    num_best = torch.where(at, cnt, 0).sum(1, dtype=torch.int32)
    best_lv = torch.where(at, lv, -1).max(1).values
    at2 = at & (lv == best_lv[:, None])
    best_rk = torch.where(at2, rk, -1).max(1).values
    j = torch.argmax((at2 & (rk == best_rk[:, None])).to(torch.int32),
                     dim=1)[:, None]
    best_row = torch.gather(row, 1, j)[:, 0]
    hu_best = torch.gather(hu, 1, j)[:, 0]
    return best, best_row.to(torch.int32), num_best, hu_best


def _seg_candidates(table, hu_s, L, rows_sorted, P_incl, add0,
                    nc_events, base_dfs, nc_base_dfs, num_mut_dfs,
                    is_leaf_dfs, is_root_dfs, active_dfs, num_leaves_dfs,
                    bfs_rank_dfs, n_pad: int, exclude_row=None):
    """Candidate set for one reduction pass: exact evaluations at the
    (deduplicated) event rows + one monoid query per inter-event segment.
    rows_sorted [B, Et] int32 (n_pad = padding); exclude_row [B] masks one
    DFS row (the runner-up pass)."""
    B, Et = rows_sorted.shape
    dev = rows_sorted.device
    # keep-LAST duplicate: its inclusive prefix is the full sum at the row
    keep = torch.cat([rows_sorted[:, :-1] != rows_sorted[:, 1:],
                      torch.ones((B, 1), dtype=torch.bool, device=dev)], 1)
    rc = rows_sorted.clamp(0, n_pad - 1).long()
    # nc at each row: every nc event's row is a score-event row, so the nc
    # values ride the same sort as a payload channel and the per-row sum is
    # a prefix difference across the duplicate group
    iota = torch.arange(Et, dtype=torch.int32, device=dev).expand(B, Et)
    kept_idx = torch.where(keep, iota, -1)
    prev_kept = torch.cat(
        [torch.full((B, 1), -1, dtype=torch.int32, device=dev),
         torch.cummax(kept_idx, dim=1).values[:, :-1]], 1)
    ncP0 = torch.cat([torch.zeros((B, 1), dtype=torch.int32, device=dev),
                      nc_events], 1)
    nc_at = nc_events - torch.gather(ncP0, 1, (prev_kept + 1).long())
    nc_r = nc_base_dfs[rc] + nc_at
    hu_r = nc_r < num_mut_dfs[rc]
    ncp_r = nc_r > 0
    leaf_r = is_leaf_dfs[rc]
    valid_r = (is_root_dfs[rc] | (leaf_r & ncp_r)
               | (~leaf_r & hu_r & ncp_r)
               | (~leaf_r & ~hu_r)) & active_dfs[rc]
    score_r = base_dfs[rc] + add0[:, None] + P_incl
    mask_r = keep & (rows_sorted < n_pad) & valid_r
    if exclude_row is not None:
        mask_r &= rows_sorted != exclude_row[:, None]
    exact = (torch.where(mask_r, score_r, BIG),
             torch.ones((B, Et), dtype=torch.int32, device=dev),
             num_leaves_dfs[rc].to(torch.int32),
             bfs_rank_dfs[rc].to(torch.int32), rows_sorted, hu_r)

    # segments: [prev_row + 1, row - 1] with R = prefix at prev_row;
    # sentinel -1/0 in front, n_pad behind (padding rows land there)
    pr_rows = torch.cat([torch.full((B, 1), -1, dtype=torch.int32,
                                    device=dev), rows_sorted], 1)
    pr_P = torch.cat([torch.zeros((B, 1), dtype=torch.int32, device=dev),
                      P_incl], 1)
    nx_rows = torch.cat([rows_sorted, torch.full((B, 1), n_pad,
                                                 dtype=torch.int32,
                                                 device=dev)], 1)
    l = pr_rows + 1
    r = nx_rows - 1

    def seg(q):
        kq, cq, lq, rq, wq = q
        return (torch.where(kq >= BIG, BIG, kq + add0[:, None] + pr_P),
                cq, lq, rq, wq, hu_s[wq.clamp(0, n_pad - 1).long()])
    if exclude_row is None:
        segs = [seg(_seg_query(table, L, l, r))]
    else:
        # runner-up pass: split the segment containing the excluded row
        w = exclude_row[:, None]
        contains = (l <= w) & (w <= r)
        one = torch.ones_like(l)
        segs = [seg(_seg_query(table, L, l, torch.where(contains, w - 1, r))),
                seg(_seg_query(table, L, torch.where(contains, w + 1, one),
                               torch.where(contains, r, one - 1)))]
    return tuple(torch.cat(parts, 1) for parts in zip(exact, *segs))


def interval_place_seg_dev(csc_ptr, csc_node, csc_meta, dfs_of,
                           dfs_end_of, ref_cols, pos, gval, kmiss,
                           ov_rows, ov_vals, ovn_rows, ovn_vals,
                           base_dfs, nc_base_dfs,
                           num_mut_dfs, is_leaf_dfs, is_root_dfs,
                           active_dfs, num_leaves_dfs, bfs_rank_dfs,
                           n_pad: int, mc: int, ecap: int,
                           second: bool = False):
    """X9: placement through segment queries.  The events are expanded on
    the device as in X5 (interval_place_dev), but no [n_pad, B] matrix is
    formed.  ov_rows/ov_vals [B, E] are the overlay score events of
    incremental appends per sample (pad_overlay_by_sample; row n_pad =
    padding), ovn_* the overlay nc point events.  ecap must be at least the
    real (non-padding) pair count of every sample (the caller computes it
    on the host): the [K, mc] expansion is mostly padding, and it is
    compacted to ecap slots before the sort and the table walks.  Returns
    X5's (best, best_dfs_row, num_best, hu_best) [+ the runner-up 4-tuple
    with second=True]."""
    P = ref_cols.shape[0]
    B, K = pos.shape
    dev = pos.device
    u, am, ap, rootm, effm, pair_ok, gv, km = _expand_events(
        csc_ptr, csc_node, csc_meta, pos, gval, kmiss, P, mc)
    valid_e = pos < P
    cols = pos.clamp(0, P - 1).long()
    rk_e = torch.where(valid_e, ref_cols[cols].to(torch.int32), 0)
    rk = rk_e[:, :, None]

    def corr_nobm(a):
        t1 = (~km & ((gv & a) == 0)).to(torch.int32)
        return t1 - (a != rk).to(torch.int32)

    c_am = corr_nobm(am)
    d_range = c_am - corr_nobm(ap)
    matched = (gv & am) != 0
    a_eff = torch.where(matched, am, ap)
    t1_bm = (~km & ((gv & a_eff) == 0)).to(torch.int32)
    sub_bm = torch.where((rk & am) != 0, (am != rk).to(torch.int32),
                         (ap != rk).to(torch.int32))
    d_point = torch.where(rootm == 1, 0, (t1_bm - sub_bm) - c_am)
    d_nc = torch.where((effm == 1) & (rootm == 0),
                       matched.to(torch.int32)
                       - ((rk & am) != 0).to(torch.int32), 0)
    ok = pair_ok.to(torch.int32)
    W = K * mc
    d_range = (d_range * ok).reshape(B, W)
    d_point = (d_point * ok).reshape(B, W)
    d_nc = (d_nc * ok).reshape(B, W)
    r_s = torch.where(pair_ok, dfs_of[u].to(torch.int32),
                      n_pad).reshape(B, W)
    r_e = torch.where(pair_ok, dfs_end_of[u].to(torch.int32),
                      n_pad).reshape(B, W)

    # compact the ok pairs into ecap slots (cumsum-position scatter), so
    # the sorts and table walks run at O(ecap), not O(K * mc); every pad
    # pair gets a distinct overflow slot past ecap, so no two stores of a
    # row share a destination
    okf = pair_ok.reshape(B, W)
    lane = torch.arange(W, device=dev).expand(B, W)
    dst = torch.where(okf, torch.cumsum(okf, dim=1) - 1, ecap + lane)

    def compact(x, fill):
        out = torch.full((B, ecap + W), fill, dtype=x.dtype, device=dev)
        out.scatter_(1, dst, x)
        return out[:, :ecap]

    d_range = compact(d_range, 0)
    d_point = compact(d_point, 0)
    d_nc = compact(d_nc, 0)
    r_s = compact(r_s, n_pad)
    r_e = compact(r_e, n_pad)

    add0 = (~kmiss & valid_e
            & ((gval.to(torch.int32) & rk_e) == 0)).sum(1, dtype=torch.int32)

    # per-sample score events (3 per pair) + overlay events + the overlay
    # nc rows as zero-val boundaries (their rows must split segments)
    ov_rows = ov_rows.to(torch.int32)
    ovn_rows = ovn_rows.to(torch.int32)
    ev_rows = torch.cat([r_s, (r_s + 1).clamp(max=n_pad), r_e, ov_rows,
                         ovn_rows], 1)
    ev_vals = torch.cat([d_range + d_point, -d_point, -d_range,
                         ov_vals.to(torch.int32),
                         torch.zeros_like(ovn_rows)], 1)
    # nc payload channel aligned with the event streams: pair starts carry
    # d_nc, overlay-nc boundary rows carry ovn_vals, the rest 0
    ev_ncv = torch.cat([d_nc, torch.zeros_like(d_point),
                        torch.zeros_like(d_range), torch.zeros_like(ov_rows),
                        ovn_vals.to(torch.int32)], 1)
    rows_sorted, order = torch.sort(ev_rows, dim=1, stable=True)
    P_incl = torch.cumsum(torch.gather(ev_vals, 1, order), dim=1,
                          dtype=torch.int32)
    nc_events = torch.cumsum(torch.gather(ev_ncv, 1, order), dim=1,
                             dtype=torch.int32)

    table, hu_s, L = _build_seg_table(
        base_dfs, nc_base_dfs, num_mut_dfs, is_leaf_dfs, is_root_dfs,
        active_dfs, num_leaves_dfs, bfs_rank_dfs, n_pad)
    margs = (base_dfs, nc_base_dfs, num_mut_dfs, is_leaf_dfs,
             is_root_dfs, active_dfs, num_leaves_dfs, bfs_rank_dfs)
    cands = _seg_candidates(table, hu_s, L, rows_sorted, P_incl, add0,
                            nc_events, *margs, n_pad)
    out = _seg_reduce(cands)
    if second:
        cands2 = _seg_candidates(table, hu_s, L, rows_sorted, P_incl,
                                 add0, nc_events, *margs, n_pad,
                                 exclude_row=out[1])
        out = out + _seg_reduce(cands2)
    return out


def pad_overlay_by_sample(idx, b, val, b_pad: int, n_pad: int):
    """Flat overlay event streams (row, sample, val) -> per-sample padded
    [b_pad, E] int32 arrays for X9 (padding row = n_pad), E the largest
    per-sample count (the JAX engine rounded it up a bucket ladder for
    XLA's shapes; eager torch takes any width)."""
    b = np.asarray(b, dtype=np.int64)
    counts = (np.bincount(b, minlength=b_pad) if len(b)
              else np.zeros(b_pad, np.int64))
    E = int(counts.max()) if len(b) else 0
    rows = np.full((b_pad, E), n_pad, np.int32)
    vals = np.zeros((b_pad, E), np.int32)
    if len(b):
        order = np.argsort(b, kind="stable")
        ofs = np.cumsum(counts) - counts   # group start per sample
        pos_in = np.arange(len(b)) - ofs[b[order]]
        rows[b[order], pos_in] = np.asarray(idx)[order]
        vals[b[order], pos_in] = np.asarray(val)[order]
    return rows, vals
