"""usher_tpu_torch.ops.placement_sparse against the JAX Pallas path.

The plain twins of the B1/B1-spr/B2 kernels run on CPU tensors and must
equal usher_tpu.ops.placement_pallas (Pallas in interpret mode) bit for bit
on random MATs with ambiguous and missing entries, padding slots and
inactive slots, and so must the BigMAT column path score_cols_T.  The CUDA kernels themselves are compared with the plain twins on the
card by chip_smoke.py; here the kernels' host-side pieces (slot words, the
launch plan) and numpy transcriptions of the kernels' structure (the
persistent walk over row groups with its per-block fold and the exact
partial merge, the K-slice split over lanes, the byte-parallel row sweep)
are checked against the plain twins.  Tolerance: none (integer
arithmetic).
"""

import numpy as np
import pytest
import torch

from usher_tpu.core.flat import FlatMAT as JFlatMAT
from usher_tpu.ops import placement as jdev
from usher_tpu.ops import placement_pallas as pp
from usher_tpu_torch.core.flat import FlatMAT
from usher_tpu_torch.ops import _build
from usher_tpu_torch.ops import placement as dev
from usher_tpu_torch.ops import placement_sparse as ps
from usher_tpu_torch.utils.device import apply_platform_env

from test_placement import random_mat, random_sample
from test_torch_hostlayers import port_tree


def _case(seed, n_leaves=20, n_positions=15, n_samples=5, n_entries=6):
    rng = np.random.default_rng(seed)
    T, ref = random_mat(rng, n_leaves=n_leaves, n_positions=n_positions)
    positions = np.array(sorted(ref), dtype=np.int64)
    refarr = np.array([ref[p] for p in positions.tolist()], dtype=np.uint8)
    jflat = JFlatMAT(T, positions, refarr, "c")
    flat = FlatMAT(port_tree(T), positions, refarr, "c")
    samples = [random_sample(rng, ref, n_entries) for _ in range(n_samples)]
    return jflat, flat, samples


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _meta(flat):
    meta = flat.order_arrays()
    return meta, tuple(_t(meta[k]) for k in (
        "active", "is_leaf", "is_root_mask", "num_leaves", "bfs_rank"))


@pytest.mark.parametrize("seed", list(range(4)))
def test_sparsify_matches_jax(seed):
    jflat, flat, samples = _case(seed)
    for k_slots in (None, 16):
        got = ps.sparsify(samples, flat.pos_index, flat.P_pad, k_slots)
        want = pp.sparsify(samples, jflat.pos_index, jflat.P_pad, k_slots)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    g, E, miss = flat.encode_samples(samples)
    for a, b in zip(ps.sparsify_dense(g, E, miss),
                    pp.sparsify_dense(g, E, miss)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("seed", list(range(4)))
def test_score_sparse_T_matches_jax(seed):
    jflat, flat, samples = _case(seed)
    st_j, par_j = jflat.sync()
    pos, gval, kmiss = pp.sparsify(samples, jflat.pos_index, jflat.P_pad)
    want = pp.score_sparse_T(st_j, par_j, jflat.root_slot,
                             np.asarray(jflat.ref), pos, gval, kmiss,
                             pos.shape[1])
    st, parent = flat.sync()
    got = ps.score_sparse_T(st, parent, flat.root_slot, flat.ref_dev,
                            _t(pos), _t(gval), _t(kmiss))
    # every row, inactive slots included (neither side masks them)
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.int32
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_placement_step_sparse_matches_jax(seed):
    jflat, flat, samples = _case(seed, n_leaves=30)
    st_j, par_j = jflat.sync()
    jmeta = jflat.order_arrays()
    pos, gval, kmiss = pp.sparsify(samples, jflat.pos_index, jflat.P_pad)
    want = pp.placement_step_sparse(
        st_j, par_j, jflat.root_slot, np.asarray(jflat.ref),
        jmeta["active"], jmeta["is_leaf"], jmeta["is_root_mask"],
        jmeta["num_leaves"], jmeta["bfs_rank"], pos, gval, kmiss,
        pos.shape[1])
    st, parent = flat.sync()
    _, m = _meta(flat)
    got = ps.placement_step_sparse(st, parent, flat.root_slot, flat.ref_dev,
                                   *m, _t(pos), _t(gval), _t(kmiss))
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))


@pytest.mark.parametrize("k_slots", [8, 64, 2048])
def test_wide_k_matches_dense(k_slots):
    """K beyond the TPU kernel's tile limit (TBK=1024): the port loops over
    K, so any power of two matches the dense formula."""
    jflat, flat, samples = _case(5, n_leaves=25, n_positions=40,
                                 n_samples=6, n_entries=30)
    st, parent = flat.sync()
    meta, m = _meta(flat)
    pos, gval, kmiss = ps.sparsify(samples, flat.pos_index, flat.P_pad,
                                   k_slots)
    assert pos.shape[1] == max(k_slots, 32)
    score_t, nc_t, nnm = ps.score_sparse_T(
        st, parent, flat.root_slot, flat.ref_dev, _t(pos), _t(gval),
        _t(kmiss))
    g, E, miss = flat.encode_samples(samples)
    score, nc, nnm_d = dev.score_batch(st, parent, flat.root_slot,
                                       flat.ref_dev, m[0], _t(g), _t(E),
                                       _t(miss))
    act = meta["active"]
    np.testing.assert_array_equal(score_t.T.numpy()[:, act],
                                  score.numpy()[:, act])
    np.testing.assert_array_equal(nc_t.T.numpy(), nc.numpy())
    np.testing.assert_array_equal(nnm.numpy(), nnm_d.numpy())
    best = ps.placement_step_sparse(st, parent, flat.root_slot, flat.ref_dev,
                                    *m, _t(pos), _t(gval), _t(kmiss))
    best_d = dev.placement_step(st, parent, flat.root_slot, flat.ref_dev,
                                *m, _t(g), _t(E), _t(miss))
    for a, b in zip(best, best_d):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("seed", [50, 51, 52])
def test_score_entries_spr_matches_pallas(seed):
    """B1-spr's plain twin (spr=True) equals _score_entries_T(spr=True) on
    the same st/stp, ambiguous masks and padding slots included; spr=False
    equals it too.  Path states here are random ambiguity masks (Fitch
    sets), where the two modes' base terms differ, and they do."""
    jflat, flat, samples = _case(seed, n_leaves=30)
    rng = np.random.default_rng(seed)
    _, parent = flat.sync()
    st = _t(rng.integers(1, 16, size=tuple(flat.st_host.shape),
                         dtype=np.uint8))
    stp = dev.parent_states(st, parent, flat.root_slot)
    base, nc_base, _ = ps.row_reductions(st, stp, flat.ref_dev)
    pos, gval, kmiss = ps.sparsify(samples, flat.pos_index, flat.P_pad)
    nonpad = pos < flat.P
    gval[nonpad] = rng.integers(1, 16, size=int(nonpad.sum()),
                                dtype=np.uint8)
    kmiss[:] = False
    outs = {}
    for spr in (False, True):
        want = pp._score_entries_T(st.numpy(), stp.numpy(), flat.ref,
                                   base.numpy(), nc_base.numpy(), pos, gval,
                                   kmiss, pos.shape[1], spr=spr)
        got = ps.score_entries_T(st, stp, flat.ref_dev, base, nc_base,
                                 _t(pos), _t(gval), _t(kmiss), spr=spr)
        for g_, w_ in zip(got, want):
            np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
        outs[spr] = got[0]
    assert not torch.equal(outs[False], outs[True])


@pytest.mark.parametrize("k_slots", [4, 16])
@pytest.mark.parametrize("spr", [False, True])
def test_score_entries_3d_matches_pallas(k_slots, spr):
    """B1-3d's plain twin equals _score_entries_3d (interpret mode) on the
    real rows and samples of its [bt, n_pad, tb] tiles, with the TPU
    kernel's own tile shape (tb = TBK // K, n_pad a multiple of TN), on
    multi-base states; re-laid, the tiles are score_entries_T_plain."""
    jflat, flat, samples = _case(70 + k_slots, n_leaves=30, n_samples=7,
                                 n_entries=3)
    rng = np.random.default_rng(k_slots)
    _, parent = flat.sync()
    st = _t(rng.integers(1, 16, size=tuple(flat.st_host.shape),
                         dtype=np.uint8))
    stp = dev.parent_states(st, parent, flat.root_slot)
    base, nc_base, _ = ps.row_reductions(st, stp, flat.ref_dev)
    pos, gval, kmiss = pp.sparsify(samples, jflat.pos_index, jflat.P_pad,
                                   k_slots)
    assert pos.shape[1] == k_slots
    nonpad = pos < flat.P
    gval[nonpad] = rng.integers(1, 16, size=int(nonpad.sum()),
                                dtype=np.uint8)
    w3, wn3, N, B, n_pad, b_pad = pp._score_entries_3d(
        st.numpy(), stp.numpy(), flat.ref, base.numpy(), nc_base.numpy(),
        pos, gval, kmiss, k_slots, spr=spr)
    tb = pp.TBK // k_slots
    assert n_pad % pp.TN == 0 and n_pad >= N and b_pad == tb
    args = (st, stp, flat.ref_dev, base, nc_base, _t(pos), _t(gval),
            _t(kmiss))
    before = ps.score_entries_3d.launches
    for fn in (ps.score_entries_3d_plain, ps.score_entries_3d):
        s3, n3, N2, B2, n_pad2, b_pad2 = fn(*args, tb, spr=spr, n_pad=n_pad)
        assert (N2, B2, n_pad2, b_pad2) == (N, B, n_pad, b_pad)
        assert s3.shape == tuple(np.asarray(w3).shape) and \
            s3.dtype == torch.int32
        np.testing.assert_array_equal(s3.numpy()[:, :N, :B],
                                      np.asarray(w3)[:, :N, :B])
        np.testing.assert_array_equal(n3.numpy()[:, :N, :B],
                                      np.asarray(wn3)[:, :N, :B])
    assert ps.score_entries_3d.launches == before    # CPU: the plain twin
    flat_T = ps.score_entries_T_plain(*args, spr=spr)
    np.testing.assert_array_equal(ps.tiles_to_T(s3, N, B).numpy(),
                                  flat_T[0].numpy())
    np.testing.assert_array_equal(ps.tiles_to_T(n3, N, B).numpy(),
                                  flat_T[1].numpy())


@pytest.mark.parametrize("tb", [1, 3, 8])
def test_score_entries_3d_tiles_any_width(tb):
    """tb need not divide B, and n_pad defaults to N: sample b sits at
    [b // tb, :, b % tb]."""
    _, flat, samples = _case(80, n_leaves=20, n_samples=7)
    st, parent = flat.sync()
    stp = dev.parent_states(st, parent, flat.root_slot)
    base, nc_base, _ = ps.row_reductions(st, stp, flat.ref_dev)
    pos, gval, kmiss = (_t(x) for x in ps.sparsify(
        samples, flat.pos_index, flat.P_pad))
    args = (st, stp, flat.ref_dev, base, nc_base, pos, gval, kmiss)
    s3, n3, N, B, n_pad, b_pad = ps.score_entries_3d(*args, tb)
    assert (N, B, n_pad) == (st.shape[0], 7, st.shape[0])
    assert b_pad == -(-7 // tb) * tb and s3.shape == (b_pad // tb, N, tb)
    score_t, nc_t = ps.score_entries_T_plain(*args)
    for b in range(B):
        np.testing.assert_array_equal(s3[b // tb, :, b % tb].numpy(),
                                      score_t[:, b].numpy())
    np.testing.assert_array_equal(ps.tiles_to_T(n3, N, B).numpy(),
                                  nc_t.numpy())
    np.testing.assert_array_equal(
        ps.tiles_from_T(score_t, tb, N).numpy(), s3.numpy())
    with pytest.raises(ValueError, match="n_pad"):
        ps.score_entries_3d(*args, tb, n_pad=N - 1)
    with pytest.raises(ValueError, match="tb"):
        ps.score_entries_3d(*args, 0)


@pytest.mark.parametrize("seed,spr", [(60, False), (61, True), (62, True)])
def test_score_cols_T_matches_pallas(seed, spr):
    """score_cols_T (pointer-doubled column states + B1 / B1-spr plain
    twin) equals placement_pallas.score_cols_T on a BigMAT's columns, with
    padding slots mapped past the column axis."""
    from usher_tpu.core.bigmat import BigMAT, _ranges
    rng = np.random.default_rng(seed)
    T, ref = random_mat(rng, n_leaves=35, n_positions=20)
    positions = np.array(sorted(ref), dtype=np.int64)
    refarr = np.array([ref[p] for p in positions.tolist()], dtype=np.uint8)
    big = BigMAT.from_tree(T, positions, refarr)
    samples = [random_sample(rng, ref, 5) for _ in range(4)]
    pos, gval, kmiss = big.sparsify(samples)
    cols = np.unique(pos[pos < big.P])
    C, C_pad = len(cols), 32
    lo, hi = big.csc_ptr[cols], big.csc_ptr[cols + 1]
    flat_idx = np.repeat(lo, hi - lo) + _ranges(hi - lo)
    m0 = np.zeros((big.N, C_pad), np.uint8)
    m0[big.csc_node[flat_idx], np.repeat(np.arange(C), hi - lo)] = np.where(
        big.csc_eff[flat_idx], big.csc_mut[flat_idx], 0)
    ref_cols = np.zeros(C_pad, np.uint8)
    ref_cols[:C] = big.ref[cols]
    col_of = np.full(big.P + 1, C_pad, np.int32)
    col_of[cols] = np.arange(C, dtype=np.int32)
    pos_cols = col_of[np.minimum(pos, big.P)]
    base = big.base_spr if spr else big.base
    want = pp.score_cols_T(m0, big.anc, big.parent, np.int32(big.root_slot),
                           ref_cols, base, big.nc_base, pos_cols, gval,
                           kmiss, pos.shape[1], big.n_anc, spr=spr)
    got = ps.score_cols_T(_t(m0), _t(big.anc), _t(big.parent),
                          big.root_slot, _t(ref_cols), _t(base),
                          _t(big.nc_base), _t(pos_cols), _t(gval),
                          _t(kmiss), spr=spr)
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))


def test_slot_words_layout():
    """The slot table decodes to the fields the kernels read: four slots a
    quad, one byte a slot in the allele, reference and flag words, padding
    slots without any bit, a missing entry in the sign bit of its word, and
    K = 5 padded to two quads."""
    P = 5
    ref = torch.tensor([1, 2, 4, 8, 8], dtype=torch.uint8)
    pos = torch.tensor([[0, 3, P, 4, 1], [2, P, P, P, P]], dtype=torch.int32)
    gval = torch.tensor([[2, 15, 9, 7, 3], [8, 0, 0, 0, 0]],
                        dtype=torch.uint8)
    kmiss = torch.tensor([[False, True, False, True, True],
                          [False, False, False, False, False]])
    table, qend = ps._slot_words(P, ref, pos, gval, kmiss)
    assert table.dtype == torch.int32 and table.shape == (2, 7, 2)
    # one past the last quad that holds an entry
    assert qend.dtype == torch.int32 and qend.tolist() == [2, 1]
    u = table.numpy().astype(np.int64) & 0xFFFFFFFF          # [Q, 7, B]
    kvalid = np.zeros((2, 8), bool)
    kvalid[:, :5] = (pos < P).numpy()
    pad8 = lambda x: np.pad(x.numpy().astype(np.int64), ((0, 0), (0, 3)))
    slot = lambda f: np.stack([(u[q, f, :] >> (8 * i)) & 0xFF
                               for q in range(2) for i in range(4)], 1)
    np.testing.assert_array_equal(
        u[:, :4, :].transpose(2, 0, 1).reshape(2, 8),
        np.where(kvalid, pad8(pos), 0))
    np.testing.assert_array_equal(slot(4), np.where(kvalid, pad8(gval), 0))
    want_ref = np.where(kvalid, ref.numpy()[np.minimum(pad8(pos), P - 1)], 0)
    np.testing.assert_array_equal(slot(5), want_ref)
    np.testing.assert_array_equal(slot(6) >> 7, kvalid & (pad8(kmiss) != 0))
    np.testing.assert_array_equal((slot(6) >> 6) & 1, kvalid)
    assert (slot(6) & 0x3F == 0).all()
    assert int(table[1, 6, 0]) == 0xC0 and int(table[0, 6, 0]) < 0
    hole = torch.tensor([[P, P, P, P, 1], [P, P, P, P, P]], dtype=torch.int32)
    assert ps._slot_words(P, ref, hole, gval, kmiss)[1].tolist() == [2, 0]


def _fold_persistent(score_t, nc_t, nnm, active, leaf, root, leaves, rank,
                     rows, grid):
    """numpy transcription of placement_partials_kernel's walk: block blk
    of `grid` folds the row groups blk, blk + grid, ... of `rows` rows into
    one partial per sample, carried across its groups; a block without a
    group writes the identity."""
    N, B = score_t.shape
    groups = -(-N // rows)
    out = np.zeros((4, grid, B), dtype=np.int32)
    for blk in range(grid):
        for b in range(B):
            best, cnt, q1, q2 = 1 << 30, 0, -1, -1
            for grp in range(blk, groups, grid):
                for n in range(grp * rows, min(N, (grp + 1) * rows)):
                    if not active[n]:
                        continue
                    s, c = score_t[n, b], nc_t[n, b]
                    hu = c < nnm[n]
                    valid = (root[n] or (leaf[n] and c > 0)
                             or (not leaf[n] and hu and c > 0)
                             or (not leaf[n] and not hu))
                    if not valid:
                        continue
                    r2 = rank[n] * 2 + int(hu)
                    if s < best:
                        best, cnt, q1, q2 = s, 1, leaves[n], r2
                    elif s == best:
                        cnt += 1
                        if leaves[n] > q1:
                            q1, q2 = leaves[n], r2
                        elif leaves[n] == q1 and r2 > q2:
                            q2 = r2
            out[:, blk, b] = (best, cnt, q1, q2)
    return out


@pytest.mark.parametrize("seed,rows,grid", [
    (21, 1, 1), (22, 3, 4), (23, 7, 50),      # one block; fewer than the
    (24, 4, 3), (25, 32, 132), (26, 5, 2)])   # groups; more than the groups
def test_partial_fold_and_merge_match_plain(seed, rows, grid):
    """B2's persistent per-block fold (emulated) plus the exact merge equals
    the plain whole-matrix reduction, over ragged row groups, inactive
    slots, and blocks without rows (their identity partial never wins)."""
    jflat, flat, samples = _case(seed, n_leaves=30, n_samples=8)
    st, parent = flat.sync()
    meta, m = _meta(flat)
    assert flat.cap > flat.n_slots           # inactive tail rows exist
    pos, gval, kmiss = (_t(x) for x in ps.sparsify(
        samples, flat.pos_index, flat.P_pad))
    stp = dev.parent_states(st, parent, flat.root_slot)
    base, nc_base, nnm = ps.row_reductions(st, stp, flat.ref_dev)
    score_t, nc_t = ps.score_entries_T_plain(st, stp, flat.ref_dev, base,
                                             nc_base, pos, gval, kmiss)
    groups = -(-flat.cap // rows)
    assert (grid > groups) == (seed in (23, 25))
    parts = torch.from_numpy(_fold_persistent(
        score_t.numpy(), nc_t.numpy(), nnm.numpy(), meta["active"],
        meta["is_leaf"], meta["is_root_mask"], meta["num_leaves"],
        meta["bfs_rank"], rows, grid))
    if grid > groups:
        assert parts[:, groups:, :].unique(dim=1).shape[1] == 1
        assert parts[:, -1, 0].tolist() == [1 << 30, 0, -1, -1]
    best, rank, num_best = ps.merge_partials(*parts)
    got = (best, ps.row_of_rank(rank, m[4], flat.cap), num_best)
    want = ps.placement_reduce_plain(st, stp, flat.ref_dev, base, nc_base,
                                     nnm, *m, pos, gval, kmiss)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


M32 = 0xFFFFFFFF


def _nz7(x):
    """Bit 7 of every non-zero byte of x (bytes <= 0x0F)."""
    return ((x + 0x7F7F7F7F) & M32) & 0x80808080


def _quad(v, g, r, fl, spr):
    """The kernels' corrections of the four triples of a quad at once, one
    per byte: v the packed bytes st | stp << 4 of a node at the quad's four
    columns, g / r / fl the quad's allele, reference and flag words."""
    popc = lambda x: bin(x).count("1")
    s_, sp = v & 0x0F0F0F0F, (v >> 4) & 0x0F0F0F0F
    holds = (fl << 1) & 0x80808080
    bm, matched, matched_r = _nz7(s_ ^ sp), _nz7(s_ & g), _nz7(s_ & r)
    term1 = ~(_nz7((s_ | sp) & g) | fl) & holds
    if spr:
        sub = ~_nz7((s_ | sp) & r) & holds
    else:
        pick_s = (matched_r >> 7) * 0xFF
        sub = _nz7(((s_ & pick_s) | (sp & ~pick_s & M32)) ^ r) & holds
    return (popc(term1) - popc(sub),
            popc(bm & matched) - popc(bm & matched_r))


def _entry_sums_lanes(packed_row, table, qend, lanes, spr):
    """numpy transcription of the kernels' entry_sums for one packed node
    row and one sample's slot table [Q, 7]: lane `sub` of `lanes` takes
    quads sub, sub + lanes, ... below qend; the lane sums are folded by the
    xor butterfly, after which every lane holds the whole sums."""
    cs = np.zeros(lanes, np.int64)
    ns = np.zeros(lanes, np.int64)
    for sub in range(lanes):
        for q in range(sub, qend, lanes):
            w = [int(x) & M32 for x in table[q]]
            v = sum(int(packed_row[w[i]]) << (8 * i) for i in range(4))
            c, n = _quad(v, w[4], w[5], w[6], spr)
            cs[sub] += c
            ns[sub] += n
    off = lanes >> 1
    while off:
        cs = cs + cs[np.arange(lanes) ^ off]
        ns = ns + ns[np.arange(lanes) ^ off]
        off >>= 1
    assert (cs == cs[0]).all() and (ns == ns[0]).all()
    return cs[0], ns[0]


@pytest.mark.parametrize("spr", [False, True])
def test_triple_algebra_exhaustive(spr):
    """Every (st, stp, gval, kmiss, ref) combination, zero nibbles included,
    in every byte lane of a quad beside other triples: the kernels'
    byte-parallel form of the corrections equals the plain twin's."""
    st = torch.arange(16, dtype=torch.uint8)[:, None].repeat(1, 16)
    stp = torch.arange(16, dtype=torch.uint8)[None, :].repeat(16, 1)
    zero = torch.zeros(16, dtype=torch.int32)
    # sample b = (gv, km) has one entry; row n = st value, column = stp
    gval = torch.arange(16, dtype=torch.uint8).repeat(2)[:, None]
    kmiss = (torch.arange(32) >= 16)[:, None]
    want = {}
    for rk in range(16):
        ref = torch.full((16,), rk, dtype=torch.uint8)
        for col in range(16):
            pos = torch.full((32, 1), col, dtype=torch.int32)
            c, n = ps.score_entries_T_plain(st, stp, ref, zero, zero, pos,
                                            gval, kmiss, spr=spr)
            for row in range(16):
                for b in range(32):
                    want[row | col << 4, b % 16, b // 16, rk] = (
                        int(c[row, b]), int(n[row, b]))
    keys = list(want)
    assert len(keys) == 256 * 16 * 2 * 16
    rng = np.random.default_rng(7)
    for i, key in enumerate(keys):
        # the triple under test in byte lane i % 4, three others beside it,
        # one of them a slot without an entry
        quad = [keys[j] for j in rng.integers(0, len(keys), size=4)]
        quad[i % 4] = key
        empty = (i + 1 + i // 4 % 3) % 4
        v = g = r = fl = 0
        c = n = 0
        for lane, (vv, gv, km, rk) in enumerate(quad):
            v |= vv << 8 * lane
            if lane == empty:
                continue
            g |= gv << 8 * lane
            r |= rk << 8 * lane
            fl |= (km << 7 | 1 << 6) << 8 * lane
            c += want[vv, gv, km, rk][0]
            n += want[vv, gv, km, rk][1]
        assert _quad(v, g, r, fl, spr) == (c, n), (quad, empty)


@pytest.mark.parametrize("lanes", [1, 2, 8, 32])
@pytest.mark.parametrize("spr", [False, True])
def test_k_slice_split_matches_serial_sums(lanes, spr):
    """The K slots of a sample, in quads of four, split over the lanes of a
    warp; K = 13 is no multiple of four or of the lanes, with padding slots
    in the middle and at the end: the folded sums equal the plain twin's
    serial sums on multi-base states."""
    rng = np.random.default_rng(90 + lanes)
    N, P, B, K = 6, 40, 5, 13
    st = rng.integers(1, 16, size=(N, P), dtype=np.uint8)
    stp = rng.integers(1, 16, size=(N, P), dtype=np.uint8)
    stp[rng.random((N, P)) < 0.5] = 0
    stp = np.where(stp == 0, st, stp)
    ref = NIBBLES[rng.integers(0, 4, size=P)]
    pos = rng.integers(0, P, size=(B, K)).astype(np.int32)
    pos[rng.random((B, K)) < 0.3] = P                  # padding anywhere
    pos[0] = P                                         # a sample of none
    gval = rng.integers(1, 16, size=(B, K), dtype=np.uint8)
    kmiss = rng.random((B, K)) < 0.2
    zero = torch.zeros(N, dtype=torch.int32)
    want = ps.score_entries_T_plain(_t(st), _t(stp), _t(ref), zero, zero,
                                    _t(pos), _t(gval), _t(kmiss), spr=spr)
    table, qend = ps._slot_words(P, _t(ref), _t(pos), _t(gval), _t(kmiss))
    assert table.shape == (4, 7, B)
    packed = st | (stp << 4)
    for n in range(N):
        for b in range(B):
            cs, ns = _entry_sums_lanes(packed[n], table[:, :, b].numpy(),
                                       int(qend[b]), lanes, spr)
            assert (cs, ns) == (int(want[0][n, b]), int(want[1][n, b]))


NIBBLES = np.array([1, 2, 4, 8], dtype=np.uint8)


def _sweep_rows(st, stp, ref):
    """numpy transcription of the kernels' byte-parallel row sweep: rows
    padded with zero columns to 16-byte words, four cells per uint32, bit 7
    of x + 0x7F7F7F7F marking the non-zero bytes.  Returns the packed rows
    and the (base, nc_base, node_num_mut) sums."""
    N, P = st.shape
    pitch = -(-P // 16) * 16

    def words(x):
        buf = np.zeros(x.shape[:-1] + (pitch,), np.uint8)
        buf[..., :P] = x
        return buf.view("<u4").astype(np.uint64)

    def nz(x):
        return ((x + 0x7F7F7F7F) & 0xFFFFFFFF) & 0x80808080

    def popc(x):
        return np.array([bin(int(v)).count("1") for v in x.ravel()],
                        np.int64).reshape(x.shape)

    a, p, r = words(st), words(stp), words(ref)[None, :]
    bm, m0, ds, dp = nz(a ^ p), nz(r & a), nz(a ^ r), nz(p ^ r)
    sel = bm & ~m0
    sums = (popc(ds ^ (sel & (ds ^ dp))).sum(1), popc(bm & m0).sum(1),
            popc(bm).sum(1))
    packed = (a | (p << 4)).astype("<u4").view(np.uint8).reshape(N, pitch)
    return packed[:, :P], sums


@pytest.mark.parametrize("ragged", [0, 1, 5, 15])
def test_byte_parallel_sweep_matches_row_reductions(ragged):
    """Every (st, stp, ref) nibble triple, 16 x 16 x 16, in rows whose
    width leaves `ragged` cells in the last 16-byte word: the word-wide
    compares give row_reductions' three sums and the packed row."""
    P = 512 - 16 + ragged if ragged else 512
    i = np.arange(4096)
    st = (i & 15).astype(np.uint8)
    stp = ((i >> 4) & 15).astype(np.uint8)
    ref_of = (i >> 8).astype(np.uint8)
    N = 16
    # row n holds the triples whose ref nibble is rotated by n, so every
    # triple meets every byte lane of a word
    cols = np.arange(P)
    st_rows = np.stack([st[(cols * 8 + n * 257) % 4096] for n in range(N)])
    stp_rows = np.stack([stp[(cols * 8 + n * 257) % 4096] for n in range(N)])
    seen = set()
    for shift in range(8):
        ref = ref_of[(cols * 8 + shift * 512) % 4096]
        s_r = np.roll(st_rows, shift, axis=1)
        p_r = np.roll(stp_rows, shift, axis=1)
        packed, sums = _sweep_rows(s_r, p_r, ref)
        want = ps.row_reductions(_t(s_r), _t(p_r), _t(ref))
        for g_, w_ in zip(sums, want):
            np.testing.assert_array_equal(g_, w_.numpy())
        np.testing.assert_array_equal(packed, s_r | (p_r << 4))
        seen |= set(zip(s_r.ravel().tolist(), p_r.ravel().tolist(),
                        np.broadcast_to(ref, s_r.shape).ravel().tolist()))
    if not ragged:
        assert len(seen) == 4096


@pytest.mark.parametrize("seed", [40, 41, 42])
def test_fused_calls_match_explicit_base_and_jax(seed):
    """base=None (the row sums taken inside the call) equals the calls with
    explicit row_reductions, and the JAX functions: score_sparse_stp_T,
    placement_partials, placement_reduce."""
    jflat, flat, samples = _case(seed, n_leaves=30, n_samples=6)
    st, parent = flat.sync()
    _, m = _meta(flat)
    stp = dev.parent_states(st, parent, flat.root_slot)
    ref = flat.ref_dev
    slots = tuple(_t(x) for x in ps.sparsify(samples, flat.pos_index,
                                             flat.P_pad))
    calls = ps.row_reductions.calls
    base, nc_base, nnm = ps.row_reductions(st, stp, ref)
    assert ps.row_reductions.calls == calls + 1
    fused = ps.score_sparse_stp_T(st, stp, ref, *slots)
    assert ps.row_reductions.calls == calls + 2     # CPU: the plain twin
    explicit = ps.score_entries_T(st, stp, ref, base, nc_base, *slots)
    for g_, w_ in zip(fused, (*explicit, nnm)):
        assert torch.equal(g_, w_)
    st_j, par_j = jflat.sync()
    pos, gval, kmiss = pp.sparsify(samples, jflat.pos_index, jflat.P_pad)
    want = pp.score_sparse_T(st_j, par_j, jflat.root_slot,
                             np.asarray(jflat.ref), pos, gval, kmiss,
                             pos.shape[1])
    for g_, w_ in zip(fused, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))

    parts = ps.placement_partials(st, stp, ref, None, None, None, *m, *slots)
    parts_x = ps.placement_partials(st, stp, ref, base, nc_base, nnm, *m,
                                    *slots)
    assert torch.equal(parts, parts_x)
    got = ps.placement_reduce(st, stp, ref, None, None, None, *m, *slots)
    for g_, w_ in zip(got, ps.placement_reduce(st, stp, ref, base, nc_base,
                                               nnm, *m, *slots)):
        assert torch.equal(g_, w_)
    jmeta = jflat.order_arrays()
    want = pp.placement_step_sparse(
        st_j, par_j, jflat.root_slot, np.asarray(jflat.ref),
        jmeta["active"], jmeta["is_leaf"], jmeta["is_root_mask"],
        jmeta["num_leaves"], jmeta["bfs_rank"], pos, gval, kmiss,
        pos.shape[1])
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    with pytest.raises(ValueError, match="together"):
        ps.placement_partials(st, stp, ref, base, None, nnm, *m, *slots)
    with pytest.raises(ValueError, match="fused call"):
        ps.score_entries_T(st, stp, ref, None, None, *slots)


@pytest.mark.parametrize("P,B,K,fused,b2,want", [
    # the main-path batch: three one-row stages, 8 lanes a sample (8 slots
    # a lane)
    (30080, 64, 64, True, False, (1, 3, 1, 8)),
    # the sort pre-pass: B2 keeps a sample in one thread
    (30080, 1024, 64, True, True, (1, 3, 1, 1)),
    # a mesh shard of the pre-pass: 128 samples, 8 lanes each
    (30080, 128, 64, True, True, (1, 3, 1, 8)),
    # headline: 32 rows a stage, one lane a sample
    (512, 1024, 16, True, False, (32, 3, 1, 1)),
    # the BigMAT column path, caller-given base: 384 items a stage
    (1440, 64, 32, False, False, (24, 3, 1, 2)),
    # tiny batches: a lane keeps 8 slots
    (512, 1, 8, True, False, (32, 3, 1, 1)),
    (512, 3, 64, True, True, (32, 3, 1, 8)),
    (512, 1, 2048, True, False, (32, 3, 1, 32)),
    # two rows fit a stage: no chunks of four
    (15008, 64, 64, True, False, (2, 3, 1, 8)),
    # a row pair takes half the block: two stages, then one
    (40000, 64, 64, True, False, (1, 2, 1, 8)),
    (70000, 64, 64, True, False, (1, 1, 1, 8)),
    (100000, 64, 64, False, False, (1, 1, 1, 8)),
])
def test_launch_plan(P, B, K, fused, b2, want):
    plan = ps.launch_plan(P, B, K, fused, per_sample_state=b2)
    assert tuple(plan[:4]) == want and plan.grid == ps.H100.sms
    pitch = -(-P // 16) * 16
    smem = (ps.H100.smem_header + (pitch if fused else 0)
            + plan.stages * plan.rows * 2 * pitch)
    assert smem <= ps.H100.smem_max
    assert plan.rows * 2 * pitch < 1 << 20      # one mbarrier phase
    if b2:
        assert ps.H100.threads // plan.lanes >= min(B, ps.H100.threads)


def test_launch_plan_thread_copies_and_limits():
    """P % 16 != 0 or unaligned bases: one stage that the threads fill; a
    row too wide for a block's shared memory raises."""
    for P, aligned in ((1001, True), (512, False)):
        plan = ps.launch_plan(P, 64, 64, True, aligned=aligned)
        assert (plan.vec, plan.stages) == (0, 1) and plan.rows == 32
    assert ps.launch_plan(30001, 64, 64, True).rows == 3
    with pytest.raises(ValueError, match="too wide"):
        ps.launch_plan(80000, 64, 64, True)
    assert ps.launch_plan(80000, 64, 64, False).stages == 1
    with pytest.raises(ValueError, match="too wide"):
        ps.launch_plan(120000, 64, 64, False)
    # more samples than threads: B2 takes them in tiles of one lane each
    assert ps.launch_plan(512, 5000, 8, True, per_sample_state=True).lanes == 1


@pytest.mark.parametrize("empty", ["samples", "rows"])
def test_fused_calls_on_empty_inputs(empty):
    """A fused call without samples still returns the rows' node_num_mut
    (a mesh shard with rows and no sample owes it), and B2 without rows the
    identity of the merge."""
    jflat, flat, samples = _case(43, n_leaves=12, n_samples=4)
    st, parent = flat.sync()
    _, m = _meta(flat)
    stp = dev.parent_states(st, parent, flat.root_slot)
    ref = flat.ref_dev
    pos, gval, kmiss = (_t(x) for x in ps.sparsify(samples, flat.pos_index,
                                                   flat.P_pad))
    N, B = st.shape[0], pos.shape[0]
    if empty == "samples":
        pos, gval, kmiss, B = pos[:0], gval[:0], kmiss[:0], 0
    else:
        st, stp, m, N = st[:0], stp[:0], tuple(x[:0] for x in m), 0
    score_t, nc_t, nnm = ps.score_sparse_stp_T(st, stp, ref, pos, gval, kmiss)
    assert score_t.shape == nc_t.shape == (N, B)
    assert torch.equal(nnm, ps.row_reductions(st, stp, ref)[2])
    parts = ps.placement_partials(st, stp, ref, None, None, None, *m, pos,
                                  gval, kmiss)
    assert parts.shape == (4, 1, B)
    best, rank, num_best = ps.merge_partials(*parts)
    assert best.tolist() == [dev.BIG] * B and num_best.tolist() == [0] * B
    assert rank.tolist() == [0] * B


def test_kernel_wrappers_never_fall_back(monkeypatch, tmp_path):
    """Off the CPU the wrappers launch a kernel or raise: tensors on another
    device raise, and without nvcc the kernel build raises instead of
    handing the work to the plain twin."""
    N, P, B, K = 4, 16, 2, 8
    kw = dict(device="meta")
    args = (torch.empty((N, P), dtype=torch.uint8, **kw),
            torch.empty((N, P), dtype=torch.uint8, **kw),
            torch.empty((P,), dtype=torch.uint8, **kw),
            torch.empty((N,), dtype=torch.int32, **kw),
            torch.empty((N,), dtype=torch.int32, **kw))
    slots = (torch.empty((B, K), dtype=torch.int32, **kw),
             torch.empty((B, K), dtype=torch.uint8, **kw),
             torch.empty((B, K), dtype=torch.bool, **kw))
    for spr in (False, True):
        with pytest.raises(ValueError, match="no B1 kernel"):
            ps.score_entries_T(*args, *slots, spr=spr)
        with pytest.raises(ValueError, match="no B1-3d kernel"):
            ps.score_entries_3d(*args, *slots, 4, spr=spr)
    node = tuple(torch.empty((N,), dtype=dt, **kw) for dt in (
        torch.int32, torch.bool, torch.bool, torch.bool, torch.int32,
        torch.int32))
    with pytest.raises(ValueError, match="no B2 kernel"):
        ps.placement_reduce(*args, *node, *slots)

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    _build.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.load_library()
    finally:
        _build.load_library.cache_clear()

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        apply_platform_env("cuda")
    assert apply_platform_env("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_dense_jax_reference_agrees():
    """The JAX dense path (the reference of both packages) sees the same
    winners as the port's sparse plain path on one larger case."""
    jflat, flat, samples = _case(31, n_leaves=40, n_samples=7)
    st_j, par_j = jflat.sync()
    jmeta = jflat.order_arrays()
    g, E, miss = jflat.encode_samples(samples)
    want = jdev.placement_step(
        st_j, par_j, jflat.root_slot, np.asarray(jflat.ref),
        jmeta["active"], jmeta["is_leaf"], jmeta["is_root_mask"],
        jmeta["num_leaves"], jmeta["bfs_rank"], g, E, miss)
    st, parent = flat.sync()
    _, m = _meta(flat)
    pos, gval, kmiss = ps.sparsify(samples, flat.pos_index, flat.P_pad)
    got = ps.placement_step_sparse(st, parent, flat.root_slot, flat.ref_dev,
                                   *m, _t(pos), _t(gval), _t(kmiss))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
