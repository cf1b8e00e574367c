"""usher_tpu_torch.ops.placement_sparse against the JAX Pallas path.

The plain twins of the B1/B1-spr/B2 kernels run on CPU tensors and must
equal usher_tpu.ops.placement_pallas (Pallas in interpret mode) bit for bit
on random MATs with ambiguous and missing entries, padding slots and
inactive slots, and so must the BigMAT column path score_cols_T.  The CUDA kernels themselves are compared with the plain twins on the
card by chip_smoke.py; here the kernels' host-side pieces (slot words, the
per-block fold and the exact partial merge) are checked against a numpy
emulation of the kernel loop.  Tolerance: none (integer arithmetic).
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
    """The packed slot word decodes to the fields the kernels read, with
    padding slots marked invalid and a ref nibble of 8 in the sign bit."""
    P = 5
    ref = torch.tensor([1, 2, 4, 8, 8], dtype=torch.uint8)
    pos = torch.tensor([[0, 3, 4, P], [2, P, P, P]], dtype=torch.int32)
    gval = torch.tensor([[2, 15, 9, 0], [8, 0, 0, 0]], dtype=torch.uint8)
    kmiss = torch.tensor([[False, True, False, False],
                          [False, False, False, False]])
    w = ps._slot_words(P, ref, pos, gval, kmiss)
    assert w.dtype == torch.int32 and w.shape == (4, 2)
    u = w.t().numpy().astype(np.int64) & 0xFFFFFFFF
    kvalid = (pos < P).numpy()
    np.testing.assert_array_equal(u & 0x3FFFFF,
                                  np.where(kvalid, pos.numpy(), 0))
    np.testing.assert_array_equal((u >> 22) & 0xF, gval.numpy())
    np.testing.assert_array_equal((u >> 26) & 1, kmiss.numpy())
    np.testing.assert_array_equal((u >> 27) & 1, kvalid)
    np.testing.assert_array_equal(
        u >> 28, np.where(kvalid, ref.numpy()[np.minimum(pos.numpy(), P - 1)],
                          ref.numpy()[0]))


def _fold_blocks(score_t, nc_t, nnm, active, leaf, root, leaves, rank, rows):
    """numpy transcription of placement_partials_kernel's per-block loop."""
    N, B = score_t.shape
    nb = -(-N // rows)
    out = np.zeros((4, nb, B), dtype=np.int32)
    for blk in range(nb):
        for b in range(B):
            best, cnt, q1, q2 = 1 << 30, 0, -1, -1
            for n in range(blk * rows, min(N, (blk + 1) * rows)):
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


@pytest.mark.parametrize("seed,rows", [(21, 1), (22, 3), (23, 7)])
def test_partial_fold_and_merge_match_plain(seed, rows):
    """B2's per-block fold (emulated) plus the exact merge equals the plain
    whole-matrix reduction, over ragged node blocks and inactive slots."""
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
    parts = torch.from_numpy(_fold_blocks(
        score_t.numpy(), nc_t.numpy(), nnm.numpy(), meta["active"],
        meta["is_leaf"], meta["is_root_mask"], meta["num_leaves"],
        meta["bfs_rank"], rows))
    best, rank, num_best = ps.merge_partials(*parts)
    got = (best, ps.row_of_rank(rank, m[4], flat.cap), num_best)
    want = ps.placement_reduce_plain(st, stp, flat.ref_dev, base, nc_base,
                                     nnm, *m, pos, gval, kmiss)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


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
