"""usher_tpu_torch.ops.interval against usher_tpu.ops.interval.

The DFS-interval engine's torch ops (X4 cumsum, X8 interval_scores /
interval_place, X5 interval_place_dev, with the runner-up and the tie-set
clade histogram) must equal the JAX functions bit for bit on the same numpy
inputs: random event streams with the dump row and forced ties, and the CSC
index of BigMATs built from random trees, with tombstoned rows and overlay
events.  Tolerance: none (integer arithmetic).
"""

import numpy as np
import pytest
import torch

from usher_tpu.core.bigmat import BigMAT as JBigMAT
from usher_tpu.ops import interval as jiv
from usher_tpu_torch.ops import interval as iv

from test_placement import random_mat, random_sample
from test_torch_hostlayers import port_tree


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _events(rng, n, n_pad, b_pad, lo=-4, hi=4):
    """n events on rows 0..n_pad (n_pad is the dump row)."""
    return (rng.integers(0, n_pad + 1, n).astype(np.int32),
            rng.integers(0, b_pad, n).astype(np.int32),
            rng.integers(lo, hi + 1, n).astype(np.int32))


def _node_meta(rng, n_pad):
    """Per-row metadata with small value ranges, so that scores, leaf
    counts and validity tie often; inactive rows carry bfs_rank -1."""
    active = rng.random(n_pad) < 0.9
    is_root = np.zeros(n_pad, bool)
    is_root[int(rng.integers(n_pad))] = True
    rank = rng.permutation(n_pad).astype(np.int32)
    return dict(
        num_mut=rng.integers(0, 3, n_pad).astype(np.int32),
        is_leaf=rng.random(n_pad) < 0.5,
        is_root=is_root,
        active=active,
        num_leaves=rng.integers(0, 3, n_pad).astype(np.int32),
        bfs_rank=np.where(active, rank, -1).astype(np.int32))


_META = ("num_mut", "is_leaf", "is_root", "active", "num_leaves", "bfs_rank")


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("seed,rows", [(0, 300), (1, 2 * iv.SCAN_BLOCK),
                                       (2, 3 * iv.SCAN_BLOCK + 77)])
def test_scan_rows_is_int32_cumsum(seed, rows):
    """One pass below two blocks; the two-level blocked scan at exactly
    two blocks and with a ragged tail."""
    rng = np.random.default_rng(seed)
    d = rng.integers(-4, 5, size=(rows, 5)).astype(np.int32)
    got = iv._scan_rows(_t(d))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jiv._scan_rows(d)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interval_scores_matches_jax(seed):
    """Random event streams, including events on the dump row and on
    repeated (row, sample) pairs; n_pad off the JAX scan's 256 blocks."""
    rng = np.random.default_rng(seed)
    n_pad, b_pad = 300, 8
    ev = _events(rng, 600, n_pad, b_pad)
    nc = _events(rng, 200, n_pad, b_pad, -1, 1)
    base = rng.integers(0, 30, n_pad).astype(np.int32)
    nc_base = rng.integers(0, 3, n_pad).astype(np.int32)
    add0 = rng.integers(-3, 4, b_pad).astype(np.int32)
    args = (*ev, *nc, base, nc_base, add0)
    want = jiv.interval_scores(*args, n_pad=n_pad, b_pad=b_pad)
    got = iv.interval_scores(*(_t(a) for a in args), n_pad, b_pad)
    _assert_equal(got, want)


@pytest.mark.parametrize("seed,second,with_clades",
                         [(0, False, False), (1, True, False),
                          (2, True, True), (3, False, True)])
def test_interval_place_matches_jax(seed, second, with_clades):
    """X8 placement: validity, the tie-broken argmin under forced ties
    (small score and leaf-count ranges), the runner-up and the clade
    histogram."""
    rng = np.random.default_rng(seed)
    n_pad, b_pad = 200, 8
    ev = _events(rng, 300, n_pad, b_pad, -1, 1)
    nc = _events(rng, 150, n_pad, b_pad, -1, 1)
    base = rng.integers(0, 3, n_pad).astype(np.int32)
    nc_base = rng.integers(0, 3, n_pad).astype(np.int32)
    add0 = rng.integers(0, 2, b_pad).astype(np.int32)
    m = _node_meta(rng, n_pad)
    args = (*ev, *nc, base, nc_base, add0, *(m[k] for k in _META))
    ckw = {}
    if with_clades:
        ckw = dict(clade_self_dfs=rng.integers(0, 4, (2, n_pad)).astype(
                       np.int32),
                   clade_par_dfs=rng.integers(0, 4, (2, n_pad)).astype(
                       np.int32),
                   n_clades=4)
    want = jiv.interval_place(*args, n_pad=n_pad, b_pad=b_pad, second=second,
                              **ckw)
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v)
           for k, v in ckw.items()}
    got = iv.interval_place(*(_t(a) for a in args), n_pad, b_pad,
                            second=second, **tkw)
    _assert_equal(got, want)
    assert got[1].dtype == torch.int32 and got[3].dtype == torch.bool


def _dev_inputs(seed, n_leaves, n_positions, n_samples):
    """Numpy inputs of interval_place_dev from a JAX BigMAT: the CSC index
    with a few tombstoned rows, DFS-ordered metadata, sparsified samples
    and a small overlay event stream."""
    rng = np.random.default_rng(seed)
    T, ref = random_mat(rng, n_leaves=n_leaves, n_positions=n_positions)
    positions = np.array(sorted(ref), dtype=np.int64)
    refarr = np.array([ref[p] for p in positions.tolist()], dtype=np.uint8)
    big = JBigMAT.from_tree(T, positions, refarr)
    samples = [random_sample(rng, ref) for _ in range(n_samples)]
    pos, gval, kmiss = big.sparsify(samples)
    N, B = big.N, pos.shape[0]
    eff = big.csc_mut != big.csc_par
    dead = rng.random(len(big.csc_node)) < 0.1
    meta32 = (big.csc_mut.astype(np.int32)
              | (big.csc_par.astype(np.int32) << 4)
              | (big.csc_root.astype(np.int32) << 8)
              | (eff.astype(np.int32) << 9)
              | (dead.astype(np.int32) << 10))
    o = big.dfs_order
    csc = (big.csc_ptr.astype(np.int32), big.csc_node, meta32,
           big.dfs_of, big.dfs_end_of, big.ref)
    ov = _events(rng, 20, N, B, -1, 1)
    ovn = _events(rng, 10, N, B, -1, 1)
    dfs_meta = (big.base[o], big.nc_base[o], big.node_num_mut[o],
                big.is_leaf[o], big.is_root_mask[o], big.active[o],
                big.num_leaves[o], big.bfs_rank[o])
    e = pos < big.P
    mc = int((big.csc_ptr[pos[e] + 1] - big.csc_ptr[pos[e]]).max())
    clades = (rng.integers(0, 5, (2, N)).astype(np.int32),
              rng.integers(0, 5, (2, N)).astype(np.int32), 5)
    return (csc, (pos.astype(np.int32), gval, kmiss), ov, ovn, dfs_meta,
            N, B, mc, clades)


@pytest.mark.parametrize("seed,spr,second", [(40, False, True),
                                             (41, True, False),
                                             (42, False, False)])
def test_interval_place_dev_matches_jax(seed, spr, second):
    """X5 on the CSC index of a random BigMAT: the device expansion with
    tombstones and overlay events, in both scoring modes, with the
    runner-up and (placement mode) the clade histogram."""
    (csc, ent, ov, ovn, dfs_meta, N, B, mc,
     clades) = _dev_inputs(seed, n_leaves=60, n_positions=25, n_samples=7)
    args = (*csc, *ent, *ov, *ovn, *dfs_meta)
    ckw = {}
    if not spr:
        ckw = dict(clade_self_dfs=clades[0], clade_par_dfs=clades[1],
                   n_clades=clades[2])
    want = jiv.interval_place_dev(*args, n_pad=N, b_pad=B, mc=mc, spr=spr,
                                  second=second, **ckw)
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v)
           for k, v in ckw.items()}
    got = iv.interval_place_dev(*(_t(a) for a in args), N, B, mc, spr=spr,
                                second=second, **tkw)
    _assert_equal(got, want)


def test_dev_scores_equal_host_expansion():
    """The device expansion (X5's score core) equals the host-expanded
    event streams of core/bigmat.py _events scored by X8, row for row."""
    from usher_tpu_torch.core.bigmat import BigMAT
    rng = np.random.default_rng(7)
    T, ref = random_mat(rng, n_leaves=50, n_positions=20)
    positions = np.array(sorted(ref), dtype=np.int64)
    refarr = np.array([ref[p] for p in positions.tolist()], dtype=np.uint8)
    big = BigMAT.from_tree(port_tree(T), positions, refarr, device="cpu")
    samples = [random_sample(rng, ref) for _ in range(5)]
    pos, gval, kmiss = big.sparsify(samples)
    N, B = big.N, pos.shape[0]
    for spr in (False, True):
        meta = big._dfs_meta(spr)
        *ev, add0 = big._events(pos, gval, kmiss, spr)
        host = iv.interval_scores(
            *(_t(a) for a in iv.pad_events(*ev[:3], N)),
            *(_t(a) for a in iv.pad_events(*ev[3:6], N)),
            meta["base"], meta["nc_base"], _t(add0.astype(np.int32)), N, B)
        e = pos < big.P
        mc = int((big.csc_ptr[pos[e] + 1] - big.csc_ptr[pos[e]]).max())
        z = torch.zeros(0, dtype=torch.int32)
        dev = iv._dev_score_nc(*big._csc_dev(), _t(pos.astype(np.int32)),
                               _t(gval), _t(kmiss), z, z, z, z, z, z,
                               meta["base"], meta["nc_base"], N, B, mc, spr)
        _assert_equal(dev, [h.numpy() for h in host])


def test_pad_events_checks_rows():
    idx, b, val = iv.pad_events([0, 5, 6], [1, 2, 0], [1, -1, 2], 6)
    assert idx.dtype == b.dtype == val.dtype == np.int32
    assert len(idx) == 3
    with pytest.raises(IndexError):
        iv.pad_events([7], [0], [1], 6)
