"""The port's CSR SPR search (usher_tpu_torch/optimize/spr_big.py over X7,
usher_tpu_torch/ops/interval.py) against the JAX package's and against the
dense MoveFinder, on the CPU.

Every path of BigMoveFinder (device expansion, host events past the
expansion budget, the batch mesh through `_spr_sharded_fn`) gives the dense
finder's moves and JAX's; X7's two entry points are called on the same
inputs as JAX's; the numpy oracle `_reduce` agrees with the device
reduction; and the streamed optimizer maintains its array-form mutation set
exactly (USHER_TPU_CHECK_CSR).  Exact: integer parsimony.
"""

import numpy as np
import pytest

from usher_tpu.core.flat import collect_positions as jcollect
from usher_tpu.io.newick import write_newick as jnwk
from usher_tpu.optimize.spr_big import BigMoveFinder as JBig
from usher_tpu_torch.io.newick import write_newick as tnwk
from usher_tpu_torch.optimize import spr_big
from usher_tpu_torch.optimize.spr_big import BigMoveFinder as TBig

from test_torch_fitch import random_opt_tree
from test_torch_hostlayers import port_tree
from test_torch_spr import finders, signature


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("USHER_TPU_PLATFORM", "cpu")


def big_finders(seed, n=70, chunk=32, mesh=None):
    """(JAX dense finder, JAX BigMoveFinder, port dense, port Big) on one
    rewritten random tree."""
    jf, tf = finders(random_opt_tree(seed, n=n), chunk=chunk)
    positions, _, _ = jcollect(jf.T)
    jb = JBig(jf.T, None, jf.masks, jf.ref_row, jf.bfs, jf.parent,
              chunk=chunk, positions=positions)
    tb = TBig(tf.T, None, tf.masks, tf.ref_row, tf.bfs, tf.parent,
              chunk=chunk, positions=positions, mesh=mesh,
              device=None if mesh is not None else "cpu")
    return jf, jb, tf, tb


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_big_move_finder_matches_dense_and_jax(seed):
    """Mirror of test_big_move_finder_matches_dense, plus JAX's lists."""
    jf, jb, tf, tb = big_finders(seed)
    for radius in (2, 4, 1000):
        want = signature(jf.find_moves(radius))
        assert signature(tf.find_moves(radius)) == want
        assert signature(tb.find_moves(radius)) == want
        assert signature(jb.find_moves(radius)) == want
    assert tb.paths["device"] > 0 and tb.paths["host"] == 0


def test_host_events_path_equals_device(monkeypatch):
    """Past the expansion budget a chunk takes host events (X7's
    interval_spr): the same moves, counted as such."""
    jf, jb, tf, tb = big_finders(3, n=90, chunk=16)
    want = signature(tb.find_moves(3))
    monkeypatch.setattr(spr_big, "EXPANSION_BUDGET", 0)
    tb.paths = dict.fromkeys(tb.paths, 0)
    assert signature(tb.find_moves(3)) == want
    assert tb.paths["device"] == 0 and tb.paths["host"] == 6
    monkeypatch.setattr(spr_big, "EXPANSION_BUDGET", 1 << 25)
    monkeypatch.setattr(spr_big, "DEV_MAX_OCCUPANCY", 1)
    assert signature(tb.find_moves(3)) == want
    assert tb.paths["host"] == 12
    assert want == signature(jf.find_moves(3))


def test_sharded_spr_search_matches():
    """BigMoveFinder over a batch mesh of 8 CPU shards (`_spr_sharded_fn`,
    host events split by `shard_events`): the unsharded and JAX moves."""
    from usher_tpu_torch.parallel.shard import batch_mesh
    jf, jb, tf, tb8 = big_finders(4, n=100, chunk=3,
                                  mesh=batch_mesh(8, device="cpu"))
    assert tb8.chunk == 24
    for radius in (2, 1000):
        want = signature(jf.find_moves(radius))
        assert signature(tb8.find_moves(radius)) == want
    assert tb8.paths["mesh"] == 2 * -(-(tf.n - 1) // 24)
    assert tb8.paths["device"] == tb8.paths["host"] == 0


def _x7_inputs(tb, idxs, radius):
    """The host arrays of one X7 chunk, built as find_moves builds them."""
    big = tb.big
    B = len(idxs)
    devs = [tb._dev_of(si) for si in idxs]
    K = max(1, max(len(c) for c, _ in devs))
    pos = np.full((B, K), big.P, np.int32)
    gval = np.zeros((B, K), np.uint8)
    anc = []
    src = np.zeros((4, B), np.int32)
    for b, si in enumerate(idxs):
        pos[b, :len(devs[b][0])] = devs[b][0]
        gval[b, :len(devs[b][0])] = devs[b][1]
        p = int(tb.parent[si])
        while True:
            anc.append((big.dfs_of[p], big.dfs_end_of[p], b))
            if p == 0:
                break
            p = int(tb.parent[p])
        src[:, b] = (big.level[si], big.dfs_of[si], big.dfs_end_of[si],
                     big.dfs_of[int(tb.parent[si])])
    ar = np.asarray(anc, np.int32)
    cnt = (np.r_[ar[:, 0], ar[:, 1]], np.r_[ar[:, 2], ar[:, 2]],
           np.r_[np.ones(len(ar)), -np.ones(len(ar))].astype(np.int32))
    return pos, gval, cnt, src


@pytest.mark.parametrize("radius", [2, 5])
def test_x7_entry_points_match_jax(radius):
    """interval_spr (host events) and interval_spr_dev (device expansion)
    on the same inputs as JAX's: the same cost and, in DFS rows of each
    side's layout mapped back to slots, the same winner."""
    import jax.numpy as jnp
    from usher_tpu.ops import interval as jiv
    from usher_tpu_torch.ops import interval as tiv
    jf, jb, tf, tb = big_finders(5, n=80)
    idxs = list(range(1, 40))
    pos, gval, cnt, src = _x7_inputs(tb, idxs, radius)
    B = len(idxs)
    tbig, jbig = tb.big, jb.big
    assert np.array_equal(tbig.dfs_of, jbig.dfs_of[:tbig.N])
    meta = tbig._dfs_meta(spr=True)
    t = tbig._t
    margs = [meta[k] for k in ("num_mut", "is_root", "active",
                               "num_leaves", "bfs_rank", "level")]
    srcs = [t(a) for a in src]
    mc = int(np.diff(tbig.csc_ptr).max())
    got_dev = tiv.interval_spr_dev(
        *tbig._csc_dev(), t(pos), t(gval), *(t(a) for a in cnt),
        meta["base"], meta["nc_base"], *margs, *srcs, radius, tbig.N, B, mc)
    *ev, add0 = tbig._events(pos, gval, np.zeros(pos.shape, bool), spr=True)
    got_host = tiv.interval_spr(
        *(t(a) for a in tiv.pad_events(*ev[:3], tbig.N)),
        *(t(a) for a in tiv.pad_events(*ev[3:6], tbig.N)),
        *(t(a) for a in cnt), meta["base"], meta["nc_base"],
        t(add0.astype(np.int32)), *margs, *srcs, radius, tbig.N, B)
    jmeta = jbig._dfs_meta(spr=True)
    jn = jbig.n_pad
    jsrc = src.copy()
    jcnt = jiv.pad_events(*cnt, jn, bucket=1024)
    jcnt[0][jcnt[0] == tbig.N] = jn       # the dump row of JAX's layout
    jev, jnc = (jiv.pad_events(*ev[:3], jn), jiv.pad_events(*ev[3:6], jn))
    jev[0][jev[0] == tbig.N] = jn
    want = jiv.interval_spr(
        *(jnp.asarray(a) for a in jev), *(jnp.asarray(a) for a in jnc),
        *(jnp.asarray(a) for a in jcnt), jmeta["base"], jmeta["nc_base"],
        jnp.asarray(add0.astype(np.int32)),
        *(jmeta[k] for k in ("num_mut", "is_root", "active", "num_leaves",
                             "bfs_rank", "level")),
        *(jnp.asarray(a) for a in jsrc), jnp.int32(radius), jn, B)
    want = [np.asarray(w) for w in want]
    for got in (got_dev, got_host):
        got = [g.numpy() for g in got]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(tbig.dfs_order[got[1]],
                                      jbig.dfs_order[want[1]])


def test_reduce_oracle_matches_device():
    """The numpy mirror `_reduce` over the interval engine's score
    matrices gives the device reduction's (cost, slot, has_unique)."""
    jf, jb, tf, tb = big_finders(6, n=70)
    idxs = list(range(1, tb.n))
    pos, gval, _, _ = _x7_inputs(tb, idxs, 3)
    s_T, nc_T, nnm = tb.big.score_spr_T(pos, gval)
    best, slot, hu = tb._reduce(idxs, s_T.T, nc_T.T, nnm, 3)
    moves = {m.src.identifier: m for m in tb.find_moves(3, sources=idxs)}
    for b, si in enumerate(idxs):
        old = len(tb.bfs[si].mutations) + spr_big.collapse_bonus(tb.bfs[si])
        if old - int(best[b]) > 0 and best[b] < (1 << 29):
            mv = moves[tb.bfs[si].identifier]
            assert mv.dst is tb.bfs[int(slot[b])]
            assert mv.improvement == old - int(best[b])
            assert mv.sibling_split == (bool(hu[b])
                                        or mv.dst.is_leaf())
        else:
            assert tb.bfs[si].identifier not in moves


def test_streamed_patch_maintains_csr(monkeypatch):
    """Mirror of test_optimize's: streamed incremental-patch iterations
    keep the array-form mutation set equal to a from-scratch build on
    every finder (USHER_TPU_CHECK_CSR), and end on the dense driver's tree
    and on JAX's."""
    from usher_tpu.optimize import OptimizeOptions as JOpts
    from usher_tpu.optimize import optimize_tree as joptimize
    from usher_tpu_torch.optimize import OptimizeOptions, optimize_tree
    monkeypatch.setenv("USHER_TPU_CHECK_CSR", "1")
    T = random_opt_tree(9, n=120, hi=140, max_muts=3)
    P, P2 = port_tree(T), port_tree(T)
    sc = optimize_tree(P, OptimizeOptions(
        radius=3, max_iterations=6, reduce_back_mutations=False,
        stream_states=True), "cpu")
    sc_dense = optimize_tree(P2, OptimizeOptions(
        radius=3, max_iterations=6, reduce_back_mutations=False), "cpu")
    jsc = joptimize(T, JOpts(radius=3, max_iterations=6,
                             reduce_back_mutations=False, stream_states=True))
    assert sc == sc_dense == jsc
    nwk = tnwk(P, print_internal=True, print_branch_len=True)
    assert nwk == tnwk(P2, print_internal=True, print_branch_len=True)
    assert nwk == jnwk(T, print_internal=True, print_branch_len=True)


def test_shard_events_splits_by_owner():
    from usher_tpu_torch.ops import interval as tiv
    idx = np.array([3, 1, 4, 1, 5, 9, 2, 6])
    b = np.array([0, 5, 2, 7, 1, 6, 3, 4])
    val = np.arange(8)
    runs = tiv.shard_events((idx, b, val), 3, 3, 10)
    # owners 0 1 0 2 0 2 1 1, each run in its original order
    assert [r[1].tolist() for r in runs] == [[0, 2, 1], [2, 0, 1], [1, 0]]
    assert [r[0].tolist() for r in runs] == [[3, 4, 5], [1, 2, 6], [1, 9]]
    assert [r[2].tolist() for r in runs] == [[0, 2, 4], [1, 6, 7], [3, 5]]
    assert all(a.dtype == np.int32 for r in runs for a in r)
    with pytest.raises(IndexError):
        tiv.shard_events((idx, b, val), 3, 3, 8)
