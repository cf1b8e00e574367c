"""usher_tpu_torch.core.bigmat and placement.big_engine against the JAX
package's BigMAT and BigPlacementEngine.

Same trees, same numpy inputs, exact equality (integer arithmetic, tolerance
0): the epoch arrays of from_tree, every scoring path (interval engine X8,
device expansion X5, the column path on B1-spr's plain twin), placement
with the runner-up and the clade histogram, incremental appends followed by
scoring, and the engine placing a stream of samples.  The JAX column path
runs its Pallas kernel in interpret mode.
"""

import numpy as np
import pytest

from usher_tpu.core.bigmat import BigMAT as JBigMAT
from usher_tpu.io.newick import write_newick
from usher_tpu.placement.big_engine import BigPlacementEngine as JEngine
from usher_tpu.placement.mapper import score_placement
from usher_tpu_torch.io.newick import write_newick as port_write_newick
from usher_tpu_torch.placement.mapper import score_placement as \
    port_score_placement
from usher_tpu_torch.core import bigmat as bm
from usher_tpu_torch.core.bigmat import BigMAT
from usher_tpu_torch.placement.big_engine import BigPlacementEngine

from test_bigmat_flush import NIBBLES, random_big
from test_placement import random_mat, random_sample
from test_torch_hostlayers import port_samples, port_tree


def _pair(seed, n_leaves=40, n_positions=20, n_samples=6):
    rng = np.random.default_rng(seed)
    T, ref = random_mat(rng, n_leaves=n_leaves, n_positions=n_positions)
    positions = np.array(sorted(ref), dtype=np.int64)
    refarr = np.array([ref[p] for p in positions.tolist()], dtype=np.uint8)
    samples = [random_sample(rng, ref) for _ in range(n_samples)]
    return (JBigMAT.from_tree(T, positions, refarr),
            BigMAT.from_tree(port_tree(T), positions, refarr, device="cpu"),
            samples, rng)


def _eq(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _spr_gval(rng, pos, gval, P):
    """Ambiguous SPR masks (any nonzero nibble) at the non-padding slots."""
    gv = gval.copy()
    nonpad = pos < P
    gv[nonpad] = rng.integers(1, 16, size=int(nonpad.sum()), dtype=np.uint8)
    return gv


EPOCH = ("parent", "level", "anc", "base", "nc_base", "node_num_mut", "F",
         "base_spr", "num_leaves", "is_leaf", "is_root_mask", "bfs_rank",
         "dfs_of", "dfs_end_of", "dfs_order", "child_key", "child_count",
         "csc_ptr", "csc_node", "csc_mut", "csc_par", "csc_eff", "csc_root")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_epoch_arrays_match_jax(seed):
    jb, tb, _, _ = _pair(seed, n_leaves=60)
    assert (tb.N, tb.P, tb.n_anc, tb.root_slot) == \
        (jb.N, jb.P, jb.n_anc, jb.root_slot)
    for name in EPOCH:
        a, b = getattr(tb, name), getattr(jb, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("seed", [10, 11])
@pytest.mark.parametrize("max_cols", [8, 2048])
def test_scoring_paths_match_jax(seed, max_cols):
    """score_batch_T / score_spr_T (X8) and score_batch_T_cols /
    score_spr_T_cols (B1-spr's plain twin, chunked at max_cols) equal the
    JAX package's and each other."""
    jb, tb, samples, rng = _pair(seed)
    pos, gval, kmiss = tb.sparsify(samples)
    want = jb.score_batch_T(pos, gval, kmiss)
    _eq(tb.score_batch_T(pos, gval, kmiss), want)
    _eq(tb.score_batch_T_cols(pos, gval, kmiss, max_cols=max_cols), want)
    _eq(jb.score_batch_T_cols(pos, gval, kmiss, max_cols=max_cols), want)

    gv2 = _spr_gval(rng, pos, gval, tb.P)
    want = jb.score_spr_T(pos, gv2)
    _eq(tb.score_spr_T(pos, gv2), want)
    _eq(tb.score_spr_T_cols(pos, gv2, max_cols=max_cols), want)
    _eq(jb.score_spr_T_cols(pos, gv2, max_cols=max_cols), want)


@pytest.mark.parametrize("seed", [20, 21, 22])
def test_place_arrays_match_jax(seed, monkeypatch):
    """place_batch, place_arrays (runner-up, clade histogram, duplicated
    samples) and place_one_host equal JAX's; the host-expansion branch
    (X8) equals the device expansion (X5)."""
    jb, tb, samples, rng = _pair(seed, n_leaves=50, n_samples=7)
    samples = samples + [samples[0], []]          # a duplicate, an empty one
    _eq(tb.place_batch(samples), jb.place_batch(samples))
    pos, gval, kmiss = tb.sparsify(samples)
    want2 = jb.place_arrays(pos, gval, kmiss, with_second=True)
    got2 = tb.place_arrays(pos, gval, kmiss, with_second=True)
    for g, w in zip(got2, want2):
        _eq(g, w)
    clades = (rng.integers(0, 4, (2, tb.N)).astype(np.int32),
              rng.integers(0, 4, (2, tb.N)).astype(np.int32), 4)
    _eq(tb.place_arrays(pos, gval, kmiss, clades=clades),
        jb.place_arrays(pos, gval, kmiss, clades=clades))
    for b in range(3):
        sl = slice(b, b + 1)
        got = tb.place_one_host(pos[sl], gval[sl], kmiss[sl], full=True)
        want = jb.place_one_host(pos[sl], gval[sl], kmiss[sl], full=True)
        assert got[:4] == want[:4]
        _eq(got[4:], want[4:])
        assert got[:3] == tuple(int(x[b]) for x in want2[0][:3])
    monkeypatch.setattr(bm, "DEV_MAX_OCCUPANCY", 0)
    got_host = tb.place_arrays(pos, gval, kmiss, with_second=True)
    for g, w in zip(got_host, want2):
        _eq(g, w)


def _queue_stream(big, rng, n_ops=14):
    """A stream of child inserts and sibling splits.  A split moves some of
    u's own mutations to the new internal node (tombstoning them) and gives
    the new leaf fresh ones; one split targets a node queued earlier in the
    same stream (_apply)."""
    internals = np.nonzero(~big.is_leaf)[0]
    split_targets = rng.permutation(np.arange(1, big.N))
    ops = []
    for i in range(n_ops):
        kind = "split" if i % 3 == 1 else "child"
        u = int(rng.choice(internals)) if kind == "child" else \
            int(split_targets[i])
        col = int(rng.integers(0, big.P))
        pv = int(big.ref[col])
        mv = int(NIBBLES[(np.searchsorted(NIBBLES, pv) + 1) % 4])
        fresh = [(col, pv, mv)] if rng.random() < 0.7 else []
        if kind == "child":
            ops.append(("child", u, fresh))
        else:
            lo, hi = int(big.mut_ptr[u]), int(big.mut_ptr[u + 1])
            common = [(int(big.mut_col[j]), int(big.mut_par[j]),
                       int(big.mut_mut[j])) for j in range(lo, hi)][:1]
            ops.append(("split", u, common, fresh))
    return ops


def _apply(big, ops):
    last_child = None
    for op in ops:
        if op[0] == "child":
            last_child = big.queue_child_insert(op[1], op[2])
        else:
            big.queue_sibling_split(op[1], op[2], op[3])
    # a split of a leaf queued in this same stream
    big.queue_sibling_split(last_child, [], [])


@pytest.mark.parametrize("seed", [30, 31])
def test_append_stream_then_scoring_matches_jax(seed):
    """queue_child_insert / queue_sibling_split + flush (after the device
    CSC is resident, so tombstones go through the in-place dead-bit sync),
    then every scoring path equals JAX after the same sequence; the column
    path refuses to run on the stale ancestor tables."""
    rng = np.random.default_rng(seed)
    jb, tb = (random_big(np.random.default_rng(seed), N=300, P=48)
              for _ in range(2))
    tb = BigMAT(tb.parent, tb.mut_ptr, tb.mut_col, tb.mut_par, tb.mut_mut,
                tb.positions, tb.ref, device="cpu")
    B, K = 6, 5
    pos = rng.integers(0, tb.P + 3, size=(B, K)).astype(np.int32)
    gval = NIBBLES[rng.integers(0, 4, size=(B, K))]
    kmiss = rng.random((B, K)) < 0.1
    _eq(tb.place_arrays(pos, gval, kmiss), jb.place_arrays(pos, gval, kmiss))

    ops = _queue_stream(tb, rng)
    _apply(tb, ops)
    _apply(jb, ops)
    tb._flush()
    jb._flush()
    for name in ("parent", "level", "base", "nc_base", "node_num_mut", "F",
                 "num_leaves", "is_leaf", "dfs_of", "dfs_end_of",
                 "dfs_order", "child_key", "base_spr", "bfs_rank"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name),
                                      err_msg=name)
    np.testing.assert_array_equal(tb.csc_dead, jb.csc_dead)
    for a, b in zip(tb._ov, jb._ov):
        np.testing.assert_array_equal(a, b)

    _eq(tb.score_batch_T(pos, gval, kmiss), jb.score_batch_T(pos, gval, kmiss))
    gv2 = _spr_gval(rng, pos, gval, tb.P)
    _eq(tb.score_spr_T(pos, gv2), jb.score_spr_T(pos, gv2))
    for g, w in zip(tb.place_arrays(pos, gval, kmiss, with_second=True),
                    jb.place_arrays(pos, gval, kmiss, with_second=True)):
        _eq(g, w)
    # the resident meta32 got the new tombstones through the in-place sync
    np.testing.assert_array_equal(
        (tb._csc_meta_dev.numpy() >> 10) & 1, tb.csc_dead.astype(np.int32))
    assert (tb.place_one_host(pos[:1], gval[:1], kmiss[:1])
            == jb.place_one_host(pos[:1], gval[:1], kmiss[:1]))
    with pytest.raises(RuntimeError, match="after incremental appends"):
        tb.score_batch_T_cols(pos, gval, kmiss)


@pytest.mark.parametrize("seed", [41, 42])
def test_big_engine_stream_matches_jax(seed):
    """BigPlacementEngine places a stream of samples exactly as the JAX
    engine does (same SampleResults, same surgery), with one from_tree
    build and O(delta) appends after it, and the maintained arrays equal a
    fresh build of the evolved tree."""
    rng = np.random.default_rng(seed)
    T, ref = random_mat(rng, n_leaves=40, n_positions=25)
    samples = [(f"S{i}", random_sample(rng, ref)) for i in range(12)]
    T2 = T.copy()
    T = port_tree(T)           # the port's engine works on the port's tree
    psamples = port_samples([s for _, s in samples])
    extra = [m for _, s in samples for m in s]
    eng = BigPlacementEngine(T, extra_mutations=[m for s in psamples
                                                 for m in s], device="cpu")
    jeng = JEngine(T2, extra_mutations=extra)

    builds = {"n": 0}
    orig = BigMAT.from_tree.__func__

    def counting(cls, *a, **k):
        builds["n"] += 1
        return orig(cls, *a, **k)

    BigMAT.from_tree = classmethod(counting)
    try:
        for (name, muts), pmuts in zip(samples, psamples):
            muts.sort(key=lambda m: m.position)
            r = eng.score_samples([pmuts], want_matrix=True)[0]
            rj = jeng.score_samples([muts], want_matrix=True)[0]
            assert (r.best_score, r.num_best, r.best_has_unique,
                    r.tied_has_unique) == \
                (rj.best_score, rj.num_best, rj.best_has_unique,
                 rj.tied_has_unique)
            assert r.best_node.identifier == rj.best_node.identifier
            assert [n.identifier for n in r.tied_nodes] == \
                [n.identifier for n in rj.tied_nodes]
            np.testing.assert_array_equal(r.scores_bfs, rj.scores_bfs)
            np.testing.assert_array_equal(r.valid_bfs, rj.valid_bfs)
            eng.apply_placement(name, r, port_score_placement(
                r.best_node, pmuts).excess)
            jeng.apply_placement(name, rj, score_placement(rj.best_node,
                                                           muts).excess)
    finally:
        BigMAT.from_tree = classmethod(orig)
    assert builds["n"] == 1
    assert port_write_newick(T, print_internal=True,
                             print_branch_len=True) == \
        write_newick(T2, print_internal=True, print_branch_len=True)

    big = eng._big
    big._flush()
    fresh = BigMAT.from_tree(T, eng.positions, eng.ref, device="cpu")
    slot = {id(n): i for i, n in enumerate(fresh._nodes)}
    amap = np.array([slot[id(n)] for n in big._nodes])
    for name in ("base", "nc_base", "node_num_mut", "F", "num_leaves",
                 "level", "is_leaf", "bfs_rank", "dfs_of", "dfs_end_of",
                 "base_spr"):
        np.testing.assert_array_equal(getattr(big, name),
                                      getattr(fresh, name)[amap],
                                      err_msg=name)


@pytest.mark.parametrize("n_shards", [2, 8])
def test_bigmat_mesh_identical(n_shards):
    """score_batch_T, score_spr_T and place_batch with the sample axis
    split over a batch mesh equal the unsharded BigMAT and the JAX BigMAT
    under its 8-device mesh, on 19 samples (uneven shards)."""
    import jax
    from jax.sharding import Mesh as JMesh
    from usher_tpu_torch.parallel.shard import batch_mesh
    rng = np.random.default_rng(5)
    T, ref = random_mat(rng, n_leaves=120, n_positions=30)
    positions = np.array(sorted(ref), dtype=np.int64)
    refarr = np.array([ref[p] for p in positions.tolist()], dtype=np.uint8)
    samples = [random_sample(rng, ref) for _ in range(19)]
    jb = JBigMAT.from_tree(T, positions, refarr)
    jb.mesh = JMesh(np.array(jax.devices()[:8]), ("batch",))
    big1 = BigMAT.from_tree(port_tree(T), positions, refarr, device="cpu")
    bigM = BigMAT.from_tree(port_tree(T), positions, refarr, device="cpu")
    bigM.mesh = batch_mesh(n_shards, device="cpu")
    psamples = port_samples(samples)
    pos, gval, kmiss = big1.sparsify(psamples)
    want = jb.score_batch_T(pos, gval, kmiss)
    _eq(big1.score_batch_T(pos, gval, kmiss), want)
    _eq(bigM.score_batch_T(pos, gval, kmiss), want)
    gv = _spr_gval(rng, pos, gval, big1.P)
    _eq(bigM.score_spr_T(pos, gv), big1.score_spr_T(pos, gv))
    want = jb.place_batch(samples)
    _eq(big1.place_batch(psamples), want)
    _eq(bigM.place_batch(psamples), want)
    with pytest.raises(ValueError, match="mesh"):
        bigM.place_arrays(pos, gval, kmiss, with_second=True)


def test_big_engine_mesh_is_flattened_and_scores_alike():
    from usher_tpu_torch.parallel.mesh import make_mesh
    rng = np.random.default_rng(6)
    T, ref = random_mat(rng, n_leaves=40, n_positions=20)
    samples = port_samples([random_sample(rng, ref) for _ in range(5)])
    extra = [m for s in samples for m in s]
    eng = BigPlacementEngine(port_tree(T), extra_mutations=extra,
                             mesh=make_mesh(8, device="cpu"))
    assert eng.mesh.shape == {"batch": 8}
    one = BigPlacementEngine(port_tree(T), extra_mutations=extra,
                             device="cpu")

    def summary(results):
        return [(r.best_score, r.num_best, r.best_node.identifier,
                 [n.identifier for n in r.tied_nodes]) for r in results]
    assert summary(eng.score_samples(samples)) == \
        summary(one.score_samples(samples))
    assert eng._big.mesh is eng.mesh


def test_seg_branch_matches_jax(monkeypatch):
    """With USHER_TPU_SEG=1 place_arrays reduces through the segment-query
    engine (X9), and its results, with and without the runner-up, are the
    JAX BigMAT's under the same setting (tests/test_torch_interval_seg.py
    holds X9 against X5 and the JAX X9 on larger MATs).  A batch mesh
    itself scores and places (test_bigmat_mesh_identical) and searches SPR
    moves (test_torch_spr_big.py::test_sharded_spr_search_matches), and the
    grouped engine (X6) is held against the JAX one in
    test_torch_grouped.py."""
    jb, tb, samples, _ = _pair(5)
    pos, gval, kmiss = tb.sparsify(samples)
    monkeypatch.setenv("USHER_TPU_SEG", "1")
    _eq(tb.place_arrays(pos, gval, kmiss), jb.place_arrays(pos, gval, kmiss))
    got = tb.place_arrays(pos, gval, kmiss, with_second=True)
    want = jb.place_arrays(pos, gval, kmiss, with_second=True)
    for g, w in zip(got, want):
        _eq(g, w)
