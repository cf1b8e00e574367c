"""usher_tpu_torch.parallel.mesh against usher_tpu.parallel.mesh.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py (its
Pallas kernel in interpret mode under shard_map); the port runs its shards
as CPU tensors, so mesh B1 goes through its plain twin.  Inputs come from a
numpy seed and go through both; everything is integer arithmetic, so the
comparisons are exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

from usher_tpu.core.flat import FlatMAT as JFlatMAT
from usher_tpu.ops import placement_pallas as pp
from usher_tpu.parallel import mesh as jmesh
from usher_tpu.placement.driver import PlacementEngine as JEngine
from usher_tpu_torch.core import tree as ttree
from usher_tpu_torch.core.flat import FlatMAT
from usher_tpu_torch.ops import placement as dev
from usher_tpu_torch.ops import placement_sparse as ps
from usher_tpu_torch.parallel import mesh as pmesh
from usher_tpu_torch.parallel import shard as pshard
from usher_tpu_torch.placement.driver import PlacementEngine

from test_placement import BASES, random_mat, random_sample
from test_torch_hostlayers import port_samples, port_tree

NIBBLES = np.array([1, 2, 4, 8], dtype=np.uint8)
MESHES = [(2, 1), (4, 2), (8, 2)]          # (devices, data): 1x2, 2x2, 2x4


def flat_inputs(seed, N=64, P=128, B=8):
    """Seeded flat-MAT arrays in the argument order of shard_flat_inputs:
    random parents, three branch mutations a node, forced ties in leaves,
    ambiguous and missing sample entries."""
    rng = np.random.default_rng(seed)
    ref = NIBBLES[rng.integers(0, 4, size=P)]
    parent = np.zeros(N, dtype=np.int32)
    parent[1:] = (rng.random(N - 1) * np.arange(1, N)).astype(np.int32)
    st = np.empty((N, P), dtype=np.uint8)
    st[0] = ref
    for i in range(1, N):
        st[i] = st[parent[i]]
        st[i, rng.integers(0, P, size=3)] = NIBBLES[rng.integers(0, 4, 3)]
    stp = st[parent].copy()
    active = rng.random(N) < 0.9
    active[0] = True
    is_leaf = np.ones(N, dtype=bool)
    is_leaf[parent[1:]] = False
    is_leaf[0] = False
    is_root_mask = np.zeros(N, dtype=bool)
    is_root_mask[0] = True
    num_leaves = rng.integers(1, 4, size=N).astype(np.int32)   # many ties
    bfs_rank = rng.permutation(N).astype(np.int32)
    g = np.tile(ref, (B, 1))
    E = np.zeros((B, P), dtype=bool)
    miss = np.zeros((B, P), dtype=bool)
    for b in range(B):
        near = st[int(rng.integers(N))]
        cols = rng.integers(0, P, size=6)
        E[b, cols] = True
        g[b, cols] = near[cols]
        g[b, cols[0]] = rng.integers(1, 16)          # ambiguous mask
        miss[b, cols[1]] = True
        g[b, cols[1]] = 15
        diff = near != ref                           # entries where it parts
        E[b] |= diff
        g[b, diff & ~miss[b]] = near[diff & ~miss[b]]
    g[~E] = np.tile(ref, (B, 1))[~E]
    return (st, stp, ref, active, num_leaves, bfs_rank, is_leaf,
            is_root_mask, g, E, miss)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# --- the mesh itself -------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_make_mesh_factoring_matches_jax(n):
    mesh = pmesh.make_mesh(n, device="cpu")
    want = jmesh.make_mesh(n)
    assert mesh.shape == dict(want.shape)
    assert mesh.axis_names == tuple(want.axis_names)
    assert mesh.size == n and mesh.devices.shape == want.devices.shape
    if n == 8:
        assert mesh.shape == {"data": 2, "model": 4}
    assert pmesh.make_mesh(n, data=1, device="cpu").shape == \
        dict(jmesh.make_mesh(n, data=1).shape)


def test_shards_share_tensors_on_one_device():
    """Repeats of a shard that fall on one device are one tensor, and the
    bounds of an uneven split cover every row once."""
    mesh = pmesh.make_mesh(8, device="cpu")
    x = pmesh.put_nodes(mesh, np.arange(70, dtype=np.int32))
    assert x[0][1] is x[1][1] and x[0][0] is not x[0][1]
    assert [int(t.shape[0]) for t in x[0]] == [18, 18, 18, 16]
    assert pmesh.gather_nodes(x).tolist() == list(range(70))
    assert pmesh.split_bounds(5, 4) == [(0, 2), (2, 4), (4, 5), (5, 5)]
    flat = mesh.flattened()
    assert flat.shape == {"batch": 8} and flat.lead == mesh.lead
    assert mesh.stream((0, 0)) is None            # CPU shards have no stream
    bm = pshard.batch_mesh(4, device="cpu")
    parts = pshard.put_batch(bm, np.arange(10).reshape(2, 5), axis_index=1)
    assert [tuple(p.shape) for p in parts] == [(2, 2), (2, 2), (2, 1), (2, 0)]
    rep = pshard.put_replicated(bm, np.arange(3))
    assert rep[0] is rep[3]


# --- the sharded functions against the JAX package's ------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_sharded_placement_step_matches_jax_and_single_device(seed):
    args = flat_inputs(seed)
    st, stp, ref, active, num_leaves, bfs_rank, is_leaf, is_root, g, E, miss \
        = args
    jm = jmesh.make_mesh(8)
    want = jmesh.sharded_placement_step(jm)(
        *jmesh.shard_flat_inputs(jm, *args))
    mesh = pmesh.make_mesh(8, device="cpu")
    got = pmesh.sharded_placement_step(mesh)(
        *pmesh.shard_flat_inputs(mesh, *args))
    _same(got, want)
    # the port's single-device step, winner row turned into its rank
    targs = [_t(a) for a in args]
    one = pmesh._placement_step(*targs)
    _same(one, want)
    parent_free = dev.score_with_stp(_t(st), _t(stp), _t(ref), _t(active),
                                     _t(g), _t(E), _t(miss))
    valid, _ = dev.valid_mask(parent_free[0], parent_free[1],
                              parent_free[2], _t(is_root), _t(is_leaf),
                              _t(active))
    best, slot, num_best = dev.reduce_best(parent_free[0], valid,
                                           _t(num_leaves), _t(bfs_rank))
    _same((best, _t(bfs_rank)[slot.long()], num_best), want)


@pytest.mark.parametrize("n,data", MESHES)
def test_sharded_score_fn_matches_jax(n, data):
    args = flat_inputs(2)
    st, stp, ref, active, _, _, _, _, g, E, miss = args
    jm = jmesh.make_mesh(n, data)
    sh = jmesh.shard_flat_inputs(jm, *args)
    want = jmesh.sharded_score_fn(jm)(sh[0], sh[1], sh[2], sh[3], sh[8],
                                      sh[9], sh[10])
    mesh = pmesh.make_mesh(n, data, device="cpu")
    assert mesh.shape == dict(jm.shape)
    psh = pmesh.shard_flat_inputs(mesh, *args)
    score, nc, nnm = pmesh.sharded_score_fn(mesh)(
        psh[0], psh[1], psh[2], psh[3], psh[8], psh[9], psh[10])
    assert len(score) == mesh.shape["data"]
    assert len(score[0]) == mesh.shape["model"]
    _same((pmesh.gather_blocks(score, node_axis=1),
           pmesh.gather_blocks(nc, node_axis=1), pmesh.gather_nodes(nnm)),
          want)


@pytest.mark.parametrize("n,data", MESHES)
def test_sharded_sparse_score_fn_matches_jax(n, data):
    """mesh B1: per shard blocks equal the JAX shard_map of the Pallas
    kernel, and the plain twin gives the same."""
    st, stp, ref, _, _, _, _, _, g, E, miss = flat_inputs(3)
    pos, gval, kmiss = pp.sparsify_dense(g, E, miss)
    jm = jmesh.make_mesh(n, data)
    from jax.sharding import NamedSharding, PartitionSpec as P
    import jax
    node_sh = NamedSharding(jm, P("model", None))
    batch_sh = NamedSharding(jm, P("data", None))
    put = jax.device_put
    want = jmesh.sharded_sparse_score_fn(jm, pos.shape[1])(
        put(st, node_sh), put(stp, node_sh),
        put(ref, NamedSharding(jm, P())), put(pos, batch_sh),
        put(gval, batch_sh), put(kmiss, batch_sh))
    mesh = pmesh.make_mesh(n, data, device="cpu")
    sh = pmesh.shard_sparse_inputs(mesh, st, stp, ref, pos, gval, kmiss)
    before = ps.score_entries_T.launches
    for fn in (pmesh.sharded_sparse_score_fn(mesh),
               lambda *a: pmesh.sharded_sparse_score_plain(mesh, *a)):
        score_t, nc_t, nnm = fn(*sh)
        assert tuple(score_t[0][0].shape) == (
            64 // mesh.shape["model"], 8 // mesh.shape["data"])
        _same((pmesh.gather_blocks(score_t), pmesh.gather_blocks(nc_t),
               pmesh.gather_nodes(nnm)), want)
    # no kernel was launched for CPU shards
    assert ps.score_entries_T.launches == before


@pytest.mark.parametrize("n,data", MESHES)
def test_uneven_splits_match_unsharded(n, data):
    """B not a multiple of the data size, N not a multiple of the model
    size: dense, sparse and both fused steps equal the unsharded port."""
    args = flat_inputs(4, N=70, P=128, B=7)
    st, stp, ref, active, num_leaves, bfs_rank, is_leaf, is_root, g, E, miss \
        = args
    mesh = pmesh.make_mesh(n, data, device="cpu")
    psh = pmesh.shard_flat_inputs(mesh, *args)
    want = dev.score_with_stp(_t(st), _t(stp), _t(ref), _t(active), _t(g),
                              _t(E), _t(miss))
    score, nc, nnm = pmesh.sharded_score_fn(mesh)(
        psh[0], psh[1], psh[2], psh[3], psh[8], psh[9], psh[10])
    _same((pmesh.gather_blocks(score, 1), pmesh.gather_blocks(nc, 1),
           pmesh.gather_nodes(nnm)), want)

    pos, gval, kmiss = ps.sparsify_dense(g, E, miss)
    want_s = ps.score_sparse_stp_T(_t(st), _t(stp), _t(ref), _t(pos),
                                   _t(gval), _t(kmiss))
    sh = pmesh.shard_sparse_inputs(mesh, st, stp, ref, pos, gval, kmiss)
    score_t, nc_t, nnm = pmesh.sharded_sparse_score_fn(mesh)(*sh)
    _same((pmesh.gather_blocks(score_t), pmesh.gather_blocks(nc_t),
           pmesh.gather_nodes(nnm)), want_s)

    want_step = pmesh._placement_step(*[_t(a) for a in args])
    _same(pmesh.sharded_placement_step(mesh)(*psh), want_step)
    node = [pmesh.put_nodes(mesh, a) for a in (active, is_leaf, is_root,
                                               num_leaves, bfs_rank)]
    _same(pmesh.sharded_placement_reduce(mesh, sh[0], sh[1], sh[2], *node,
                                         *sh[3:]), want_step)
    # and the single-device B2 twin: its row is the winner rank's row
    base, nc_base, nnm1 = ps.row_reductions(_t(st), _t(stp), _t(ref))
    b, row, nb = ps.placement_reduce(
        _t(st), _t(stp), _t(ref), base, nc_base, nnm1, _t(active),
        _t(is_leaf), _t(is_root), _t(num_leaves), _t(bfs_rank), _t(pos),
        _t(gval), _t(kmiss))
    _same((b, _t(bfs_rank)[row.long()], nb), want_step)


# --- the merge ----------------------------------------------------------------------

def _parts(rows):
    """[n_parts, B] partial tensors from rows of (best, cnt, leaves,
    rank2) tuples per part and sample."""
    a = torch.tensor(rows, dtype=torch.int32)          # [parts, B, 4]
    return tuple(a[:, :, k] for k in range(4))


@pytest.mark.parametrize("name,parts,want", [
    # the min is reached in two shards: counts add, leaves decide
    ("min_in_two_shards",
     [[(3, 2, 5, 2 * 7)], [(3, 1, 9, 2 * 2)], [(4, 6, 50, 2 * 40)]],
     (3, 2, 3)),
    # equal leaves in two shards at the min: the higher BFS rank wins
    ("equal_leaves_ranks_apart",
     [[(2, 1, 4, 2 * 3 + 1)], [(2, 4, 4, 2 * 11)], [(2, 1, 1, 2 * 30)]],
     (2, 11, 6)),
    # a shard with no valid row (BIG, 0, -1, -1) never wins or counts
    ("empty_shard",
     [[(1 << 30, 0, -1, -1)], [(7, 2, 1, 2 * 5 + 1)]],
     (7, 5, 2)),
    # has_unique rides in the low bit and does not disturb the rank order
    ("has_unique_bit",
     [[(5, 1, 2, 2 * 8 + 1)], [(5, 1, 2, 2 * 9)]],
     (5, 9, 2)),
])
def test_merge_partials_tie_cases(name, parts, want):
    got = ps.merge_partials(*_parts(parts))
    assert tuple(int(x[0]) for x in got) == want, name


def test_partials_plain_equals_full_reduction():
    """Partials of row blocks merged == the tie-broken argmin over all
    rows, whatever the block boundaries."""
    st, stp, ref, active, num_leaves, bfs_rank, is_leaf, is_root, g, E, miss \
        = flat_inputs(5, N=50, B=9)
    pos, gval, kmiss = ps.sparsify_dense(g, E, miss)
    base, nc_base, nnm = ps.row_reductions(_t(st), _t(stp), _t(ref))
    score_t, nc_t = ps.score_entries_T_plain(
        _t(st), _t(stp), _t(ref), base, nc_base, _t(pos), _t(gval),
        _t(kmiss))
    node = (nnm, _t(active), _t(is_leaf), _t(is_root), _t(num_leaves),
            _t(bfs_rank))
    want = ps.placement_reduce_plain(
        _t(st), _t(stp), _t(ref), base, nc_base, *node, _t(pos), _t(gval),
        _t(kmiss))
    for cuts in ([0, 50], [0, 1, 50], [0, 17, 17, 33, 50]):
        parts = torch.cat([ps.partials_plain(
            score_t[lo:hi], nc_t[lo:hi], *(x[lo:hi] for x in node))
            for lo, hi in zip(cuts, cuts[1:])], dim=1)
        best, rank, num_best = ps.merge_partials(*parts)
        row = ps.row_of_rank(rank, _t(bfs_rank), 50)
        _same((best, row, num_best), want)


# --- FlatMAT and the engine under a mesh --------------------------------------------

def _path_state(node, p, ref):
    state = ref
    chain = []
    while node is not None:
        chain.append(node)
        node = node.parent
    for nd in reversed(chain):
        for m in nd.mutations:
            if m.position == p:
                state = m.mut_nuc
    return state


def _assert_flat_mesh_same(jflat, flat):
    st_j, stp_j = jflat.sync_mesh()
    st, stp = flat.sync_mesh()
    assert (flat.cap, flat.n_slots, flat.P_pad) == (
        jflat.cap, jflat.n_slots, jflat.P_pad)
    model = flat.mesh.shape["model"]
    assert flat.cap % model == 0
    assert all(tuple(t.shape) == (flat.cap // model, flat.P_pad)
               for per_d in st for t in per_d)
    for d in range(flat.mesh.shape["data"]):
        np.testing.assert_array_equal(
            np.concatenate([t.numpy() for t in st[d]]), np.asarray(st_j))
        np.testing.assert_array_equal(
            np.concatenate([t.numpy() for t in stp[d]]), np.asarray(stp_j))
    np.testing.assert_array_equal(flat.st_host, jflat.st_host)
    np.testing.assert_array_equal(flat.stp_host, jflat.stp_host)
    np.testing.assert_array_equal(flat.parent_slot, jflat.parent_slot)


@pytest.mark.parametrize("seed", [0, 1])
def test_flat_mesh_parity_through_surgery_and_growth(seed):
    """FlatMAT(mesh=) after add_node, reparent and _grow holds the st and
    stp of the JAX FlatMAT(mesh=), shard by shard."""
    from usher_tpu.core import tree as jtree
    rng = np.random.default_rng(seed)
    T, ref = random_mat(rng, n_leaves=12)
    PT = port_tree(T)
    positions = np.array(sorted(ref), dtype=np.int64)
    refarr = np.array([ref[p] for p in positions.tolist()], dtype=np.uint8)
    jflat = JFlatMAT(T, positions, refarr, "c", mesh=jmesh.make_mesh(8))
    flat = FlatMAT(PT, positions, refarr, "c",
                   mesh=pmesh.make_mesh(8, device="cpu"))
    _assert_flat_mesh_same(jflat, flat)
    cap0 = flat.cap
    sides = ((T, jflat, jtree), (PT, flat, ttree))
    for i in range(cap0 - flat.n_slots + 5):
        nodes = T.breadth_first_expansion()
        target_id = nodes[int(rng.integers(len(nodes)))].identifier
        split = T.get_node(target_id).parent is not None and i % 3 == 0
        p = int(positions[int(rng.integers(len(positions)))])
        pick = int(rng.integers(3))
        for tree, fl, mod in sides:
            target = tree.get_node(target_id)
            if split:
                mid = tree.create_node(f"mid{i}", target.parent)
                tree.move_node(target.identifier, mid.identifier)
                fl.add_node(mid)
                fl.reparent(target)
                target = mid
            leaf = tree.create_node(f"new{i}", target)
            state = _path_state(target, p, ref[p])
            mut = [b for b in BASES if b != state][pick]
            leaf.add_mutation(mod.Mutation("c", p, ref[p], state, mut))
            fl.add_node(leaf)
        if i % 9 == 0:
            _assert_flat_mesh_same(jflat, flat)
    assert flat.cap > cap0
    _assert_flat_mesh_same(jflat, flat)


def test_flat_mesh_cap_divides_by_an_odd_model_size():
    rng = np.random.default_rng(3)
    T, ref = random_mat(rng, n_leaves=12)
    positions = np.array(sorted(ref), dtype=np.int64)
    refarr = np.array([ref[p] for p in positions.tolist()], dtype=np.uint8)
    flat = FlatMAT(port_tree(T), positions, refarr, "c",
                   mesh=pmesh.make_mesh(3, device="cpu"))
    assert flat.cap % 3 == 0 and flat.cap % 128 == 0
    flat._grow(flat.cap + 1)
    assert flat.cap % 3 == 0
    with pytest.raises(ValueError, match="mesh"):
        FlatMAT(port_tree(T), positions, refarr, "c").sync_mesh()


def _summary(results):
    return [(r.best_score, r.num_best, r.best_node.identifier,
             r.best_has_unique, [n.identifier for n in r.tied_nodes],
             r.tied_has_unique) for r in results]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_engine_mesh_dense_sparse_and_no_mesh_agree(n):
    """PlacementEngine(mesh=): dense == sparse == no mesh == the JAX engine
    under its mesh, on 9 samples (odd, so the batch is padded), and the
    fused pre-pass agrees with them."""
    rng = np.random.default_rng(11)
    T, ref = random_mat(rng, n_leaves=60, n_positions=24)
    samples = [random_sample(rng, ref) for _ in range(9)]
    extra = [m for s in samples for m in s]
    want = _summary(JEngine(T, mesh=jmesh.make_mesh(n), backend="dense",
                            extra_mutations=extra).score_samples(samples))
    psamples = port_samples(samples)
    pextra = [m for s in psamples for m in s]
    plain = PlacementEngine(port_tree(T), backend="dense", device="cpu",
                            extra_mutations=pextra)
    assert _summary(plain.score_samples(psamples)) == want
    for backend in ("dense", "sparse"):
        eng = PlacementEngine(port_tree(T), backend=backend,
                              mesh=pmesh.make_mesh(n, device="cpu"),
                              extra_mutations=pextra)
        assert eng.device == torch.device("cpu")
        assert _summary(eng.score_samples(psamples)) == want
        best, num_best = eng.best_placements(psamples)
        assert best.tolist() == [w[0] for w in want]
        assert num_best.tolist() == [w[1] for w in want]


def test_engine_mesh_stays_exact_through_placements():
    """Placing samples one after another (appends, splits, row patches in
    the shards) keeps the mesh engine equal to the single-device one."""
    from usher_tpu_torch.placement.mapper import score_placement
    rng = np.random.default_rng(12)
    T, ref = random_mat(rng, n_leaves=40, n_positions=20)
    samples = port_samples([random_sample(rng, ref) for _ in range(10)])
    extra = [m for s in samples for m in s]
    engines = [PlacementEngine(port_tree(T), backend="sparse", device="cpu",
                               extra_mutations=extra),
               PlacementEngine(port_tree(T), backend="sparse",
                               mesh=pmesh.make_mesh(4, device="cpu"),
                               extra_mutations=extra)]
    for i, muts in enumerate(samples):
        res = [e.score_samples([muts])[0] for e in engines]
        assert _summary([res[0]]) == _summary([res[1]])
        for e, r in zip(engines, res):
            e.apply_placement(f"S{i}", r,
                              score_placement(r.best_node, muts).excess)
    assert engines[1].flat.n_slots > 40
