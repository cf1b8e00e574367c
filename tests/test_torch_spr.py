"""The port's SPR move machinery (usher_tpu_torch/optimize/spr.py, X11)
against the JAX package's, on the CPU.

X11 `_score_moves` is called on the same host arrays on both sides; the
MoveFinder's move lists, conflict resolution and move application are held
against JAX's on seeded random trees (exact: integer parsimony), also with
the source batch split over 8 CPU shards.  Each side works on trees of its
own package.
"""

import numpy as np
import pytest

from usher_tpu.core.flat import collect_positions as jcollect
from usher_tpu.core.tree import Mutation as JMutation, Tree as JTree
from usher_tpu.io.newick import write_newick as jnwk
from usher_tpu.optimize import spr as jspr
from usher_tpu.optimize.fitch import FitchEngine as JEngine
from usher_tpu.optimize.leafstore import SparseLeafStore as JStore
from usher_tpu_torch.core.tree import Mutation as TMutation, Tree as TTree
from usher_tpu_torch.io.newick import write_newick as tnwk
from usher_tpu_torch.optimize import spr as tspr
from usher_tpu_torch.optimize.fitch import FitchEngine as TEngine
from usher_tpu_torch.optimize.leafstore import SparseLeafStore as TStore

from test_torch_fitch import random_opt_tree
from test_torch_hostlayers import port_tree


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("USHER_TPU_PLATFORM", "cpu")


def finders(T, chunk=32, mesh=None):
    """A rewritten tree pair (JAX T, port copy) and their MoveFinders over
    the canonical FS states."""
    positions, _, chrom = jcollect(T)
    eng = JEngine(T, positions, chunk=16)
    store, rr = JStore.from_tree(T, positions)
    eng.rewrite_mutations(*eng.run(store, rr)[:1], store, rr, chrom)
    eng = JEngine(T, positions, chunk=16)
    states, masks = eng.run(store, rr)
    jf = jspr.MoveFinder(T, states, masks, rr, eng.bfs, eng.parent,
                         chunk=chunk)
    P = port_tree(T)
    teng = TEngine(P, positions, chunk=16, device="cpu")
    tstates, tmasks = teng.run(TStore.from_tree(P, positions)[0], rr)
    np.testing.assert_array_equal(tstates, states)
    tf = tspr.MoveFinder(P, tstates, tmasks, rr, teng.bfs, teng.parent,
                         chunk=chunk, mesh=mesh,
                         device=None if mesh is not None else "cpu")
    return jf, tf


def signature(moves):
    return [(m.src.identifier, m.dst.identifier, m.improvement,
             m.sibling_split, m.src_interval, m.dst_dfs) for m in moves]


@pytest.mark.parametrize("radius", [1, 2, 4, 1000])
@pytest.mark.parametrize("seed", [0, 1])
def test_score_moves_matches_jax(seed, radius):
    """X11 on the same host arrays: (best_cost, best_slot, has_unique)."""
    import jax.numpy as jnp
    import torch
    jf, tf = finders(random_opt_tree(seed, n=70))
    idxs = list(range(1, tf.n))
    g, _, src = tf._chunk_inputs(idxs)
    want = jspr._score_moves(
        jf.st, jf.stp, jf.ref, jf.active, jnp.asarray(g), jf.num_leaves,
        jf.bfs_rank, jf.dfs_idx_dev, jf.level_dev,
        *(jnp.asarray(a) for a in src), jnp.int32(radius),
        src[0].shape[1])
    t = tf.tree_on(tf.device)
    got = tspr._score_moves(
        t["st"], t["stp"], t["ref"], t["active"], torch.from_numpy(g),
        t["num_leaves"], t["bfs_rank"], t["dfs_idx"], t["level"],
        *(torch.from_numpy(a) for a in src), radius)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("chunk", [7, 32, 512])
@pytest.mark.parametrize("seed", [2, 3, 4])
def test_move_finder_matches_jax(seed, chunk):
    jf, tf = finders(random_opt_tree(seed, n=80), chunk=chunk)
    for radius in (2, 4, -1):
        assert signature(tf.find_moves(radius)) == \
            signature(jf.find_moves(radius))


def test_move_finder_mesh_matches_jax():
    """The source batch split over 8 CPU shards: the JAX moves."""
    from usher_tpu_torch.parallel.shard import batch_mesh
    jf, tf = finders(random_opt_tree(5, n=90), chunk=4,
                     mesh=batch_mesh(8, device="cpu"))
    assert tf.chunk == 32
    sources = list(range(1, tf.n, 2))
    for radius in (3, 1000):
        assert signature(tf.find_moves(radius, sources=sources)) == \
            signature(jf.find_moves(radius, sources=sources))


def test_resolve_and_apply_match_jax():
    """The accepted set and the trees after applying it."""
    jf, tf = finders(random_opt_tree(6, n=90))
    jm = jspr.resolve_conflicts(jf.find_moves(4))
    tm = tspr.resolve_conflicts(tf.find_moves(4))
    assert signature(tm) == signature(jm)
    assert len(tm) > 1
    for mv in jm:
        jspr.apply_move(jf.T, mv)
    for mv in tm:
        tspr.apply_move(tf.T, mv)
    assert tnwk(tf.T, print_internal=True, print_branch_len=True) == \
        jnwk(jf.T, print_internal=True, print_branch_len=True)


def test_merge_count_and_collapse_bonus_match():
    T = random_opt_tree(8, n=60, hi=120)
    P = port_tree(T)
    for jn, tn in zip(T.breadth_first_expansion(), P.breadth_first_expansion()):
        assert tspr.collapse_bonus(tn) == jspr.collapse_bonus(jn)
        if jn.parent is not None:
            assert tspr.merge_count(tn.parent.mutations, tn.mutations) == \
                jspr.merge_count(jn.parent.mutations, jn.mutations)


def test_apply_move_undo_roundtrip():
    """Mirror of test_optimize's: apply_move's undo log restores the exact
    pre-move tree (topology, mutations, levels, node table)."""
    def build():
        T = TTree()
        T.create_node("root")
        rng = np.random.default_rng(3)
        nodes = ["root"]
        for i in range(40):
            n = T.create_node(f"n{i}", nodes[int(rng.integers(len(nodes)))])
            n.add_mutation(TMutation("c", int(rng.integers(100, 160)), 1, 1,
                                     [1, 2, 4, 8][int(rng.integers(1, 4))]))
            nodes.append(f"n{i}")
        return T

    def sig(T):
        return (tnwk(T, print_internal=True, print_branch_len=True),
                {k: (tuple((m.position, m.par_nuc, m.mut_nuc)
                           for m in v.mutations), v.level,
                     v.parent.identifier if v.parent else None)
                 for k, v in T._all_nodes.items()})

    rng = np.random.default_rng(11)
    applied_any = 0
    for trial in range(30):
        T = build()
        before = sig(T)
        ids = [k for k in T._all_nodes if k != "root"]
        logs = []
        for _ in range(3):
            s = T.get_node(ids[int(rng.integers(len(ids)))])
            d = T.get_node(ids[int(rng.integers(len(ids)))])
            if s is None or d is None or s is d:
                continue
            anc, ok = d, True
            while anc is not None:
                if anc is s:
                    ok = False
                    break
                anc = anc.parent
            if not ok or d is s.parent or d.parent is None:
                continue
            logs.append(tspr.apply_move(T, tspr.Move(
                src=s, dst=d, improvement=1,
                sibling_split=bool(rng.integers(2)), src_interval=(0, 0),
                dst_dfs=0)))
        if logs:
            applied_any += 1
            tspr.revert_moves(T, logs)
            assert sig(T) == before, f"trial {trial} mismatch"
    assert applied_any > 10


def test_spr_repairs_known_misplacement():
    """Mirror of test_optimize's: D moves next to B and C, 3 -> 2."""
    from usher_tpu_torch.optimize import OptimizeOptions, optimize_tree
    T = TTree()
    T.create_node("root")
    for name, par in [("i1", "root"), ("i2", "root"), ("A", "i1"),
                      ("D", "i1"), ("B", "i2"), ("C", "i2")]:
        T.create_node(name, par)
    T.get_node("i2").mutations = [TMutation("c", 100, 1, 1, 4)]
    T.get_node("D").mutations = [TMutation("c", 100, 1, 1, 4)]
    T.get_node("B").mutations = [TMutation("c", 200, 1, 1, 2)]
    assert T.get_parsimony_score() == 3
    assert optimize_tree(T, OptimizeOptions(radius=8), "cpu") == 2
    assert "i2" in {n.identifier for n in T.rsearch("D")} or \
        T.get_node("D").parent is T.get_node("B").parent
