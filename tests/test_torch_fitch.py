"""The port's Fitch-Sankoff (usher_tpu_torch/optimize/fitch.py, X3) against
the JAX package's, on the CPU.

Both DP variants (the normalized unit-cost `_fs_chunk` and the
(parsimony, back-mutation) `_min_back_chunk`) are held against JAX's on
seeded random trees and on the fixture, with no tolerance: the arithmetic
is integer.  The root-row rule of the JAX programs (ROADMAP queue C: the
root's score row is kept only when every level has at most one unique
parent) is pinned on the smallest tree that shows it and on a chain, where
the root's row is the true one.  Each side works on trees of its own
package (`port_tree`).
"""

import os

import numpy as np
import pytest

from usher_tpu.core.flat import collect_positions as jcollect
from usher_tpu.core.tree import Mutation as JMutation, Tree as JTree
from usher_tpu.io.newick import parse_newick as jparse, write_newick as jnwk
from usher_tpu.io.vcf import read_vcf_sites as jread_sites
from usher_tpu.ops.sankoff import assign_states_from_vcf as jassign
from usher_tpu.optimize import fitch as jfitch
from usher_tpu.optimize.leafstore import SparseLeafStore as JStore
from usher_tpu_torch.core.flat import collect_positions as tcollect
from usher_tpu_torch.io.newick import write_newick as tnwk
from usher_tpu_torch.optimize import fitch as tfitch
from usher_tpu_torch.optimize.leafstore import SparseLeafStore as TStore

from conftest import REFERENCE_SCRIPTS_DIR, REFERENCE_TEST_DIR
from test_torch_hostlayers import port_tree

GLOBAL_NH = os.path.join(REFERENCE_TEST_DIR, "global_phylo.nh")
GLOBAL_VCF = os.path.join(REFERENCE_TEST_DIR, "global_samples.vcf")
BASES = [1, 2, 4, 8]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("USHER_TPU_PLATFORM", "cpu")


def random_opt_tree(seed, n=70, lo=100, hi=160, max_muts=4):
    """The JAX optimize tests' random tree: each node hangs under a random
    earlier one with 1..max_muts-1 random mutations (ref A) in [lo, hi)."""
    rng = np.random.default_rng(seed)
    T = JTree()
    T.create_node("root")
    nodes = ["root"]
    for i in range(n):
        nd = T.create_node(f"n{i}", nodes[int(rng.integers(len(nodes)))])
        for _ in range(int(rng.integers(1, max_muts))):
            nd.add_mutation(JMutation("c", int(rng.integers(lo, hi)), 1, 1,
                                      BASES[int(rng.integers(1, 4))]))
        nodes.append(f"n{i}")
    return T


def nine_node_tree():
    """root -> (i1, i2), i1 -> (A, B), i2 -> (C, j), j -> (D, E); i1 and i2
    carry A->G at 100, A carries A->T at 300, j carries A->C at 200.  Level
    2 has two unique parents, so JAX keeps the root's old (zero) row."""
    T = JTree()
    T.create_node("root")
    for name, par in [("i1", "root"), ("i2", "root"), ("A", "i1"),
                      ("B", "i1"), ("C", "i2"), ("j", "i2"), ("D", "j"),
                      ("E", "j")]:
        T.create_node(name, par)
    for name, pos, mut in [("i1", 100, 4), ("i2", 100, 4), ("A", 300, 8),
                           ("j", 200, 2)]:
        T.get_node(name).mutations = [JMutation("c", pos, 1, 1, mut)]
    return T


def chain_tree():
    """root -> x1 -> x2 -> (L1, L2): every level has one unique parent, so
    the root gets its true Fitch row."""
    T = JTree()
    T.create_node("root")
    T.create_node("x1", "root")
    T.create_node("x2", "x1")
    T.create_node("L1", "x2")
    T.create_node("L2", "x2")
    T.get_node("x1").mutations = [JMutation("c", 100, 1, 1, 4)]
    T.get_node("L1").mutations = [JMutation("c", 200, 1, 1, 2)]
    return T


def both_engines(T, chunk=512, mesh=None):
    positions, _, _ = jcollect(T)
    je = jfitch.FitchEngine(T, positions, chunk=chunk)
    P = port_tree(T)
    te = tfitch.FitchEngine(P, positions, chunk=chunk, device="cpu",
                            mesh=mesh)
    return je, te, positions, P


@pytest.mark.parametrize("min_back", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_dp_matches_jax_on_random_trees(seed, min_back):
    T = random_opt_tree(seed, n=60 + 10 * seed)
    je, te, positions, _ = both_engines(T, chunk=16)
    lm, rr = jfitch.leaf_masks_from_tree(T, positions, je.bfs)
    js, jm = je.run(lm, rr, min_back=min_back)
    ts, tm = te.run(lm, rr, min_back=min_back)
    assert ts.dtype == np.int8 and tm.dtype == np.uint8
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tm, jm)


@pytest.mark.parametrize("min_back", [False, True])
def test_root_row_rule_nine_node_tree(min_back):
    """The JAX value, reproduced: root mask 0xF and the reference state at
    every position, where a true Fitch pass gives mask [4, 1, 1] (G at
    100)."""
    T = nine_node_tree()
    je, te, positions, _ = both_engines(T)
    assert te.max_u == 2
    lm, rr = jfitch.leaf_masks_from_tree(T, positions, je.bfs)
    js, jm = je.run(lm, rr, min_back=min_back)
    ts, tm = te.run(lm, rr, min_back=min_back)
    np.testing.assert_array_equal(jm[0], [15, 15, 15])
    np.testing.assert_array_equal(js[0], [0, 0, 0])
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(ts, js)


@pytest.mark.parametrize("min_back", [False, True])
def test_root_row_true_on_a_chain(min_back):
    T = chain_tree()
    je, te, positions, _ = both_engines(T)
    assert te.max_u == 1
    lm, rr = jfitch.leaf_masks_from_tree(T, positions, je.bfs)
    js, jm = je.run(lm, rr, min_back=min_back)
    ts, tm = te.run(lm, rr, min_back=min_back)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(ts, js)
    # positions 100, 200: the root's Fitch set is {G} at 100 and {A, C}
    # at 200, where the reference A wins the tie; the back-mutation DP
    # prefers A outright there (C at the root would make L2's A a back
    # mutation)
    np.testing.assert_array_equal(tm[0], [4, 1] if min_back else [4, 3])
    np.testing.assert_array_equal(ts[0], [2, 0])


def test_chunk_width_does_not_change_results():
    T = random_opt_tree(7, n=90)
    positions, _, _ = jcollect(T)
    P = port_tree(T)
    lm, rr = tfitch.leaf_masks_from_tree(P, positions)
    outs = [tfitch.FitchEngine(P, positions, chunk=c, device="cpu").run(
        lm, rr) for c in (3, 17, 4096)]
    for s, m in outs[1:]:
        np.testing.assert_array_equal(s, outs[0][0])
        np.testing.assert_array_equal(m, outs[0][1])


def test_fitch_reassignment_matches_jax_on_the_fixture():
    """Mirror of test_optimize's reassignment test: same states, masks,
    rewritten mutations and score as JAX, and the score never rises."""
    from usher_tpu_torch.io.newick import parse_newick
    from usher_tpu_torch.io.vcf import read_vcf_sites
    from usher_tpu_torch.ops.sankoff import assign_states_from_vcf
    T = jparse(GLOBAL_NH)
    jassign(T, jread_sites(GLOBAL_VCF))
    P = parse_newick(GLOBAL_NH)
    assign_states_from_vcf(P, read_vcf_sites(GLOBAL_VCF), "cpu")
    assert tnwk(P, print_internal=True, print_branch_len=True) == \
        jnwk(T, print_internal=True, print_branch_len=True)
    score0 = P.get_parsimony_score()
    positions, _, chrom = tcollect(P)
    je = jfitch.FitchEngine(T, positions)
    te = tfitch.FitchEngine(P, positions, device="cpu")
    lm, rr = jfitch.leaf_masks_from_tree(T, positions, je.bfs)
    np.testing.assert_array_equal(
        tfitch.leaf_masks_from_tree(P, positions, te.bfs)[0], lm)
    js, jm = je.run(lm, rr)
    ts, tm = te.run(lm, rr)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tm, jm)
    jsc = je.rewrite_mutations(js, lm, rr, chrom)
    tsc = te.rewrite_mutations(ts, lm, rr, chrom)
    assert tsc == jsc <= score0
    assert tsc == P.get_parsimony_score()
    assert tnwk(P, print_internal=True, print_branch_len=True) == \
        jnwk(T, print_internal=True, print_branch_len=True)


def test_sparse_leaf_store_matches_dense_and_jax():
    """Mirror of test_sparse_leaf_store_matches_dense: the port's store
    materializes what the dense rows and the JAX store hold, and the FS
    run and rewrite through it equal the dense ones."""
    T = random_opt_tree(5, n=60, hi=140)
    positions, _, chrom = jcollect(T)
    P = port_tree(T)
    eng = tfitch.FitchEngine(P, positions, chunk=8, device="cpu")
    dense, ref_row = tfitch.leaf_masks_from_tree(P, positions, eng.bfs)
    store, ref_row2 = TStore.from_tree(P, positions)
    jstore, _ = JStore.from_tree(T, positions)
    np.testing.assert_array_equal(ref_row, ref_row2)
    assert sorted(store.rows) == sorted(jstore.rows)
    for name, (c, v) in jstore.rows.items():
        np.testing.assert_array_equal(store.rows[name][0], c)
        np.testing.assert_array_equal(store.rows[name][1], v)
    for c0 in range(0, len(positions), 7):
        c1 = min(c0 + 7, len(positions))
        got = store.materialize(eng.bfs, eng.is_leaf, c0, c1)
        np.testing.assert_array_equal(got[eng.is_leaf],
                                      dense[eng.is_leaf, c0:c1])
    cols = np.array([1, 4, 9, 15])
    got = store.materialize_cols(eng.bfs, eng.is_leaf, cols)
    np.testing.assert_array_equal(got[eng.is_leaf],
                                  dense[eng.is_leaf][:, cols])
    s1, m1 = eng.run(dense, ref_row)
    s2, m2 = eng.run(store, ref_row)
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(m1, m2)
    P2 = P.copy()
    eng2 = tfitch.FitchEngine(P2, positions, chunk=8, device="cpu")
    assert eng.rewrite_mutations(s1, dense, ref_row, chrom) == \
        eng2.rewrite_mutations(s2, TStore.from_tree(P2, positions)[0],
                               ref_row, chrom)
    assert tnwk(P, print_internal=True, print_branch_len=True) == \
        tnwk(P2, print_internal=True, print_branch_len=True)


@pytest.mark.parametrize("min_back", [False, True])
def test_streamed_rewrite_matches_jax(min_back):
    T = random_opt_tree(11, n=80)
    je, te, positions, P = both_engines(T, chunk=8)
    jstore, rr = JStore.from_tree(T, positions)
    tstore, _ = TStore.from_tree(P, positions)
    jsc, jdev = je.run_rewrite_streamed(jstore, rr, "c", min_back=min_back)
    tsc, tdev = te.run_rewrite_streamed(tstore, rr, "c", min_back=min_back)
    assert tsc == jsc
    for a, b in zip(tdev.csr_triplets, jdev.csr_triplets):
        np.testing.assert_array_equal(a, b)
    for i in range(te.n):
        for a, b in zip(tdev.deviations(i), jdev.deviations(i)):
            np.testing.assert_array_equal(a, b)
    assert tnwk(P, print_internal=True, print_branch_len=True) == \
        jnwk(T, print_internal=True, print_branch_len=True)


def test_patch_and_remap_match_jax():
    """patch_mutations on a column subset and MaskDeviations.remap_patch
    give JAX's results."""
    T = random_opt_tree(12, n=50)
    je, te, positions, P = both_engines(T, chunk=8)
    lm, rr = jfitch.leaf_masks_from_tree(T, positions, je.bfs)
    cols = np.array([0, 3, 5, 8], dtype=np.int64)
    sub = lm[:, cols]
    js, jm = je.run(sub, rr[cols])
    ts, tm = te.run(sub, rr[cols])
    np.testing.assert_array_equal(ts, js)
    assert te.patch_mutations(ts, sub, rr[cols], "c", positions[cols]) == \
        je.patch_mutations(js, sub, rr[cols], "c", positions[cols])
    assert tnwk(P, print_internal=True, print_branch_len=True) == \
        jnwk(T, print_internal=True, print_branch_len=True)
    jd, td = jfitch.MaskDeviations(je.n), tfitch.MaskDeviations(te.n)
    full_s, full_m = je.run(lm, rr)
    for c0 in range(0, full_m.shape[1], 8):
        jd.set_chunk(c0, full_m[:, c0:c0 + 8], rr[c0:c0 + 8])
        td.set_chunk(c0, full_m[:, c0:c0 + 8], rr[c0:c0 + 8])
    # new rows without a source (-1, past the end) start empty
    src_rows = np.arange(te.n)[::-1].copy()
    src_rows[[1, 4]] = -1
    src_rows[7] = te.n
    a = jd.remap_patch(src_rows, cols, tm, rr[cols])
    b = td.remap_patch(src_rows, cols, tm, rr[cols])
    for want, got in ((jd, td), (a, b)):
        for i in range(te.n):
            for x, y in zip(want.deviations(i), got.deviations(i)):
                np.testing.assert_array_equal(x, y)
                assert x.dtype == y.dtype
    assert sum(len(b.deviations(i)[0]) for i in range(te.n)) > 0


def test_fitch_engine_mesh_identical(tmp_path):
    """Mirror of test_parallel's test: positions sharded over 8 CPU shards
    equal one device and JAX's 8-device mesh."""
    from usher_tpu.cli.usher_cli import main as jax_usher
    from usher_tpu.io.pbio import load_mat_pb
    from usher_tpu.parallel.shard import batch_mesh as jmesh
    from usher_tpu_torch.io.pbio import load_mat_pb as tload
    from usher_tpu_torch.parallel.shard import batch_mesh
    build = str(tmp_path / "b")
    pb = os.path.join(build, "o.pb")
    assert jax_usher(["-t", os.path.join(REFERENCE_SCRIPTS_DIR,
                                         "testBranchLen2.nwk"),
                      "-v", os.path.join(REFERENCE_SCRIPTS_DIR,
                                         "testBranchLen2.vcf"),
                      "-o", pb, "-d", build]) == 0
    T = load_mat_pb(pb)
    P = tload(pb)
    positions, _, _ = jcollect(T)
    j8 = jfitch.FitchEngine(T, positions, chunk=4, mesh=jmesh(8))
    lm, rr = jfitch.leaf_masks_from_tree(T, positions, j8.bfs)
    js, jm = j8.run(lm, rr)
    one = tfitch.FitchEngine(P, positions, chunk=4, device="cpu")
    t8 = tfitch.FitchEngine(P, positions, chunk=4,
                            mesh=batch_mesh(8, device="cpu"))
    for mb in (False, True):
        s1, m1 = one.run(lm, rr, min_back=mb)
        s8, m8 = t8.run(lm, rr, min_back=mb)
        np.testing.assert_array_equal(s8, s1)
        np.testing.assert_array_equal(m8, m1)
    np.testing.assert_array_equal(t8.run(lm, rr)[0], js)
    np.testing.assert_array_equal(t8.run(lm, rr)[1], jm)
