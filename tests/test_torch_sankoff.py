"""usher_tpu_torch.ops.sankoff against the JAX usher_tpu.ops.sankoff: the
per-site state tensor and the branch-mutation sets attached to the tree are
equal on random multifurcating trees (ambiguous, missing and variant
leaves) and on the reference fixture global_phylo.nh + global_samples.vcf
(~4k leaves x 423 sites).  Tolerance: none (integer arithmetic)."""

import os

import numpy as np
import pytest
import torch

from usher_tpu.io.newick import parse_newick, parse_newick_string
from usher_tpu.io.vcf import read_vcf
from usher_tpu.ops import sankoff as jsankoff
from usher_tpu_torch.ops import sankoff

from conftest import REFERENCE_TEST_DIR
from test_sankoff import _random_case
from test_torch_hostlayers import port_tree


def _mutation_sets(T):
    return {n.identifier: [(m.position, m.ref_nuc, m.par_nuc, m.mut_nuc)
                           for m in n.mutations]
            for n in T.breadth_first_expansion()}


def _state_inputs(rng, n_leaves, n_sites):
    """Random tree as (leaf_mask, is_leaf, parent, levels, ref_nt)."""
    T, vcf, _ = _random_case(rng, n_leaves, n_sites)
    bfs = T.breadth_first_expansion()
    idx = {n.identifier: i for i, n in enumerate(bfs)}
    parent = np.array([idx[n.parent.identifier] if n.parent else 0
                       for n in bfs], dtype=np.int32)
    is_leaf = np.array([n.is_leaf() for n in bfs])
    levels = {}
    for i, n in enumerate(bfs):
        levels.setdefault(n.level, []).append(i)
    keys = sorted(levels)[1:]
    leaf_mask = rng.integers(1, 16, size=(len(bfs), n_sites)).astype(np.uint8)
    leaf_mask[~is_leaf] = 0
    ref_nt = rng.integers(0, 4, size=n_sites).astype(np.int32)
    return leaf_mask, is_leaf, parent, keys, levels, ref_nt


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sankoff_states_match_jax(seed):
    rng = np.random.default_rng(seed)
    leaf_mask, is_leaf, parent, keys, levels, ref_nt = _state_inputs(
        rng, n_leaves=30, n_sites=9)
    want = jsankoff._sankoff_states(
        leaf_mask, is_leaf, parent,
        tuple(np.asarray(levels[k], np.int32) for k in reversed(keys)),
        tuple(np.asarray(levels[k], np.int32) for k in keys),
        ref_nt, num_nodes=len(parent))
    got = sankoff._sankoff_states(
        torch.from_numpy(leaf_mask), torch.from_numpy(is_leaf),
        torch.from_numpy(parent).long(),
        [torch.tensor(levels[k]) for k in reversed(keys)],
        [torch.tensor(levels[k]) for k in keys],
        torch.from_numpy(ref_nt).long(), num_nodes=len(parent))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assign_states_matches_jax_random(seed):
    T1, vcf, _ = _random_case(np.random.default_rng(seed), 24, 12)
    T2 = port_tree(T1)         # VcfData is plain data: both sides read it
    jsankoff.assign_states_from_vcf(T1, vcf)
    sankoff.assign_states_from_vcf(T2, vcf, "cpu")
    assert _mutation_sets(T2) == _mutation_sets(T1)


def test_assign_states_matches_jax_fixture():
    nh = os.path.join(REFERENCE_TEST_DIR, "global_phylo.nh")
    vcf_path = os.path.join(REFERENCE_TEST_DIR, "global_samples.vcf")
    from usher_tpu_torch.io.newick import parse_newick as port_parse_newick
    from usher_tpu_torch.io.vcf import read_vcf as port_read_vcf
    trees = []
    # each side loads the same files with its own readers
    for parse, read, assign in (
            (parse_newick, read_vcf, jsankoff.assign_states_from_vcf),
            (port_parse_newick, port_read_vcf,
             lambda T, v: sankoff.assign_states_from_vcf(T, v, "cpu"))):
        T = parse(nh)
        _, vcf = read(T, vcf_path, create_new_mat=True)
        assign(T, vcf)
        trees.append(T)
    want, got = (_mutation_sets(T) for T in trees)
    assert sum(len(v) for v in want.values()) > 400
    assert got == want
    assert trees[1].get_parsimony_score() == trees[0].get_parsimony_score()


def test_empty_vcf_is_a_no_op():
    from usher_tpu_torch.io.newick import parse_newick_string
    from usher_tpu_torch.io.vcf import VcfData
    T = parse_newick_string("((L1,L2),L3);")
    sankoff.assign_states_from_vcf(T, VcfData(sample_ids=[], sites=[]), "cpu")
    assert all(not n.mutations for n in T.breadth_first_expansion())
