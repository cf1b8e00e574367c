"""The port's EPP counts (usher_tpu_torch/optimize/epp.py, X12) against the
JAX package's, on the CPU: the [B, N] tie matrix on the same host arrays,
and count_epps' branch lengths and `epps_dump` byte for byte."""

import numpy as np
import pytest

from usher_tpu.io.newick import write_newick as jnwk
from usher_tpu.optimize import epp as jepp
from usher_tpu_torch.io.newick import write_newick as tnwk
from usher_tpu_torch.optimize import epp as tepp

from test_torch_fitch import nine_node_tree, random_opt_tree
from test_torch_hostlayers import port_tree
from test_torch_spr import finders


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("USHER_TPU_PLATFORM", "cpu")


@pytest.mark.parametrize("radius", [2, 6])
def test_tie_matrix_matches_jax(radius):
    import jax.numpy as jnp
    import torch
    jf, tf = finders(random_opt_tree(13, n=80))
    idxs = list(range(1, tf.n))
    g, oldcost, src = tf._chunk_inputs(idxs)
    oldcost = oldcost.astype(np.int32)
    want = np.asarray(jepp._tie_matrix(
        jf.st, jf.stp, jf.ref, jf.active, jnp.asarray(g),
        jnp.asarray(oldcost), jf.dfs_idx_dev, jf.level_dev,
        *(jnp.asarray(a) for a in src), jnp.int32(radius), src[0].shape[1]))
    t = tf.tree_on(tf.device)
    got = tepp._tie_matrix(
        t["st"], t["stp"], t["ref"], t["active"], torch.from_numpy(g),
        torch.from_numpy(oldcost), t["dfs_idx"], t["level"],
        *(torch.from_numpy(a) for a in src), radius).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any()


@pytest.mark.parametrize("tree,radius", [("random", 4), ("random", -1),
                                         ("nine", 3)])
def test_count_epps_matches_jax(tree, radius, tmp_path):
    T = random_opt_tree(14, n=90) if tree == "random" else nine_node_tree()
    P = port_tree(T)
    jdump, tdump = tmp_path / "j_dump", tmp_path / "t_dump"
    jepp.count_epps(T, radius, dump_path=str(jdump))
    tepp.count_epps(P, radius, dump_path=str(tdump), device="cpu")
    kw = dict(print_internal=True, print_branch_len=True,
              use_stored_branch_len=True)
    assert tnwk(P, **kw) == jnwk(T, **kw)
    assert tdump.read_bytes() == jdump.read_bytes()
    if tree == "random":
        assert tdump.read_bytes()
