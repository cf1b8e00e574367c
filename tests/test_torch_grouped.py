"""The shared-ancestry grouped engine (X6) of the port against the JAX
package's, on the CPU.

``BigMAT.group_ancestral_batch`` (numpy, copied) must give the JAX arrays,
and ``BigMAT.place_arrays_grouped`` (ops/interval.interval_place_flatgrp_dev
as torch ops) the JAX package's results and the port's own plain
``place_arrays`` on the reconstructed full entry sets, with tolerance 0:
every score is an integer count.  The cases are tests/test_bigmat.py's
(5 seeds x min_group in {2, 6, 10,000}, gcap 3, random MATs with back
mutations), with and without the runner-up.  The three batches on which
the JAX engine raises ValueError (its callers fall back on it) raise in
the port too.
"""

import numpy as np
import pytest
import torch

from usher_tpu.core.bigmat import BigMAT as JBigMAT
from usher_tpu.matutils.arrays import _ancestral_set_triplets
from usher_tpu_torch.core import bigmat as bm
from usher_tpu_torch.core.bigmat import BigMAT
from usher_tpu_torch.ops import interval as tiv

from test_placement import random_mat
from test_torch_hostlayers import port_tree

SEEDS = list(range(5))
MIN_GROUPS = [2, 6, 10_000]


def _pair(seed):
    """The JAX and port BigMATs of tests/test_bigmat.py's random MAT, and
    its 40 leaf slots drawn with replacement."""
    rng = np.random.default_rng(seed + 400)
    T, ref = random_mat(rng, n_leaves=60, n_positions=20, mut_rate=0.9)
    positions = np.array(sorted(ref), dtype=np.int64)
    refarr = np.array([ref[p] for p in positions.tolist()], dtype=np.uint8)
    jb = JBigMAT.from_tree(T, positions, refarr)
    tb = BigMAT.from_tree(port_tree(T), positions, refarr, device="cpu")
    leaf_slots = np.nonzero(jb.is_leaf)[0]
    slots = rng.choice(leaf_slots, size=40, replace=True).tolist()
    return jb, tb, slots


def _full_sets(big, slots):
    """The plain inputs: each slot's whole ancestral entry set."""
    full = [_ancestral_set_triplets(big, s) for s in slots]
    K = max((len(f) for f in full), default=0) or 1
    B = len(slots)
    pos = np.full((B, K), big.P, np.int32)
    gval = np.zeros((B, K), np.uint8)
    for i, f in enumerate(full):
        for k, (c, v) in enumerate(f):
            pos[i, k] = c
            gval[i, k] = v
    return pos, gval, np.zeros((B, K), bool)


def _tuples(res, with_second):
    return list(res) if with_second else [res]


def _eq(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("min_group", MIN_GROUPS)
def test_group_ancestral_batch_matches_jax(seed, min_group):
    """The anchor forest, signed residuals, group rows, closure and the
    sample -> anchor map are the JAX package's, array for array."""
    jb, tb, slots = _pair(seed)
    _eq(tb.group_ancestral_batch(slots, min_group=min_group, gcap=3),
        jb.group_ancestral_batch(slots, min_group=min_group, gcap=3))


@pytest.mark.parametrize("with_second", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("min_group", MIN_GROUPS)
def test_place_arrays_grouped_matches_jax_and_plain(seed, min_group,
                                                    with_second):
    """X6 == the JAX grouped engine == the port's X5 on the full sets, in
    all four outputs (and the runner-up's four)."""
    jb, tb, slots = _pair(seed)
    grouped = tb.group_ancestral_batch(slots, min_group=min_group, gcap=3)
    got = tb.place_arrays_grouped(*grouped, with_second=with_second)
    want = jb.place_arrays_grouped(*grouped, with_second=with_second)
    plain = tb.place_arrays(*_full_sets(tb, slots), with_second=with_second)
    for g, w, p in zip(_tuples(got, with_second), _tuples(want, with_second),
                       _tuples(plain, with_second)):
        _eq(g, w)
        _eq(g, p)


def _star(n_leaves):
    """A root with n_leaves children, each carrying one mutation at column
    0: the column's occupancy is n_leaves."""
    N = n_leaves + 1
    parent = np.zeros(N, np.int32)
    mut_ptr = np.concatenate([[0, 0], np.arange(1, N)]).astype(np.int64)
    mut_col = np.zeros(n_leaves, np.int32)
    mut_par = np.full(n_leaves, 1, np.uint8)
    mut_mut = np.where(np.arange(n_leaves) % 2 == 0, 2, 4).astype(np.uint8)
    positions = np.array([100, 200], np.int64)
    ref = np.array([1, 8], np.uint8)
    args = (parent, mut_ptr, mut_col, mut_par, mut_mut, positions, ref)
    return JBigMAT(*args), BigMAT(*args, device="cpu")


@pytest.mark.parametrize("case", ["occupancy", "overlay", "mesh"])
def test_grouped_raises_where_jax_does(case):
    """The batches on which the JAX engine raises ValueError, so that
    matutils/arrays.find_epps takes place_arrays, raise it in the port
    (and on the same batches: occupancy 6,216 scores, 6,217 raises)."""
    if case == "occupancy":
        for n, raises in ((bm.GROUPED_MAX_OCCUPANCY, False),
                          (bm.GROUPED_MAX_OCCUPANCY + 1, True)):
            jb, tb = _star(n)
            grouped = tb.group_ancestral_batch([1, 2, 3])
            _eq(grouped, jb.group_ancestral_batch([1, 2, 3]))
            if raises:
                for big in (jb, tb):
                    with pytest.raises(ValueError, match="occupancy"):
                        big.place_arrays_grouped(*grouped)
            else:
                _eq(tb.place_arrays_grouped(*grouped),
                    jb.place_arrays_grouped(*grouped))
        return
    jb, tb, slots = _pair(0)
    grouped = tb.group_ancestral_batch(slots)
    if case == "overlay":
        for big in (jb, tb):
            internal = int(np.nonzero(~big.is_leaf)[0][0])
            rv = int(big.ref[0])
            big.queue_child_insert(internal, [(0, rv, 1 if rv != 1 else 2)])
            with pytest.raises(ValueError, match="overlay-free"):
                big.place_arrays_grouped(*grouped)
    else:
        import jax
        from jax.sharding import Mesh as JMesh
        from usher_tpu_torch.parallel.shard import batch_mesh
        jb.mesh = JMesh(np.array(jax.devices()[:2]), ("batch",))
        tb.mesh = batch_mesh(2, device="cpu")
        for big in (jb, tb):
            with pytest.raises(ValueError, match="mesh"):
                big.place_arrays_grouped(*grouped)


def test_closure_combine_is_exact_or_raises():
    """The float32 closure product equals the integer one below 2^24 and
    raises past it rather than round."""
    rng = np.random.default_rng(3)
    x = rng.integers(-3000, 3000, size=(50, 7)).astype(np.int32)
    M = (rng.random((7, 11)) < 0.5).astype(np.float32)
    got = tiv._closure_combine(torch.from_numpy(x), torch.from_numpy(M))
    np.testing.assert_array_equal(got.numpy(),
                                  x.astype(np.int64) @ M.astype(np.int64))
    x[4, :] = (1 << 24) // 7 + 1
    with pytest.raises(OverflowError):
        tiv._closure_combine(torch.from_numpy(x), torch.from_numpy(M))
