"""usher_tpu_torch.ops.placement (the dense plain path) against the JAX
usher_tpu.ops.placement on the same numpy inputs: random MATs with
ambiguous and missing entries, and forced ties for the tie-break and the
argmax.  Tolerance: none (integer arithmetic)."""

import numpy as np
import pytest
import torch

from usher_tpu.core.flat import FlatMAT as JFlatMAT
from usher_tpu.ops import placement as jdev
from usher_tpu_torch.core.flat import FlatMAT
from usher_tpu_torch.ops import placement as dev

from test_placement import random_mat, random_sample
from test_torch_hostlayers import port_tree


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _case(seed, n_leaves=20, n_samples=5):
    rng = np.random.default_rng(seed)
    T, ref = random_mat(rng, n_leaves=n_leaves)
    positions = np.array(sorted(ref), dtype=np.int64)
    refarr = np.array([ref[p] for p in positions.tolist()], dtype=np.uint8)
    jflat = JFlatMAT(T, positions, refarr, "c")
    flat = FlatMAT(port_tree(T), positions, refarr, "c")
    samples = [random_sample(rng, ref) for _ in range(n_samples)]
    return jflat, flat, samples


@pytest.mark.parametrize("seed", list(range(4)))
def test_score_batch_and_outputs_match_jax(seed):
    jflat, flat, samples = _case(seed)
    st_j, par_j = jflat.sync()
    meta = jflat.order_arrays()
    g, E, miss = jflat.encode_samples(samples)
    want = [np.asarray(x) for x in jdev.score_batch(
        st_j, par_j, jflat.root_slot, np.asarray(jflat.ref), meta["active"],
        g, E, miss)]
    st, parent = flat.sync()
    got = dev.score_batch(st, parent, flat.root_slot, flat.ref_dev,
                          _t(meta["active"]), _t(g), _t(E), _t(miss))
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), b)
    # validity on numpy (host use) and on tensors (device use) alike
    want_v = jdev.placement_outputs(*want, meta["is_root_mask"],
                                    meta["is_leaf"], meta["active"])
    got_v = dev.valid_mask(*got, _t(meta["is_root_mask"]),
                           _t(meta["is_leaf"]), _t(meta["active"]))
    got_np = dev.placement_outputs(*(x.numpy() for x in got),
                                   meta["is_root_mask"], meta["is_leaf"],
                                   meta["active"])
    for a, c, b in zip(got_v, got_np, want_v):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(c, np.asarray(b))


@pytest.mark.parametrize("seed", list(range(4)))
def test_placement_step_matches_jax(seed):
    jflat, flat, samples = _case(seed + 100, n_leaves=30, n_samples=8)
    st_j, par_j = jflat.sync()
    meta = jflat.order_arrays()
    g, E, miss = jflat.encode_samples(samples)
    keys = ("active", "is_leaf", "is_root_mask", "num_leaves", "bfs_rank")
    want = jdev.placement_step(st_j, par_j, jflat.root_slot,
                               np.asarray(jflat.ref),
                               *(meta[k] for k in keys), g, E, miss)
    st, parent = flat.sync()
    got = dev.placement_step(st, parent, flat.root_slot, flat.ref_dev,
                             *(_t(meta[k]) for k in keys), _t(g), _t(E),
                             _t(miss))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("seed", list(range(4)))
def test_reduce_best_forced_ties_match_jax(seed):
    """Few distinct scores, leaf counts and ranks force ties at every stage
    of the tie-break, including duplicate ranks, where both argmax
    implementations must pick the first maximal row."""
    rng = np.random.default_rng(seed)
    B, n = 16, 40
    score = rng.integers(0, 3, size=(B, n)).astype(np.int32)
    valid = rng.random((B, n)) < 0.7
    valid[:, 0] = True
    valid[-1] = False                      # a sample with no valid node
    leaves = rng.integers(1, 3, size=n).astype(np.int32)
    for rank in (rng.permutation(n).astype(np.int32),
                 rng.integers(0, 4, size=n).astype(np.int32)):
        want = jdev.reduce_best(score, valid, leaves, rank)
        got = dev.reduce_best(_t(score), _t(valid), _t(leaves), _t(rank))
        for a, b in zip(got, want):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_chunked_batch_matches_unchunked(monkeypatch):
    """Chunking over B (bounded [Bc, N, P] intermediates) changes nothing."""
    jflat, flat, samples = _case(7, n_samples=9)
    st, parent = flat.sync()
    meta = flat.order_arrays()
    g, E, miss = flat.encode_samples(samples)
    args = (st, parent, flat.root_slot, flat.ref_dev, _t(meta["active"]),
            _t(g), _t(E), _t(miss))
    whole = dev.score_batch(*args)
    monkeypatch.setattr(dev, "CHUNK_ELEMS", st.numel() * 2)  # Bc = 2
    chunked = dev.score_batch(*args)
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
