"""The segment-query placement engine X9 of the port
(usher_tpu_torch/ops/interval.py::interval_place_seg_dev, reached through
BigMAT.place_arrays under USHER_TPU_SEG) against the port's X5 and the JAX
package's X9, on the CPU.

The cases are tests/test_interval_seg.py's: chain-consistent random MATs
(test_direct_exact.consistent_mat), batches with padding, ambiguous and
missing entries, incremental-append overlays and degenerate batches, with
and without the runner-up.  Each side gets its own MatArrays and BigMAT
built from the same numpy arrays and sees the same appends.  Every output
field must be equal, tolerance 0 (integer scores, rows and counts).
"""

import numpy as np
import pytest

from usher_tpu_torch.io import pb_arrays as tpa
from usher_tpu_torch.ops import interval as tiv

from test_direct_exact import consistent_mat
from test_interval_seg import NIBBLES, _batch

FIELDS = ("parent", "names_blob", "name_off", "blen", "mut_ptr", "mut_col",
          "mut_par", "mut_mut", "positions", "ref", "chrom")


def _mats(rng, N, P):
    """The JAX and the port BigMAT of one consistent_mat draw."""
    ma, _state, _ = consistent_mat(rng, N=N, P=P, n_mut=2)
    tma = tpa.MatArrays(**{f: getattr(ma, f) for f in FIELDS})
    return ma.to_bigmat(), tma.to_bigmat(device="cpu")


def _place(big, monkeypatch, seg, pos, gval, kmiss, second):
    """place_arrays with USHER_TPU_SEG set or not; on the port's BigMAT
    the X9 calls are counted, and there must be one exactly when it is
    set."""
    calls = []
    seg_dev = tiv.interval_place_seg_dev

    def spy(*a, **kw):
        calls.append(1)
        return seg_dev(*a, **kw)
    monkeypatch.setattr(tiv, "interval_place_seg_dev", spy)
    monkeypatch.setenv("USHER_TPU_SEG", "1" if seg else "0")
    out = big.place_arrays(pos, gval, kmiss, with_second=second)
    monkeypatch.setattr(tiv, "interval_place_seg_dev", seg_dev)
    if big.__class__.__module__.startswith("usher_tpu_torch"):
        assert len(calls) == int(seg)
    return out if second else (out,)


def _eq(got, want, what):
    assert len(got) == len(want)
    for t, (ta, tb) in enumerate(zip(got, want)):
        assert len(ta) == len(tb) == 4
        for f, (x, y) in enumerate(zip(ta, tb)):
            x, y = np.asarray(x), np.asarray(y)
            assert x.shape == y.shape, (what, t, f)
            np.testing.assert_array_equal(x, y,
                                          err_msg=f"{what} {t} field {f}")


def _check(jb, tb, monkeypatch, pos, gval, kmiss):
    """Port X9 == port X5 == JAX X9, with and without the runner-up."""
    for second in (False, True):
        x9 = _place(tb, monkeypatch, True, pos, gval, kmiss, second)
        x5 = _place(tb, monkeypatch, False, pos, gval, kmiss, second)
        jx9 = _place(jb, monkeypatch, True, pos, gval, kmiss, second)
        _eq(x9, x5, "X9 vs X5")
        _eq(x9, jx9, "X9 vs JAX X9")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seg_equals_full(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    jb, tb = _mats(rng, 4000, 600)
    pos, gval, kmiss = _batch(rng, tb, B=48, K=10)
    _check(jb, tb, monkeypatch, pos, gval, kmiss)


def _append(rng, big, plan):
    """Apply tests/test_interval_seg.py's appends (child inserts and
    sibling splits) as planned by ``plan`` (drawn once, replayed on each
    side)."""
    internals = np.nonzero(~big.is_leaf)[0]
    for t, (ui, c) in enumerate(plan):
        u = int(internals[ui])
        alt = int(NIBBLES[(np.searchsorted(NIBBLES, big.ref[c]) + 1) % 4])
        if t % 2 == 0:
            big.queue_child_insert(u, [(c, int(big.ref[c]), alt)])
        else:
            lo, hi = int(big.mut_ptr[u]), int(big.mut_ptr[u + 1])
            if hi == lo or int(big.parent[u]) == u:
                big.queue_child_insert(u, [(c, int(big.ref[c]), alt)])
            else:
                common = [(int(big.mut_col[lo]), int(big.mut_par[lo]),
                           int(big.mut_mut[lo]))]
                big.queue_sibling_split(u, common,
                                        [(c, int(big.ref[c]), alt)])
        big._flush()


@pytest.mark.parametrize("seed", [10, 11])
def test_seg_equals_full_with_overlay(seed, monkeypatch):
    """After incremental appends the engines still agree (the overlay
    events reach X9 as per-sample padded arrays)."""
    rng = np.random.default_rng(seed)
    jb, tb = _mats(rng, 3000, 500)
    n_int = int((~tb.is_leaf).sum())
    plan = [(int(rng.integers(1, n_int)), int(rng.integers(0, tb.P)))
            for _ in range(6)]
    _append(rng, jb, plan)
    _append(rng, tb, plan)
    assert tb.N == jb.N and tb._ov is not None
    pos, gval, kmiss = _batch(rng, tb, B=32, K=8)
    _check(jb, tb, monkeypatch, pos, gval, kmiss)


def test_seg_empty_and_degenerate(monkeypatch):
    """All-padding samples and single-entry samples resolve identically."""
    rng = np.random.default_rng(77)
    jb, tb = _mats(rng, 1000, 200)
    B, K = 8, 6
    pos = np.full((B, K), tb.P, np.int32)
    gval = np.zeros((B, K), np.uint8)
    kmiss = np.zeros((B, K), bool)
    pos[1, 0] = 5
    gval[1, 0] = NIBBLES[(np.searchsorted(NIBBLES, tb.ref[5]) + 1) % 4]
    pos[2, 0] = 5
    gval[2, 0] = tb.ref[5]          # ref-state entry
    kmiss[3, 0] = True
    pos[3, 0] = 9
    _check(jb, tb, monkeypatch, pos, gval, kmiss)


def test_seg_one_sample_and_duplicates(monkeypatch):
    """A batch of one sample (no dedup pass) and a batch of exact
    duplicates (scored once and fanned out) take X9 too."""
    rng = np.random.default_rng(5)
    jb, tb = _mats(rng, 800, 120)
    pos, gval, kmiss = _batch(rng, tb, B=4, K=6)
    _check(jb, tb, monkeypatch, pos[:1], gval[:1], kmiss[:1])
    dup = np.repeat(np.arange(4), 3)
    _check(jb, tb, monkeypatch, pos[dup], gval[dup], kmiss[dup])


def test_pad_overlay_by_sample_groups_rows():
    """Per-sample overlay arrays: a sample's events in stream order, row
    n_pad and value 0 past its count, width the largest count."""
    idx = np.array([7, 3, 9, 1, 4], np.int32)
    b = np.array([2, 0, 2, 2, 0], np.int32)
    val = np.array([1, -1, 2, 3, -2], np.int32)
    rows, vals = tiv.pad_overlay_by_sample(idx, b, val, 4, 50)
    assert rows.tolist() == [[3, 4, 50], [50, 50, 50], [7, 9, 1],
                             [50, 50, 50]]
    assert vals.tolist() == [[-1, -2, 0], [0, 0, 0], [1, 2, 3], [0, 0, 0]]
    rows, vals = tiv.pad_overlay_by_sample(idx[:0], b[:0], val[:0], 3, 50)
    assert rows.shape == vals.shape == (3, 0)
