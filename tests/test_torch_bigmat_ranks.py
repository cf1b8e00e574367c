"""usher_tpu_torch.core.bigmat: BigMAT's BFS tie-break ranks
(`_recompute_ranks`: one stable sort of the levels in DFS order) against
the per-level sweep that computed them before, bit for bit.

The oracle sorts each level by (parent's rank, child key), level after
level; a literal breadth-first walk over the children lists in child-key
order (the host tree's breadth_first_expansion) checks the oracle in turn.
Both orders the BigMAT keeps are compared: `bfs_rank` by slot and the
DFS-ordered copy the scoring metadata (`_dfs_meta`) uploads.  Cases: a
star; a chain of 40,000 nodes, deeper than 2**15, so the levels sort as
int32; a caterpillar 1,200 levels deep, so they sort as int16 (the others
sort as uint8); random recursive trees with shuffled slots; such trees
after several flushes of child inserts and sibling splits, splits of nodes
queued in the same flush among them; the fixture's pb through
`pb_arrays.to_bigmat`, before and after a flush.
"""

import os

import numpy as np
import pytest

from usher_tpu_torch.cli.usher_cli import main as torch_main
from usher_tpu_torch.core.bigmat import BigMAT
from usher_tpu_torch.io import pb_arrays as pa

from conftest import REFERENCE_TEST_DIR


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("USHER_TPU_PLATFORM", "cpu")


def sweep_ranks(big):
    """The level sweep: each level sorted by (parent's rank, child key)."""
    level = big.level
    order = np.argsort(level, kind="stable")
    bounds = np.searchsorted(level[order], np.arange(int(level.max()) + 2))
    rank = np.zeros(big.N, dtype=np.int64)
    start = 0
    for li in range(len(bounds) - 1):
        idx = order[bounds[li]:bounds[li + 1]]
        if len(idx) == 0:
            continue
        if li == 0:
            rank[idx] = np.arange(len(idx))
        else:
            o2 = np.lexsort((big.child_key[idx], rank[big.parent[idx]]))
            rank[idx[o2]] = start + np.arange(len(idx))
        start += len(idx)
    return rank.astype(np.int32)


def walk_ranks(big):
    """Breadth first from the root over children in child-key order."""
    parent = big.parent.tolist()
    kids = [[] for _ in range(big.N)]
    for v, p in enumerate(parent):
        if p != v:
            kids[p].append(v)
    key = big.child_key.tolist()
    order = [next(v for v, p in enumerate(parent) if p == v)]
    i = 0
    while i < len(order):
        order.extend(sorted(kids[order[i]], key=key.__getitem__))
        i += 1
    rank = np.empty(big.N, np.int32)
    rank[order] = np.arange(big.N, dtype=np.int32)
    return rank


def _big(parent):
    N = len(parent)
    return BigMAT(np.asarray(parent, np.int32), np.zeros(N + 1, np.int64),
                  np.zeros(0, np.int32), np.zeros(0, np.uint8),
                  np.zeros(0, np.uint8), np.arange(4, dtype=np.int64),
                  np.array([1, 2, 4, 8], np.uint8), device="cpu")


def _shuffled(parent, rng):
    """The same tree with its slots relabelled at random (any slot order is
    allowed; children keep slot order)."""
    perm = rng.permutation(len(parent)).astype(np.int32)
    out = np.empty(len(parent), np.int32)
    out[perm] = perm[parent]
    return out


def _recursive(N, rng):
    parent = np.zeros(N, np.int32)
    parent[1:] = (rng.random(N - 1) * np.arange(1, N)).astype(np.int32)
    return parent


def _appends(big, rng, n_ops):
    """Queue n_ops random child inserts and sibling splits (no mutations),
    about half splits, some of them of nodes queued earlier in the same
    flush: a child insert and an X."""
    nodes = [v for v in range(big.N) if big.parent[v] != v]
    queued = []
    for k in range(n_ops):
        if k % 7 == 3 and queued:
            u = queued[int(rng.integers(len(queued)))]
            x, s = big.queue_sibling_split(u, [], [])
            queued += [x, s]
        elif rng.random() < 0.5:
            x, s = big.queue_sibling_split(
                nodes[int(rng.integers(len(nodes)))], [], [])
            queued += [x, s]
        else:
            u = (queued + nodes)[int(rng.integers(len(queued) + len(nodes)))]
            queued.append(big.queue_child_insert(u, []))


def _star():
    parent = np.zeros(5000, np.int32)
    yield _big(_shuffled(parent, np.random.default_rng(1)))


def _chain():
    N = 40_000
    parent = np.arange(-1, N - 1, dtype=np.int32)
    parent[0] = 0
    # the constructor's level walk makes one pass of N per level; a chain's
    # levels are its slots
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(BigMAT, "_levels",
                   lambda self: np.arange(self.N, dtype=np.int32))
        big = _big(parent)
    assert big.max_depth >= 1 << 15
    yield big
    for u in (N - 2, N // 2, 5):
        big.queue_child_insert(u, [])
    big.queue_sibling_split(N - 1, [], [])
    big.queue_sibling_split(N // 3, [], [])
    big.queue_child_insert(N + 3, [])        # under the X of N - 1
    big._flush()
    assert big.max_depth >= 1 << 15
    yield big


def _caterpillar():
    """A spine of 1,200 nodes with a leaf off each, slots shuffled."""
    spine = 1200
    parent = np.zeros(2 * spine, np.int32)
    parent[1:spine] = np.arange(spine - 1)
    parent[spine:] = np.arange(spine)
    rng = np.random.default_rng(5)
    big = _big(_shuffled(parent, rng))
    assert 1 << 8 < big.max_depth <= 1 << 15
    yield big
    _appends(big, rng, 64)
    big._flush()
    yield big


def _random(N, seed):
    yield _big(_shuffled(_recursive(N, np.random.default_rng(seed)),
                         np.random.default_rng(seed + 1)))


def _flushes(seed):
    rng = np.random.default_rng(seed)
    big = _big(_shuffled(_recursive(2000, rng), rng))
    yield big
    for _ in range(5):
        _appends(big, rng, 64)
        big._flush()
        yield big


@pytest.fixture(scope="module")
def fixture_pb(tmp_path_factory):
    """The Quick Start fixture's MAT as a pb (the port's CLI builds it)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USHER_TPU_PLATFORM", "cpu")
        outdir = str(tmp_path_factory.mktemp("ranks_build"))
        pb = os.path.join(outdir, "out.pb")
        assert torch_main([
            "-t", os.path.join(REFERENCE_TEST_DIR, "global_phylo.nh"),
            "-v", os.path.join(REFERENCE_TEST_DIR, "global_samples.vcf"),
            "-o", pb, "-d", outdir]) == 0
    return pb


def _pb(path):
    big = pa.load_mat_arrays(path).to_bigmat(device="cpu")
    assert not big._ranks_dirty
    yield big
    _appends(big, np.random.default_rng(9), 40)
    big._flush()
    yield big


@pytest.mark.parametrize("case", [
    "star", "chain", "caterpillar", "random_1000", "random_20000",
    "flushes_0", "flushes_1", "flushes_2", "fixture_pb"])
def test_ranks_equal_the_level_sweep(case, request):
    if case == "fixture_pb":
        states = _pb(request.getfixturevalue("fixture_pb"))
    elif case == "chain":
        states = _chain()
    elif case == "star":
        states = _star()
    elif case == "caterpillar":
        states = _caterpillar()
    else:
        kind, n = case.split("_")
        states = (_random(int(n), int(n)) if kind == "random"
                  else _flushes(int(n)))
    seen = 0
    for big in states:
        big._ranks_dirty = True
        want = sweep_ranks(big)
        np.testing.assert_array_equal(walk_ranks(big), want)
        got = big.bfs_rank
        assert got.dtype == np.int32 and not big._ranks_dirty
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            big._dfs_meta(spr=False)["bfs_rank"].numpy(),
            want[big.dfs_order])
        seen += 1
    assert seen == {"star": 1, "chain": 2, "caterpillar": 2,
                    "fixture_pb": 2}.get(
        case, 6 if case.startswith("flushes") else 1)
