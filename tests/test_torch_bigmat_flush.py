"""usher_tpu_torch.core.bigmat: a flush of queued appends (one composed DFS
row map, then a fixed number of passes over the N-long arrays) against the
JAX package's BigMAT flushed one append at a time, its sequential path.

Randomized append streams go to both sides with the same slots; after each
flush every derived array must be equal: the tree (parent, level, DFS rows
and order, leaf counts, child keys), the aggregates (base, nc_base,
node_num_mut, F, is_leaf), the BFS ranks, the tombstones and the overlay.
Cases: split-heavy flushes, splits of nodes queued earlier in the same flush
(an X, a leaf, a child insert), repeated splits of one node, a split of a
parent's last child and of an earlier one, child inserts at nested targets
sharing a DFS boundary, 600 appends on a 20,000-node tree, and three flushes
in a row with placement scored between them.
"""

import numpy as np
import pytest

from usher_tpu.core.bigmat import BigMAT as JBigMAT
from usher_tpu_torch.core.bigmat import BigMAT

from test_bigmat_flush import NIBBLES, random_big

STATE = ("parent", "level", "dfs_of", "dfs_end_of", "dfs_order",
         "num_leaves", "child_key", "child_count", "base", "nc_base",
         "node_num_mut", "F", "is_leaf", "bfs_rank")


def _pair(seed, N=400, P=64):
    jb = random_big(np.random.default_rng(seed), N=N, P=P)
    assert isinstance(jb, JBigMAT)
    tb = BigMAT(jb.parent, jb.mut_ptr, jb.mut_col, jb.mut_par, jb.mut_mut,
                jb.positions, jb.ref, device="cpu")
    return tb, jb


class Appends:
    """Queues the same appends on the port's BigMAT and on the JAX one and
    keeps each node's own mutations, so a split moves some of them."""

    def __init__(self, tb, jb, rng):
        self.tb, self.jb, self.rng = tb, jb, rng
        self.muts = {}
        self.internal = [int(v) for v in np.nonzero(~tb.is_leaf)[0]]
        self.nodes = [v for v in range(tb.N) if tb.parent[v] != v]

    def own(self, u):
        if u not in self.muts:
            t = self.tb
            rows = range(int(t.mut_ptr[u]), int(t.mut_ptr[u + 1]))
            self.muts[u] = [(int(t.mut_col[j]), int(t.mut_par[j]),
                             int(t.mut_mut[j])) for j in rows]
        return self.muts[u]

    def fresh(self):
        k = int(self.rng.integers(0, 3))
        out = []
        for c in self.rng.choice(self.tb.P, size=k, replace=False):
            pv = int(self.tb.ref[c])
            mv = int(NIBBLES[(np.searchsorted(NIBBLES, pv) + 1) % 4])
            out.append((int(c), pv, mv))
        return out

    def child(self, u):
        muts = self.fresh()
        s = self.tb.queue_child_insert(int(u), muts)
        assert self.jb.queue_child_insert(int(u), muts) == s
        self.muts[s] = list(muts)
        self.nodes.append(s)
        return s

    def split(self, u):
        u = int(u)
        own = self.own(u)
        pick = set(self.rng.choice(len(own), size=int(
            self.rng.integers(0, len(own) + 1)), replace=False).tolist())
        common = [m for i, m in enumerate(own) if i in pick]
        l2 = self.fresh()
        self.muts[u] = [m for i, m in enumerate(own) if i not in pick]
        x, s = self.tb.queue_sibling_split(u, common, l2)
        assert self.jb.queue_sibling_split(u, common, l2) == (x, s)
        self.muts[x], self.muts[s] = common, l2
        self.internal.append(x)
        self.nodes += [x, s]
        return x, s

    def random(self, n_ops, split_share):
        for _ in range(n_ops):
            if self.rng.random() < split_share:
                self.split(self.rng.choice(self.nodes))
            else:
                self.child(self.rng.choice(self.internal))


def _flush_both(tb, jb):
    """The port flushes everything at once; the JAX side one append per
    flush."""
    before = {k: getattr(tb, k) for k in STATE[:-1]}
    copies = {k: v.copy() for k, v in before.items()}
    tb._flush()
    for p in list(jb._pending):
        jb._pending = [p]
        jb._flush()
    # the flush made new arrays: snapshots taken before it stay as they were
    for k, v in before.items():
        np.testing.assert_array_equal(v, copies[k], err_msg=k)


def _assert_same(tb, jb):
    assert (tb.N, tb.max_depth) == (jb.N, jb.max_depth)
    assert not tb._pending and not jb._pending
    for name in STATE:
        a, b = getattr(tb, name), getattr(jb, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (tb.csc_dead is None) == (jb.csc_dead is None)
    if tb.csc_dead is not None:
        np.testing.assert_array_equal(tb.csc_dead, jb.csc_dead)
    assert (tb._ov is None) == (jb._ov is None)
    if tb._ov is not None:
        for a, b in zip(tb._ov, jb._ov):
            np.testing.assert_array_equal(a, b)


def _last_child(big, last):
    """A non-root node with children whose DFS interval ends (or does not
    end) where its parent's does."""
    for v in range(1, big.N):
        p = int(big.parent[v])
        if p != v and (big.dfs_end_of[v] == big.dfs_end_of[p]) == last \
                and not big.is_leaf[v]:
            return v
    raise AssertionError("no such node")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_heavy_flush(seed):
    """64 appends, about 60% of them splits, as a --pb-direct batch
    queues them."""
    tb, jb = _pair(seed)
    Appends(tb, jb, np.random.default_rng(100 + seed)).random(64, 0.6)
    _flush_both(tb, jb)
    _assert_same(tb, jb)


@pytest.mark.parametrize("seed", [3, 4])
def test_splits_of_nodes_queued_in_the_same_flush(seed):
    """Splits of an X, of a split's leaf and of a child insert, each queued
    earlier in the same flush, and child inserts under a queued X and
    under nodes queued just before them in the same run of inserts."""
    tb, jb = _pair(seed)
    rng = np.random.default_rng(200 + seed)
    a = Appends(tb, jb, rng)
    a.random(6, 0.5)
    x, s = a.split(rng.choice(a.nodes[:tb.N - 1]))
    a.child(x)
    a.split(x)
    a.random(4, 0.5)
    a.split(s)
    c = a.child(rng.choice(a.internal))
    a.child(a.child(c))
    a.split(c)
    x2, _ = a.split(c)
    a.child(x2)
    a.random(6, 0.5)
    _flush_both(tb, jb)
    _assert_same(tb, jb)


@pytest.mark.parametrize("seed", [5, 6])
def test_repeated_splits_of_one_node(seed):
    """One node split four times in a flush (each X lands between the last
    one and the node), with inserts under the X's and the parent."""
    tb, jb = _pair(seed)
    rng = np.random.default_rng(300 + seed)
    a = Appends(tb, jb, rng)
    u = int(rng.choice(a.internal[1:]))
    pold = int(tb.parent[u])
    for _ in range(4):
        x, _ = a.split(u)
        a.child(x)
        a.child(pold)
        a.random(2, 0.6)
    _flush_both(tb, jb)
    _assert_same(tb, jb)


@pytest.mark.parametrize("last", [True, False])
def test_split_of_last_and_earlier_child(last):
    """A split whose target is its parent's last child (no rotation) and
    one whose target has later siblings (its block rotates past them)."""
    tb, jb = _pair(7)
    rng = np.random.default_rng(400)
    a = Appends(tb, jb, rng)
    u = _last_child(tb, last)
    assert (tb.dfs_end_of[u] == tb.dfs_end_of[tb.parent[u]]) == last
    a.random(5, 0.5)
    a.split(u)
    a.child(u)
    a.split(u)
    a.random(5, 0.5)
    _flush_both(tb, jb)
    _assert_same(tb, jb)


@pytest.mark.parametrize("seed", [8, 9])
def test_nested_child_inserts_sharing_a_boundary(seed):
    """Child inserts under a chain of three nodes whose intervals end at
    the same row, in random order: the deeper target's rows come first."""
    tb, jb = _pair(seed)
    rng = np.random.default_rng(500 + seed)
    a = Appends(tb, jb, rng)
    end = tb.dfs_end_of
    chains = [(int(tb.parent[tb.parent[c]]), int(tb.parent[c]), c)
              for c in a.internal
              if end[c] == end[tb.parent[c]] == end[tb.parent[tb.parent[c]]]
              and tb.parent[c] != c and tb.parent[tb.parent[c]] !=
              tb.parent[c]]
    assert chains
    chain = chains[int(rng.integers(len(chains)))]
    for t in rng.choice(chain, size=12):
        a.child(t)
    a.split(chain[2])
    for t in rng.choice(chain, size=6):
        a.child(t)
    _flush_both(tb, jb)
    _assert_same(tb, jb)


def test_600_appends_on_20000_nodes():
    tb, jb = _pair(10, N=20000, P=256)
    Appends(tb, jb, np.random.default_rng(600)).random(600, 0.6)
    _flush_both(tb, jb)
    _assert_same(tb, jb)


@pytest.mark.parametrize("seed", [11, 12])
def test_three_flushes_with_placement_between(seed):
    """Three flushes in a row; the port's flushes happen inside
    place_arrays, as on the --pb-direct path, and its placements equal
    JAX's after each."""
    tb, jb = _pair(seed, N=300, P=48)
    rng = np.random.default_rng(700 + seed)
    a = Appends(tb, jb, rng)
    B, K = 6, 5
    for _ in range(3):
        a.random(40, 0.6)
        for p in list(jb._pending):
            jb._pending = [p]
            jb._flush()
        pos = rng.integers(0, tb.P + 3, size=(B, K)).astype(np.int32)
        gval = NIBBLES[rng.integers(0, 4, size=(B, K))]
        kmiss = rng.random((B, K)) < 0.1
        got = tb.place_arrays(pos, gval, kmiss, with_second=True)
        want = jb.place_arrays(pos, gval, kmiss, with_second=True)
        for g, w in zip(got, want):
            for gg, ww in zip(g, w):
                np.testing.assert_array_equal(np.asarray(gg),
                                              np.asarray(ww))
        _assert_same(tb, jb)
