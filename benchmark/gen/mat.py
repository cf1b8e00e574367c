"""Synthetic chain-consistent mutation-annotated trees, in numpy.

A random recursive tree (node i hangs under a uniform node before it), put
in DFS preorder with children in the order they were drawn, and on every
non-root node a number of branch mutations at distinct random sites, drawn
from the configuration's histogram (weights by count, from 0 up).
Each mutation's parent allele is the path state above it (the allele of the
nearest ancestor mutation at that site, else the reference), and its new
allele another base, so the chains are consistent.

Frozen numpy copy of `chip_smoke.py::synth_bigmat` / `chain_bigmat` at
commit f18dcaca4b2a (the recipe of the port's pandemic BigMAT), with the
DFS intervals worked out here instead of by the port's BigMAT, so that no
per-node Python loop runs at a million nodes, and a count of mutations drawn
for each branch where those draw a fixed one.
"""

from __future__ import annotations

import numpy as np

NIBBLES = np.array([1, 2, 4, 8], np.uint8)      # A, C, G, T one-hot


def _depths(parent: np.ndarray) -> np.ndarray:
    """Depth of every node of a parent array (root -> itself) by pointer
    doubling."""
    n = len(parent)
    depth = (parent != np.arange(n)).astype(np.int64)
    up = parent.astype(np.int64)
    while True:
        nd = depth + depth[up]
        nup = up[up]
        if np.array_equal(nup, up):
            return depth
        depth, up = nd, nup


def preorder(parent: np.ndarray) -> np.ndarray:
    """Preorder index of every node of `parent` (parents before children,
    root 0), children visited in increasing index order."""
    n = len(parent)
    depth = _depths(parent)
    order = np.argsort(depth, kind="stable")
    bounds = np.searchsorted(depth[order], np.arange(depth.max() + 2))
    size = np.ones(n, np.int64)
    for d in range(int(depth.max()), 0, -1):
        idx = order[bounds[d]:bounds[d + 1]]
        size += np.bincount(parent[idx], weights=size[idx],
                            minlength=n).astype(np.int64)
    # children grouped by parent, in index order; offset of each child in
    # its parent's span = sizes of the siblings before it
    kids = np.arange(1, n)
    kids = kids[np.argsort(parent[1:], kind="stable")]
    ks = size[kids]
    cum = np.cumsum(ks) - ks
    first = np.r_[True, parent[kids][1:] != parent[kids][:-1]]
    start = np.maximum.accumulate(np.where(first, np.arange(len(kids)), 0))
    off = np.zeros(n, np.int64)
    off[kids] = cum - cum[start]
    tin = np.zeros(n, np.int64)
    for d in range(1, int(depth.max()) + 1):
        idx = order[bounds[d]:bounds[d + 1]]
        tin[idx] = tin[parent[idx]] + 1 + off[idx]
    return tin


def branch_counts(rng, n: int, weights) -> np.ndarray:
    """Mutations on each node's branch: 0 on the root, and on every other
    node a count drawn with `weights[k]` for k mutations."""
    w = np.asarray(weights, np.float64)
    counts = np.zeros(n, np.int64)
    counts[1:] = rng.choice(len(w), size=n - 1, p=w / w.sum())
    return counts


def chain_mutations(rng, parent: np.ndarray, size: np.ndarray, n_sites: int,
                    counts: np.ndarray, ref: np.ndarray):
    """counts[v] chain-consistent mutations at distinct random sites on
    each node v of a preorder tree.  Returns the CSR (mut_ptr [N+1],
    mut_col, mut_par, mut_mut), each node's mutations sorted by site."""
    n = len(parent)
    node = np.repeat(np.arange(n), counts)
    m = len(node)
    col = rng.integers(0, n_sites, size=m)
    while True:
        order = np.lexsort((col, node))
        ns, cs = node[order], col[order]
        dup = np.r_[False, (ns[1:] == ns[:-1]) & (cs[1:] == cs[:-1])]
        if not dup.any():
            break
        col[order[dup]] = rng.integers(0, n_sites, size=int(dup.sum()))
    mut_col = col[np.lexsort((col, node))].astype(np.int32)
    shift = rng.integers(1, 4, size=m)
    d = node.astype(np.int64)
    e = d + size[node]
    # sorted by (site, preorder row) a mutation's nearest same-site ancestor
    # is the previous one of its site or, when that one's interval does not
    # hold it, that one's own nearest ancestor (pointer chasing)
    order = np.lexsort((d, mut_col))
    c_s, d_s, e_s = mut_col[order], d[order], e[order]
    anc = np.arange(m) - 1
    anc[np.r_[True, c_s[1:] != c_s[:-1]]] = -1
    todo = np.nonzero(anc >= 0)[0]
    while len(todo):
        todo = todo[d_s[todo] >= e_s[anc[todo]]]
        anc[todo] = anc[anc[todo]]
        todo = todo[anc[todo] >= 0]
    depth = np.zeros(m, np.int64)
    while True:
        nd = np.where(anc >= 0, depth[np.maximum(anc, 0)] + 1, 0)
        if np.array_equal(nd, depth):
            break
        depth = nd
    par_s = np.empty(m, np.uint8)
    mut_s = np.empty(m, np.uint8)
    sh = shift[order]
    lvl_order = np.argsort(depth, kind="stable")
    lvl_bounds = np.searchsorted(depth[lvl_order],
                                 np.arange(depth.max() + 2))
    for lv in range(int(depth.max()) + 1):
        i = lvl_order[lvl_bounds[lv]:lvl_bounds[lv + 1]]
        par_s[i] = ref[c_s[i]] if lv == 0 else mut_s[anc[i]]
        mut_s[i] = NIBBLES[(np.searchsorted(NIBBLES, par_s[i]) + sh[i]) % 4]
    mut_par = np.empty(m, np.uint8)
    mut_mut = np.empty(m, np.uint8)
    mut_par[order] = par_s
    mut_mut[order] = mut_s
    mut_ptr = np.zeros(n + 1, np.int64)
    mut_ptr[1:] = np.cumsum(counts)
    return mut_ptr, mut_col, mut_par, mut_mut


def generate(rng, n_nodes: int, n_sites: int, branch_mutations) -> dict:
    """The configuration's MAT: arrays in preorder (node 0 the root), with
    `branch_mutations` the histogram of `branch_counts`.

    parent int32 [N] (root -> itself), depth, size (subtree sizes), is_leaf,
    num_leaves, the mutation CSR (mut_ptr, mut_col, mut_par, mut_mut; sites
    are columns into `positions`, 1..n_sites), ref uint8 [P] one-hot."""
    ref = NIBBLES[rng.integers(0, 4, size=n_sites)]
    raw = np.zeros(n_nodes, np.int64)
    raw[1:] = (rng.random(n_nodes - 1) * np.arange(1, n_nodes)).astype(
        np.int64)
    tin = preorder(raw)
    parent = np.zeros(n_nodes, np.int64)
    parent[tin] = tin[raw]
    depth = _depths(parent)
    # subtree sizes in preorder: a node's subtree is [v, v + size)
    size = np.ones(n_nodes, np.int64)
    d_order = np.argsort(depth, kind="stable")
    bounds = np.searchsorted(depth[d_order], np.arange(depth.max() + 2))
    for d in range(int(depth.max()), 0, -1):
        idx = d_order[bounds[d]:bounds[d + 1]]
        size += np.bincount(parent[idx], weights=size[idx],
                            minlength=n_nodes).astype(np.int64)
    is_leaf = size == 1
    csum = np.concatenate([[0], np.cumsum(is_leaf)])
    num_leaves = csum[np.arange(n_nodes) + size] - csum[np.arange(n_nodes)]
    counts = branch_counts(rng, n_nodes, branch_mutations)
    mut_ptr, mut_col, mut_par, mut_mut = chain_mutations(
        rng, parent, size, n_sites, counts, ref)
    return dict(parent=parent.astype(np.int32), depth=depth, size=size,
                is_leaf=is_leaf, num_leaves=num_leaves.astype(np.int64),
                mut_ptr=mut_ptr, mut_col=mut_col, mut_par=mut_par,
                mut_mut=mut_mut, ref=ref,
                positions=np.arange(1, n_sites + 1, dtype=np.int64))


def node_names(mat: dict) -> list[str]:
    """Every node's name as a loader of the pb names it: leaves are
    `leaf_<preorder index>`; internal nodes are unnamed in the pb and become
    node_<k>, k their rank among the internal nodes in preorder, from 1."""
    leaf = mat["is_leaf"]
    internal_rank = np.cumsum(~leaf)
    return [f"leaf_{i}" if leaf[i] else f"node_{internal_rank[i]}"
            for i in range(len(leaf))]
