"""usher_tpu_torch.placement.list_tree against usher_tpu.placement.list_tree.

The random trees of tests/test_list_tree.py (zero-mutation edges, duplicate
sibling mutation lists, unary chains, zero-mutation leaf polytomies) are
rebuilt from each package's own classes; every structural op (collapse,
condense, uncondense, subtree extraction, the newick writer) must leave
both ListTrees with the same newick text, condensed groups and node
counter.  ListTree.from_arrays / to_arrays go through each package's own
pb_arrays loader on the same pb file, and the -k / -K subtree writers must
write the same files.
"""

import os

import numpy as np
import pytest

from usher_tpu.io import pb_arrays as jpa
from usher_tpu.io.pbio import save_mat_pb
from usher_tpu.placement import list_tree as jlt
from usher_tpu_torch.io import pb_arrays as tpa
from usher_tpu_torch.placement import list_tree as tlt

from test_list_tree import random_tree
from test_placement import random_mat
from test_torch_hostlayers import port_tree


def to_listtree(mod, T):
    """tests/test_list_tree.py's tree_to_listtree with the ListTree class
    of ``mod`` (the tree's own package)."""
    lt = mod.ListTree()
    dfs = T.depth_first_expansion()
    idx = {id(n): i for i, n in enumerate(dfs)}
    lt.names = [n.identifier for n in dfs]
    lt.parent = [idx[id(n.parent)] if n.parent is not None else -1
                 for n in dfs]
    lt.children = [[idx[id(c)] for c in n.children] for n in dfs]
    lt.muts = [[m.copy() for m in n.mutations] for n in dfs]
    lt.alive = [True] * len(dfs)
    lt.root = idx[id(T.root)]
    lt.curr_internal_node = T.curr_internal_node
    lt.condensed = [(k, list(v)) for k, v in T.condensed_nodes.items()]
    lt.num_annotations = T.get_num_annotations()
    if lt.num_annotations:
        lt.ann = [list(n.clade_annotations) for n in dfs]
    return lt


def pair(seed, **kw):
    """(port ListTree, JAX ListTree) of one random tree."""
    T = random_tree(np.random.default_rng(seed), **kw)
    return to_listtree(tlt, port_tree(T)), to_listtree(jlt, T)


def same(a, b):
    assert a.write_newick() == b.write_newick()
    assert a.write_newick(uncondense=True) == b.write_newick(uncondense=True)
    assert dict(a.condensed) == dict(b.condensed)
    assert a.curr_internal_node == b.curr_internal_node


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_collapse_matches_jax(seed):
    t, j = pair(seed)
    same(t, j)
    t.collapse_tree()
    j.collapse_tree()
    same(t, j)


@pytest.mark.parametrize("seed", [100, 101, 102])
def test_condense_uncondense_matches_jax(seed):
    t, j = pair(seed, p_zero_muts=0.55)
    for op in ("condense_leaves", "uncondense_leaves"):
        getattr(t, op)()
        getattr(j, op)()
        same(t, j)


@pytest.mark.parametrize("seed", [300, 301])
def test_collapse_then_condense_matches_jax(seed):
    t, j = pair(seed, p_zero_muts=0.5, p_dup=0.25)
    for x in (t, j):
        x.collapse_tree()
        x.condense_leaves()
    same(t, j)


@pytest.mark.parametrize("seed", [200, 201, 202])
def test_subtree_matches_jax(seed):
    from usher_tpu.io.newick import write_newick as jnwk
    from usher_tpu_torch.io.newick import write_newick as tnwk
    rng = np.random.default_rng(seed)
    T = random_tree(rng)
    leaves = T.get_leaves_ids()
    pick = [leaves[int(i)] for i in
            rng.choice(len(leaves), size=min(8, len(leaves)), replace=False)]
    t, j = to_listtree(tlt, port_tree(T)), to_listtree(jlt, T)
    kw = dict(print_internal=True, print_branch_len=True)
    assert tnwk(t.get_subtree(pick), **kw) == jnwk(j.get_subtree(pick), **kw)


def _pb(tmp_path, seed):
    rng = np.random.default_rng(seed)
    T, _ = random_mat(rng, n_leaves=40, n_positions=20)
    for i, nd in enumerate(T.depth_first_expansion()):
        nd.clade_annotations = [f"a{i % 3}"]
    T.condensed_nodes[T.get_leaves_ids()[0]] = ["y1", "y2"]
    path = str(tmp_path / "t.pb")
    save_mat_pb(T, path)
    return path


@pytest.mark.parametrize("seed", [7, 8])
def test_from_and_to_arrays_match_jax(tmp_path, seed):
    """ListTree.from_arrays over each package's loaded arrays, collapsed
    and condensed as -c does, and back to arrays: the same arrays and the
    same pb bytes."""
    path = _pb(tmp_path, seed)
    outs = []
    for lt_mod, pa in ((tlt, tpa), (jlt, jpa)):
        ma = pa.load_mat_arrays(path)
        lt = lt_mod.ListTree.from_arrays(ma)
        nh0 = lt.write_newick()
        lt.collapse_tree()
        lt.condense_leaves()
        pos_index = {int(p): i for i, p in enumerate(ma.positions)}
        ma2 = lt.to_arrays(ma.positions, ma.ref, ma.chrom, pos_index)
        out = str(tmp_path / f"{lt_mod.__name__}.pb")
        pa.save_arrays_to_pb(ma2, out)
        with open(out, "rb") as f:
            outs.append((nh0, lt.write_newick(), lt.curr_internal_node,
                         ma2.names_blob, ma2.mut_ptr.tolist(),
                         ma2.mut_col.tolist(), f.read()))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("single", [False, True])
def test_subtree_writers_match_jax(tmp_path, single):
    """write_single_subtree_lt (-K) and write_sample_subtrees_lt (-k) write
    the same files through each package's rotate_for_display and
    _write_subtree_files."""
    T = random_tree(np.random.default_rng(400), n_nodes=80)
    samples = T.get_leaves_ids()[::5]
    files = []
    for mod, tree in ((tlt, port_tree(T)), (jlt, T)):
        out = tmp_path / mod.__name__
        out.mkdir()
        lt = to_listtree(mod, tree)
        if single:
            mod.write_single_subtree_lt(lt, samples, str(out), 10)
        else:
            mod.write_sample_subtrees_lt(lt, samples, str(out), 12)
        files.append({n: (out / n).read_bytes()
                      for n in sorted(os.listdir(out))})
    assert files[0] == files[1] and files[0]
