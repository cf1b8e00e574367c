"""usher_tpu_torch.core.flat.FlatMAT against the JAX FlatMAT: the same tree
driven through the same appends, re-parents and syncs gives equal state
arrays, padding, order metadata and sample encodings, across a capacity
growth."""

import numpy as np
import pytest

from usher_tpu.core.flat import FlatMAT as JFlatMAT
from usher_tpu.core.flat import collect_positions as jcollect_positions
from usher_tpu.core import tree as jtree
from usher_tpu_torch.core import tree as ttree
from usher_tpu_torch.core.flat import FlatMAT, collect_positions

from test_placement import BASES, random_mat, random_sample
from test_torch_hostlayers import port_samples, port_tree


def _path_state(node, p, ref):
    state = ref
    chain = []
    while node is not None:
        chain.append(node)
        node = node.parent
    for nd in reversed(chain):
        for m in nd.mutations:
            if m.position == p:
                state = m.mut_nuc
    return state


def _assert_same(jflat, flat):
    st_j, par_j = jflat.sync()
    st, parent = flat.sync()
    assert (flat.cap, flat.n_slots, flat.P, flat.P_pad) == (
        jflat.cap, jflat.n_slots, jflat.P, jflat.P_pad)
    np.testing.assert_array_equal(st.numpy(), np.asarray(st_j))
    np.testing.assert_array_equal(parent.numpy(), np.asarray(par_j))
    np.testing.assert_array_equal(flat.ref, jflat.ref)
    np.testing.assert_array_equal(flat.ref_dev.numpy(), jflat.ref)
    jm, m = jflat.order_arrays(), flat.order_arrays()
    assert [n.identifier for n in m["bfs"]] == [n.identifier
                                               for n in jm["bfs"]]
    for k in ("active", "is_leaf", "bfs_rank", "num_leaves", "is_root_mask"):
        np.testing.assert_array_equal(m[k], jm[k], err_msg=k)
        assert m[k].dtype == jm[k].dtype
    assert flat.root_slot == jflat.root_slot


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flat_parity_through_surgery_and_growth(seed):
    rng = np.random.default_rng(seed)
    T, ref = random_mat(rng, n_leaves=12)
    PT = port_tree(T)          # the port's own tree, edited in lockstep
    for a, b in zip(collect_positions(PT), jcollect_positions(T)):
        np.testing.assert_array_equal(a, b)
    # every site of the random MAT, so the samples below can name any
    positions = np.array(sorted(ref), dtype=np.int64)
    refarr = np.array([ref[p] for p in positions.tolist()], dtype=np.uint8)
    chrom = "c"
    jflat = JFlatMAT(T, positions, refarr, chrom)
    flat = FlatMAT(PT, positions, refarr, chrom)
    _assert_same(jflat, flat)
    cap0 = flat.cap
    sides = ((T, jflat, jtree), (PT, flat, ttree))

    # graft enough leaves to outgrow the capacity, with sibling splits
    # (new internal node + re-parent) among them
    for i in range(cap0 - flat.n_slots + 5):
        nodes = T.breadth_first_expansion()
        target_id = nodes[int(rng.integers(len(nodes)))].identifier
        split = T.get_node(target_id).parent is not None and i % 3 == 0
        p = int(positions[int(rng.integers(len(positions)))])
        pick = int(rng.integers(3))
        for tree, fl, mod in sides:
            target = tree.get_node(target_id)
            if split:
                mid = tree.create_node(f"mid{i}", target.parent)
                tree.move_node(target.identifier, mid.identifier)
                fl.add_node(mid)
                fl.reparent(target)
                target = mid
            leaf = tree.create_node(f"new{i}", target)
            state = _path_state(target, p, ref[p])
            mut = [b for b in BASES if b != state][pick]
            leaf.add_mutation(mod.Mutation("c", p, ref[p], state, mut))
            fl.add_node(leaf)
        if i % 7 == 0:
            _assert_same(jflat, flat)
    assert flat.cap > cap0
    _assert_same(jflat, flat)

    samples = [random_sample(rng, ref) for _ in range(4)]
    for a, b in zip(flat.encode_samples(port_samples(samples)),
                    jflat.encode_samples(samples)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
