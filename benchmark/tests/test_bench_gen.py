"""The generators: deterministic by seed, and the shapes they state."""

import filecmp
import os

import numpy as np
import pytest

from benchmark.gen import inputs, mat as gmat, pbwrite, samples as gsamples
from conftest import TINY, tiny_traffic


def states(m):
    """Every node's alleles, materialised root to leaf (tiny sizes only)."""
    parent, ptr = m["parent"], m["mut_ptr"]
    st = np.zeros((len(parent), len(m["ref"])), np.uint8)
    st[0] = m["ref"]
    for v in range(1, len(parent)):
        st[v] = st[parent[v]]
        for k in range(ptr[v], ptr[v + 1]):
            c = m["mut_col"][k]
            assert st[v, c] == m["mut_par"][k], (v, c)
            st[v, c] = m["mut_mut"][k]
    return st


@pytest.mark.parametrize("branch_mutations", [[0, 0, 1], [190, 151, 79, 32,
                                                             14, 4, 2, 1]])
def test_tree_shapes(branch_mutations):
    m = gmat.generate(np.random.default_rng(4), 2000, 400, branch_mutations)
    parent = m["parent"]
    assert parent[0] == 0 and (parent[1:] < np.arange(1, 2000)).all()
    counts = np.diff(m["mut_ptr"])
    assert counts[0] == 0
    if len(branch_mutations) == 3:
        assert (counts[1:] == 2).all()
    else:
        # the histogram's mean (1.057 a branch) and its zeros
        assert abs(counts[1:].mean() - 1.057) < 0.1
        assert 0.3 < (counts[1:] == 0).mean() < 0.5
        assert counts.max() <= 7
    for v in range(1, 2000):
        cols = m["mut_col"][m["mut_ptr"][v]:m["mut_ptr"][v + 1]]
        assert len(set(cols.tolist())) == counts[v]
        assert list(cols) == sorted(cols)
    assert (m["mut_mut"] != m["mut_par"]).all()
    st = states(m)             # asserts chain consistency
    # a preorder subtree is [v, v + size)
    for v in np.random.default_rng(0).integers(0, 2000, 50):
        inside = np.arange(v + 1, v + m["size"][v])
        up = inside.copy()
        while (up > v).any():
            up = np.where(up > v, parent[up], up)
        assert (up == v).all()
    assert st.shape == (2000, 400)
    assert m["num_leaves"][0] == m["is_leaf"].sum()


def test_tree_deterministic_by_seed():
    def pb(seed):
        return pbwrite.pb_bytes(gmat.generate(np.random.default_rng(seed),
                                              500, 100, [0, 1]))
    assert pb(9) == pb(9) != pb(8)


def test_pb_reads_back_through_the_port(tmp_path):
    from usher_tpu_torch.io.pb_arrays import load_mat_arrays
    m = gmat.generate(np.random.default_rng(3), 1500, 300,
                      TINY["generator"]["branch_mutations"])
    path = str(tmp_path / "t.pb")
    pbwrite.write_pb(m, path)
    ma = load_mat_arrays(path)
    assert (ma.parent == m["parent"]).all()
    assert (ma.mut_ptr == m["mut_ptr"]).all()
    assert (ma.positions[ma.mut_col] == m["positions"][m["mut_col"]]).all()
    assert (ma.mut_par == m["mut_par"]).all()
    assert (ma.mut_mut == m["mut_mut"]).all()
    assert ma.names() == gmat.node_names(m)


@pytest.mark.parametrize("extra", [{}, {"private_substitutions": [0, 1],
                                      "n_calls": [0, 0, 1]}])
def test_samples_are_clades_of_leaf_parents(extra):
    m = gmat.generate(np.random.default_rng(5), 3000, 500,
                      TINY["generator"]["branch_mutations"])
    t = tiny_traffic("direct_jobs_2048", **extra)
    ladder = t["clade_ladder"]
    rng = np.random.default_rng(1)
    job = gsamples.draw_job(rng, m, t, 402, "s")
    st = states(m)
    assert len(job["names"]) == 402
    leaf_parents = set(m["parent"][m["is_leaf"]].tolist())
    assert set(job["source"].tolist()) <= leaf_parents
    assert job["shared"].tolist() == (ladder * 81)[:402]
    assert (job["private"] == len(t["private_substitutions"]) - 1).all()
    assert (job["missing"] == len(t["n_calls"]) - 1).all()
    g = {}
    for b in range(402):
        cols = job["col"][job["ptr"][b]:job["ptr"][b + 1]]
        nucs = job["nuc"][job["ptr"][b]:job["ptr"][b + 1]]
        assert list(cols) == sorted(set(cols.tolist()))
        assert (nucs == 15).sum() == job["missing"][b]
        g[b] = m["ref"].copy()
        g[b][cols] = nucs
        src = st[job["source"][b]]
        called = g[b] != 15
        # the clade node's genotype but for the ladder and the privates
        assert (g[b][called] != src[called]).sum() == \
            job["shared"][b] + job["private"][b]
    # a clade's members share its ladder: member 2 and 3 (depth 2 each)
    # agree where neither has a private or an N call
    if not extra:
        for c in range(0, 400, len(ladder)):
            assert (g[c + 1] == g[c + 2]).all()
            assert (g[c + 3] == g[c + 4]).all()
            assert (g[c] != g[c + 1]).sum() == 1


def test_warm_up_unit_is_one_batch(tmp_path, monkeypatch):
    t = tiny_traffic("direct_jobs_2048")
    monkeypatch.setattr(inputs, "CACHE", str(tmp_path))
    got = inputs.prepare(TINY, t, 11, 0.2)
    assert len(got["units"][0]["names"]) == t["batch_size"]
    assert all(len(u["names"]) == t["unit_samples"]
               for u in got["units"][1:])


def test_inputs_deterministic_by_seed(tmp_path, monkeypatch):
    t = tiny_traffic("direct_jobs_2048")
    got = []
    for d in ("a", "b"):
        monkeypatch.setattr(inputs, "CACHE", str(tmp_path / d))
        got.append(inputs.prepare(TINY, t, 2**31 + 17, 0.5))
    a, b = got
    assert len(a["units"]) == inputs.units_needed(t, 0.5)
    assert filecmp.cmp(a["pb"], b["pb"], shallow=False)
    for k, (ua, ub) in enumerate(zip(a["units"], b["units"])):
        assert filecmp.cmp(ua["vcf"], ub["vcf"], shallow=False)
        assert len(ua["names"]) == inputs.unit_size(t, k)
    monkeypatch.setattr(inputs, "CACHE", str(tmp_path / "c"))
    c = inputs.prepare(TINY, t, 2**31 + 18, 0.5)
    assert not filecmp.cmp(a["pb"], c["pb"], shallow=False)
    assert os.path.getsize(a["units"][1]["vcf"]) > 0
