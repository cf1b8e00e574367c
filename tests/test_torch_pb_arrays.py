"""usher_tpu_torch.io.pb_arrays against usher_tpu.io.pb_arrays.

Each side loads the same parsimony.pb from disk with its own loader (each
through its package's compiled scanner; tests/test_torch_native.py holds
the port's compiled and pure-Python scanners together): the flat arrays, the names,
condensed groups and annotations must be equal, the BigMATs built from them
(the port's on CPU tensors) must hold the same aggregates, tie-break ranks
and placements, and the array writers (final-tree newick, parsimony.pb)
must give the same bytes.  Tolerance: none (integer parsimony).
"""

import os

import numpy as np
import pytest

from usher_tpu.cli.usher_cli import main as jax_main
from usher_tpu.io import pb_arrays as jpa
from usher_tpu.io.pbio import save_mat_pb
from usher_tpu_torch.io import pb_arrays as tpa

from conftest import REFERENCE_TEST_DIR
from test_placement import random_mat, random_sample
from test_torch_hostlayers import port_samples

GLOBAL_NH = os.path.join(REFERENCE_TEST_DIR, "global_phylo.nh")
GLOBAL_VCF = os.path.join(REFERENCE_TEST_DIR, "global_samples.vcf")

ARRAY_FIELDS = ("parent", "name_off", "blen", "mut_ptr", "mut_col",
                "mut_par", "mut_mut", "positions", "ref", "ann_counts")
BIG_FIELDS = ("base", "nc_base", "node_num_mut", "num_leaves", "level",
              "bfs_rank", "dfs_of", "dfs_end_of", "dfs_order", "is_leaf")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("USHER_TPU_PLATFORM", "cpu")


def _random_pb(tmp_path, seed, n_leaves=60, n_positions=30):
    """A random MAT with annotations and a condensed group, saved as a pb;
    returns its path and (rng, ref) for drawing samples."""
    rng = np.random.default_rng(seed)
    T, ref = random_mat(rng, n_leaves=n_leaves, n_positions=n_positions)
    for i, nd in enumerate(T.depth_first_expansion()):
        nd.clade_annotations = [f"c{i % 5}", ""]
    T.condensed_nodes["cn_1"] = ["x1", "x2"]
    path = str(tmp_path / f"t{seed}.pb")
    save_mat_pb(T, path)
    return path, rng, ref


@pytest.fixture(scope="module")
def fixture_pb(tmp_path_factory):
    """The reference fixture's MAT as a pb (built by the JAX CLI)."""
    out = str(tmp_path_factory.mktemp("pb_arrays_fixture"))
    pb = os.path.join(out, "out.pb")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USHER_TPU_PLATFORM", "cpu")
        assert jax_main(["-t", GLOBAL_NH, "-v", GLOBAL_VCF, "-o", pb,
                         "-d", out, "--mesh-devices", "0"]) == 0
    return pb


def assert_same_arrays(got, want):
    for k in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
        assert getattr(got, k).dtype == getattr(want, k).dtype, k
    assert got.names_blob == want.names_blob
    assert got.chrom == want.chrom
    assert got.condensed == want.condensed
    assert got.ann_blob == want.ann_blob
    assert got.names() == want.names()
    assert [got.name(i) for i in range(got.n)] == \
        [want.name(i) for i in range(want.n)]


def assert_same_bigmat(got, want):
    for k in BIG_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, k)),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)


@pytest.mark.parametrize("seed", [3, 5, 8])
def test_loader_and_bigmat_match_jax(tmp_path, seed):
    path, rng, ref = _random_pb(tmp_path, seed)
    got, want = tpa.load_mat_arrays(path), jpa.load_mat_arrays(path)
    assert_same_arrays(got, want)
    assert tpa.write_newick_arrays(got) == jpa.write_newick_arrays(want)
    big_t, big_j = got.to_bigmat(), want.to_bigmat()
    assert big_t.device.type == "cpu"
    assert_same_bigmat(big_t, big_j)
    # the same placements, tie counts and winners
    cols = set(big_j.positions.tolist())
    samples = [[m for m in random_sample(rng, ref) if m.position in cols]
               for _ in range(6)]
    samples = [s for s in samples if s]
    for a, b in zip(big_t.place_batch(port_samples(samples)),
                    big_j.place_batch(samples)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_loader_matches_jax_on_fixture(fixture_pb):
    got, want = (tpa.load_mat_arrays(fixture_pb),
                 jpa.load_mat_arrays(fixture_pb))
    assert_same_arrays(got, want)
    assert got.condensed                    # the fixture has condensed nodes
    assert tpa.write_newick_arrays(got) == jpa.write_newick_arrays(want)
    assert_same_bigmat(got.to_bigmat(), want.to_bigmat())


def test_loader_reads_gzip(tmp_path, fixture_pb):
    import gzip
    gz = str(tmp_path / "t.pb.gz")
    with open(fixture_pb, "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    assert_same_arrays(tpa.load_mat_arrays(gz),
                       jpa.load_mat_arrays(fixture_pb))


@pytest.mark.parametrize("vectorized", [True, False])
def test_save_arrays_to_pb_bytes(tmp_path, fixture_pb, monkeypatch,
                                 vectorized):
    """save_arrays_to_pb writes the bytes of the JAX writer and of
    save_mat_pb, through the vectorized node_mutations encoder and through
    the per-field loop, and its file loads back to the same arrays."""
    path, _, _ = _random_pb(tmp_path, 13, n_leaves=40, n_positions=20)
    if not vectorized:
        monkeypatch.setattr(tpa, "_mutation_blocks_vec", lambda *a: None)
        monkeypatch.setattr(jpa, "_mutation_blocks_vec", lambda *a: None)
    for src in (path, fixture_pb):
        out_t, out_j = str(tmp_path / "t.pb"), str(tmp_path / "j.pb")
        tpa.save_arrays_to_pb(tpa.load_mat_arrays(src), out_t)
        jpa.save_arrays_to_pb(jpa.load_mat_arrays(src), out_j)
        with open(out_t, "rb") as a, open(out_j, "rb") as b, \
                open(src, "rb") as c:
            mine = a.read()
            assert mine == b.read() == c.read()
        assert_same_arrays(tpa.load_mat_arrays(out_t),
                           jpa.load_mat_arrays(src))


def test_save_ambiguous_mutations_match_jax(tmp_path):
    """Ambiguous mut_nuc nibbles (packed multi-nt lists), a chromosome name
    and annotations through both writers (the JAX test's synthetic
    MatArrays, built as each package's own class)."""
    rng = np.random.default_rng(17)
    n, P = 400, 60
    parent = np.zeros(n, np.int32)
    parent[1:] = (rng.random(n - 1) * np.arange(1, n)).astype(np.int32)
    counts = rng.integers(0, 4, size=n)
    counts[0] = 0
    mut_ptr = np.zeros(n + 1, np.int64)
    mut_ptr[1:] = np.cumsum(counts)
    M = int(mut_ptr[-1])
    nib = np.array([1, 2, 4, 8], np.uint8)
    names = [f"s{i}" for i in range(n)]
    blob = ("\0".join(names) + "\0").encode()
    off = np.zeros(n + 1, np.int64)
    off[1:] = np.nonzero(np.frombuffer(blob, np.uint8) == 0)[0] + 1
    kw = dict(parent=parent, names_blob=blob, name_off=off,
              blen=np.full(n, -1.0), mut_ptr=mut_ptr,
              mut_col=rng.integers(0, P, size=M).astype(np.int32),
              mut_par=nib[rng.integers(0, 4, size=M)],
              mut_mut=rng.integers(1, 16, size=M).astype(np.uint8),
              positions=np.arange(100, 100 + P, dtype=np.int64),
              ref=nib[rng.integers(0, 4, size=P)], chrom="NC_045512v2",
              condensed=[("s1", ["a", "b"])],
              ann_counts=np.ones(n, np.int32),
              ann_blob=("\0".join("c" for _ in range(n)) + "\0").encode())
    out_t, out_j = str(tmp_path / "t.pb"), str(tmp_path / "j.pb")
    tpa.save_arrays_to_pb(tpa.MatArrays(**kw), out_t)
    jpa.save_arrays_to_pb(jpa.MatArrays(**kw), out_j)
    with open(out_t, "rb") as a, open(out_j, "rb") as b:
        assert a.read() == b.read()


def test_set_names_expand_condensed_ann_lists(fixture_pb, tmp_path):
    """The small list helpers of the array writers, on both packages'
    arrays of the same files."""
    path, _, _ = _random_pb(tmp_path, 21)
    for src in (fixture_pb, path):
        got, want = tpa.load_mat_arrays(src), jpa.load_mat_arrays(src)
        assert tpa.ann_lists(got) == jpa.ann_lists(want)
        assert tpa.ann_lists(got, got.n + 3) == jpa.ann_lists(want,
                                                             want.n + 3)
        lists = []
        for mod, ma in ((tpa, got), (jpa, want)):
            names = ma.names()
            parent = ma.parent.tolist()
            children = [[] for _ in names]
            for i, p in enumerate(parent):
                if p != i:
                    children[p].append(i)
            new = []
            counter = mod.expand_condensed(
                names, parent, children,
                lambda i: ma.mut_ptr[i + 1] > ma.mut_ptr[i], ma.condensed,
                7, new.append)
            mod.set_names(ma, names)
            lists.append((names, parent, children, new, counter,
                          ma.names_blob, ma.name_off.tolist()))
        assert lists[0] == lists[1]
