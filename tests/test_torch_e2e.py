"""The port's usher CLI end to end on the CPU (USHER_TPU_PLATFORM=cpu).

  1) build a MAT from global_phylo.nh + global_samples.vcf (Sankoff), save .pb
  2) place new_samples.vcf onto it

The placement outputs byte-match the committed smoke goldens, and every
output file equals the JAX CLI's under -p, -M 2, -k 5 and -s, and with
--bigmat (the CSR BigMAT engine) under no flag, -s, -p and -k 5.  With
--mesh-devices 8 (eight shards as CPU tensors; the JAX CLI on its eight
virtual devices) the files equal the unsharded run's and the JAX CLI's,
dense, under -s and with --bigmat.  The engine's sparse and dense backends
agree with the JAX engine on random MATs.
"""

import os

import numpy as np
import pytest

from usher_tpu.cli.usher_cli import main as jax_main
from usher_tpu.placement.driver import PlacementEngine as JEngine
from usher_tpu_torch.cli.usher_cli import main as torch_main
from usher_tpu_torch.placement.driver import PlacementEngine

from conftest import REFERENCE_TEST_DIR
from test_placement import random_mat, random_sample
from test_torch_hostlayers import port_samples, port_tree

GLOBAL_NH = os.path.join(REFERENCE_TEST_DIR, "global_phylo.nh")
GLOBAL_VCF = os.path.join(REFERENCE_TEST_DIR, "global_samples.vcf")
NEW_VCF = os.path.join(REFERENCE_TEST_DIR, "new_samples.vcf")
GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
GOLDEN_OF = [("placement_stats.tsv", "smoke_placement_stats.tsv"),
             ("final-tree.nh", "smoke_final_tree.nh"),
             ("mutation-paths.txt", "smoke_mutation_paths.txt")]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("USHER_TPU_PLATFORM", "cpu")


def _files(outdir):
    out = {}
    for root, _, names in os.walk(outdir):
        for name in names:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, outdir)] = f.read()
    return out


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The MAT built by the port's CLI (Sankoff on the CPU)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USHER_TPU_PLATFORM", "cpu")
        outdir = str(tmp_path_factory.mktemp("torch_build"))
        pb = os.path.join(outdir, "out.pb")
        assert torch_main(["-t", GLOBAL_NH, "-v", GLOBAL_VCF, "-o", pb,
                           "-d", outdir]) == 0
    return pb


def test_build_matches_jax(built, tmp_path):
    outdir = str(tmp_path / "jax_build")
    pb = os.path.join(outdir, "out.pb")
    assert jax_main(["-t", GLOBAL_NH, "-v", GLOBAL_VCF, "-o", pb,
                     "-d", outdir]) == 0
    with open(pb, "rb") as a, open(built, "rb") as b:
        assert a.read() == b.read()


def test_place_matches_goldens(built, tmp_path):
    outdir = str(tmp_path / "place")
    assert torch_main(["-i", built, "-v", NEW_VCF, "-o",
                       os.path.join(outdir, "o.pb"), "-d", outdir,
                       "--mesh-devices", "0"]) == 0
    for fname, gname in GOLDEN_OF:
        with open(os.path.join(outdir, fname), "rb") as a, \
                open(os.path.join(GOLDENS, gname), "rb") as b:
            assert a.read() == b.read(), f"{fname} deviates from golden"


@pytest.mark.parametrize("flags", [["-p"], ["-M", "2"], ["-k", "5"],
                                   ["-s", "--batch-size", "2"]])
def test_place_matches_jax_cli(built, tmp_path, flags):
    outs = []
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        outdir = str(tmp_path / name)
        assert main(["-i", built, "-v", NEW_VCF, "-d", outdir,
                     "-o", os.path.join(outdir, "o.pb"), *flags]) == 0
        outs.append(_files(outdir))
    assert sorted(outs[1]) == sorted(outs[0])
    assert len(outs[0]) >= 2
    for fname in outs[0]:
        assert outs[1][fname] == outs[0][fname], f"{fname} differs"


@pytest.mark.parametrize("flags", [[], ["-s"], ["-p"], ["-k", "5"]])
def test_bigmat_cli_matches_jax_cli(built, tmp_path, flags, capsys):
    """--bigmat: every output file equals the JAX CLI's --bigmat run, and
    without extra flags the placement files byte-match the goldens."""
    outs = []
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        outdir = str(tmp_path / name)
        assert main(["-i", built, "-v", NEW_VCF, "-d", outdir, "--bigmat",
                     *flags]) == 0
        outs.append(_files(outdir))
    assert "Using the CSR BigMAT engine" in capsys.readouterr().err
    assert sorted(outs[1]) == sorted(outs[0])
    for fname in outs[0]:
        assert outs[1][fname] == outs[0][fname], f"{fname} differs"
    if not flags:
        for fname, gname in GOLDEN_OF:
            with open(os.path.join(GOLDENS, gname), "rb") as f:
                assert outs[1][fname] == f.read(), f"{fname} vs golden"


@pytest.mark.parametrize("flags", [[], ["-s", "--batch-size", "2"],
                                   ["--bigmat"]])
def test_mesh_cli_matches_unsharded_and_jax_cli(built, tmp_path, flags,
                                                capsys):
    """--mesh-devices 8: the three placement files byte-equal the port's
    unsharded run and the JAX CLI's run over its 8-device mesh."""
    runs = (("torch_mesh", torch_main, "8"), ("torch_single", torch_main, "0"),
            ("jax_mesh", jax_main, "8"))
    outs = {}
    for name, main, mesh in runs:
        outdir = str(tmp_path / name)
        assert main(["-i", built, "-v", NEW_VCF, "-d", outdir,
                     "--mesh-devices", mesh, *flags]) == 0
        outs[name] = _files(outdir)
        err = capsys.readouterr().err
        assert ("Sharding placement over a {'data': 2, 'model': 4} device "
                "mesh." in err) == (mesh == "8")
    for fname, _ in GOLDEN_OF:
        assert outs["torch_mesh"][fname] == outs["torch_single"][fname], fname
        assert outs["torch_mesh"][fname] == outs["jax_mesh"][fname], fname
    assert sorted(outs["torch_mesh"]) == sorted(outs["jax_mesh"])


def test_mesh_devices_auto_means_no_mesh_on_one_device(built, tmp_path,
                                                       capsys):
    assert torch_main(["-i", built, "-v", NEW_VCF, "-d", str(tmp_path),
                       "--mesh-devices", "-1"]) == 0
    assert "Sharding placement" not in capsys.readouterr().err


def test_unported_modes_exit_with_error(built, tmp_path, capsys):
    """--pb-direct runs (tests/test_torch_direct.py) but, as in the JAX
    CLI, not with -M > 1; --distributed is not ported yet."""
    assert torch_main(["-i", built, "-v", NEW_VCF, "-d", str(tmp_path),
                       "--pb-direct", "-M", "2"]) == 1
    assert capsys.readouterr().err == (
        "ERROR: --pb-direct does not support -M>1 (use the Tree drivers)\n")
    with pytest.raises(NotImplementedError, match="A11"):
        torch_main(["-i", built, "-v", NEW_VCF, "-d", str(tmp_path),
                    "--distributed"])


@pytest.mark.parametrize("seed", [99, 100])
def test_engine_backends_match_jax_engine(seed):
    """SampleResults (score, tie set, winner, has_unique) of the port's
    sparse and dense engines equal the JAX engine's, and best_placements
    agrees with score_samples."""
    rng = np.random.default_rng(seed)
    T, ref = random_mat(rng, n_leaves=30)
    samples = [random_sample(rng, ref) for _ in range(6)]

    def summary(results):
        return [(r.best_score, r.num_best, r.best_node.identifier,
                 r.best_has_unique, [n.identifier for n in r.tied_nodes],
                 r.tied_has_unique, list(r.scores_bfs), list(r.valid_bfs))
                for r in results]

    want = summary(JEngine(T, backend="dense").score_samples(
        samples, want_matrix=True))
    psamples = port_samples(samples)
    for backend in ("sparse", "dense"):
        eng = PlacementEngine(port_tree(T), backend=backend, device="cpu")
        assert summary(eng.score_samples(psamples, want_matrix=True)) == want
        best, num_best = eng.best_placements(psamples)
        assert best.tolist() == [w[0] for w in want]
        assert num_best.tolist() == [w[1] for w in want]
