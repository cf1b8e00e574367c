"""usher_tpu_torch.placement.direct (usher --pb-direct) against the JAX
package's DirectPlacer and CLI, on the CPU.

The port's CLI with --pb-direct must write the files of the JAX CLI's
--pb-direct run on the same pb and VCF (byte for byte), and on the
reference fixture the committed goldens and the port's own --bigmat run.
The workloads are tests/test_direct_exact.py's adversarial ones
(near-duplicates that pile onto the same nodes, exact duplicates, ambiguous
and missing entries), saved as a pb and a VCF that both sides read from
disk.  The batched driver must equal the literal per-sample loop
(USHER_TPU_DIRECT_SEQ=1) and the enqueue-ahead order
(USHER_TPU_DIRECT_PIPE=1); --mesh-devices 8 (eight shards as CPU tensors)
the unsharded run and the JAX CLI over its eight virtual devices.
"""

import os

import numpy as np
import pytest

from usher_tpu.cli.usher_cli import main as jax_main
from usher_tpu.io import pb_arrays as jpa
from usher_tpu.placement.direct import DirectOptions as JOptions
from usher_tpu.placement.direct import DirectPlacer as JPlacer
from usher_tpu_torch.cli.usher_cli import main as torch_main
from usher_tpu_torch.core.tree import MissingSample
from usher_tpu_torch.placement.direct import DirectOptions, DirectPlacer

from conftest import REFERENCE_TEST_DIR
from test_direct_exact import (adversarial_samples, annotate_mat,
                               consistent_mat, write_vcf_for)
from test_torch_hostlayers import port_mutation

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
    monkeypatch.delenv("USHER_TPU_DIRECT_SEQ", raising=False)
    monkeypatch.delenv("USHER_TPU_DIRECT_PIPE", raising=False)


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
    """The reference fixture's MAT as a pb (the port's CLI builds it)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USHER_TPU_PLATFORM", "cpu")
        outdir = str(tmp_path_factory.mktemp("direct_build"))
        pb = os.path.join(outdir, "out.pb")
        assert torch_main(["-t", GLOBAL_NH, "-v", GLOBAL_VCF, "-o", pb,
                           "-d", outdir]) == 0
    return pb


def both_clis(tmp_path, argv, save=False):
    """The port's and the JAX CLI's --pb-direct runs of argv; their output
    directories (with the saved pb under -o) must hold the same files."""
    outs = []
    for name, main in (("torch", torch_main), ("jax", jax_main)):
        outdir = str(tmp_path / name)
        extra = ["-o", os.path.join(outdir, "out.pb")] if save else []
        assert main([*argv, "-d", outdir, "--pb-direct", *extra]) == 0
        outs.append(_files(outdir))
    assert sorted(outs[0]) == sorted(outs[1])
    for fname in outs[1]:
        assert outs[0][fname] == outs[1][fname], f"{fname} differs"
    return outs[0]


@pytest.mark.parametrize("flags", [
    [], ["-s"], ["-S", "--batch-size", "2"], ["-A", "-r"], ["-p"],
    ["-n"], ["-E", "0"], ["-e", "1"], ["-c"], ["-C"], ["-k", "5"],
    ["-K", "5"], ["-u"], ["-D"]])
def test_fixture_matches_jax_cli(built, tmp_path, flags):
    """Every output file of the fixture's --pb-direct run (and the saved pb)
    equals the JAX CLI's; without flags the placement files are the
    goldens."""
    files = both_clis(tmp_path, ["-i", built, "-v", NEW_VCF, *flags],
                      save="-p" not in flags and "-n" not in flags)
    if not flags:
        for fname, gname in GOLDEN_OF:
            with open(os.path.join(GOLDENS, gname), "rb") as f:
                assert files[fname] == f.read(), f"{fname} vs golden"


def test_fixture_matches_bigmat_with_save_and_uncondensed(built, tmp_path):
    """--pb-direct -u -o equals the port's own --bigmat -u -o: the
    uncondensed final tree and the saved pb (which re-condenses the
    fixture's condensed nodes) byte for byte."""
    outs = []
    for tag, mode in (("direct", "--pb-direct"), ("bigmat", "--bigmat")):
        outdir = str(tmp_path / tag)
        assert torch_main(["-i", built, "-v", NEW_VCF, "-d", outdir, "-u",
                           "-o", os.path.join(outdir, "o.pb"), mode,
                           "--mesh-devices", "0"]) == 0
        outs.append(_files(outdir))
    assert sorted(outs[0]) == sorted(outs[1])
    for fname in ("uncondensed-final-tree.nh", "o.pb", "placement_stats.tsv",
                  "mutation-paths.txt"):
        assert outs[0][fname] == outs[1][fname], fname


@pytest.mark.parametrize("flags", [[], ["-s"]])
def test_mesh_matches_unsharded_and_jax_cli(built, tmp_path, flags, capsys):
    """--mesh-devices 8: the placement files equal the port's unsharded
    run and the JAX CLI's run over its 8-device mesh."""
    runs = (("torch_mesh", torch_main, "8"), ("torch_single", torch_main, "0"),
            ("jax_mesh", jax_main, "8"))
    outs = {}
    for name, main, mesh in runs:
        outdir = str(tmp_path / name)
        assert main(["-i", built, "-v", NEW_VCF, "-d", outdir, "--pb-direct",
                     "--mesh-devices", mesh, *flags]) == 0
        outs[name] = _files(outdir)
        err = capsys.readouterr().err
        assert ("Sharding direct placement over 8 devices." in err) == \
            (mesh == "8")
    for fname, _ in GOLDEN_OF:
        assert outs["torch_mesh"][fname] == outs["torch_single"][fname], fname
        assert outs["torch_mesh"][fname] == outs["jax_mesh"][fname], fname


def test_mesh_devices_auto_means_no_mesh_on_one_device(built, tmp_path,
                                                       capsys):
    assert torch_main(["-i", built, "-v", NEW_VCF, "-d", str(tmp_path),
                       "--pb-direct", "--mesh-devices", "-1"]) == 0
    assert "Sharding" not in capsys.readouterr().err


@pytest.mark.parametrize("argv,message", [
    (["--pb-direct"], "--pb-direct requires -i MAT.pb"),
    (["--pb-direct", "-i", "x.pb", "-M", "2"],
     "--pb-direct does not support -M>1"),
    (["--pb-direct", "-i", "x.pb", "-k", "1"],
     "print-subtrees-size should be larger than 1"),
    (["--pb-direct", "-i", "x.pb", "-n", "-K", "5"],
     "cannot output subtrees when -n/--no-add"),
    (["--pb-direct", "-i", "x.pb", "-s", "-S"],
     "Can't use two or more of sort-before-placement"),
    (["--pb-direct", "-i", "x.pb", "-r"],
     "Can't use reverse-sort without sorting options")])
def test_cli_checks_match_jax(tmp_path, capsys, argv, message):
    """The flag checks of the JAX CLI's --pb-direct branch, word for word,
    before anything is read."""
    errs = []
    for main in (torch_main, jax_main):
        assert main([*argv, "-v", NEW_VCF, "-d", str(tmp_path)]) == 1
        errs.append(capsys.readouterr().err)
    assert errs[0] == errs[1] and message in errs[0]


def _workload(tmp_path, seed, N, P, n_samples, annotated=False):
    """tests/test_direct_exact.py's adversarial workload saved as a pb (by
    the JAX writer) and a VCF; the samples as JAX MissingSamples."""
    rng = np.random.default_rng(seed)
    ma, state, is_leaf = consistent_mat(rng, N=N, P=P)
    if annotated:
        annotate_mat(rng, ma)
    pb = tmp_path / "t.pb"
    jpa.save_arrays_to_pb(ma, str(pb))
    samples = adversarial_samples(rng, ma, state, is_leaf, n_samples)
    vcf = tmp_path / "s.vcf"
    write_vcf_for(vcf, ma, samples)
    return str(pb), str(vcf), samples


@pytest.mark.parametrize("seed,flags", [
    (11, ["--batch-size", "16"]), (12, ["--batch-size", "7", "-s"]),
    (21, ["-S"]), (22, ["-A", "-r"]), (23, ["-p", "--batch-size", "4"])])
def test_random_workloads_match_jax_cli(tmp_path, seed, flags):
    pb, vcf, _ = _workload(tmp_path, seed, 250, 120, 36)
    both_clis(tmp_path, ["-i", pb, "-v", vcf, *flags])


@pytest.mark.parametrize("flags", [[], ["-D", "--batch-size", "12"]])
def test_clades_match_jax_cli(tmp_path, flags):
    """clades.txt, basic and -D (the device tie-set histogram), on an
    annotated MAT."""
    pb, vcf, _ = _workload(tmp_path, 31, 250, 120, 36, annotated=True)
    files = both_clis(tmp_path, ["-i", pb, "-v", vcf, *flags], save=True)
    assert "clades.txt" in files


@pytest.mark.parametrize("flags", [["-c"], ["-C", "-u"], ["-K", "20"],
                                   ["-k", "10", "-C"]])
def test_collapse_and_subtrees_match_jax_cli(tmp_path, flags):
    pb, vcf, _ = _workload(tmp_path, 51, 220, 110, 24)
    both_clis(tmp_path, ["-i", pb, "-v", vcf, "--batch-size", "8", *flags],
              save=True)


def _port_sample(s):
    c = MissingSample(s.name)
    c.mutations = [port_mutation(m) for m in s.mutations]
    c.num_ambiguous = s.num_ambiguous
    return c


def _run_placer(cls, opts_cls, pb, samples, outdir, monkeypatch, env=None,
                **opts):
    for var in ("USHER_TPU_DIRECT_SEQ", "USHER_TPU_DIRECT_PIPE"):
        monkeypatch.delenv(var, raising=False)
    if env:
        monkeypatch.setenv(env, "1")
    placer = cls(pb)
    placer.missing = samples
    placer.place_all(opts_cls(outdir=str(outdir), **opts))
    return {f: (outdir / f).read_bytes() for f in os.listdir(outdir)}


@pytest.mark.parametrize("seed,batch,detailed", [
    (0, 48, False), (1, 48, False), (7, 16, False), (41, 48, True)])
def test_placer_modes_match_jax_placer(tmp_path, monkeypatch, seed, batch,
                                       detailed):
    """The port's DirectPlacer, batched, per-sample (SEQ) and enqueue-ahead
    (PIPE), equals the JAX DirectPlacer's batched run on the same pb and
    samples; -D clade histograms on an annotated MAT."""
    pb, _, samples = _workload(tmp_path, seed, 300, 150, 48,
                               annotated=detailed)
    kw = dict(batch_size=batch, detailed_clades=detailed)
    want = _run_placer(JPlacer, JOptions, pb,
                       [s for s in samples], tmp_path / "jax", monkeypatch,
                       **kw)
    for env in (None, "USHER_TPU_DIRECT_SEQ", "USHER_TPU_DIRECT_PIPE"):
        got = _run_placer(DirectPlacer, DirectOptions, pb,
                          [_port_sample(s) for s in samples],
                          tmp_path / f"torch_{env}", monkeypatch, env=env,
                          **kw)
        assert got == want, env
    assert {"placement_stats.tsv", "final-tree.nh"} <= set(want)


def test_placer_bigmat_device(tmp_path, built, monkeypatch):
    """The placer's BigMAT lives on the device USHER_TPU_PLATFORM names,
    and under a mesh on the mesh's lead device, as a 1-D batch mesh."""
    from usher_tpu_torch.parallel.mesh import make_mesh
    placer = DirectPlacer(built, NEW_VCF)
    assert placer.big.device.type == "cpu" and placer.big.mesh is None
    mesh = make_mesh(4, device="cpu")
    placer = DirectPlacer(built, NEW_VCF, mesh=mesh)
    assert placer.big.device == mesh.lead
    assert placer.big.mesh.axis_names == ("batch",)
    assert placer.big.mesh.size == 4


def test_duplicate_sample_placed_once(tmp_path):
    """A sample twice in the VCF is placed once and warned about on its
    second occurrence, as in the JAX driver."""
    from test_placement import random_mat
    from usher_tpu.io.pbio import save_mat_pb
    from usher_tpu.placement.direct import run_usher_direct as jrun
    from usher_tpu_torch.placement.direct import run_usher_direct as trun
    rng = np.random.default_rng(21)
    T, ref = random_mat(rng, n_leaves=25, n_positions=15)
    pb = str(tmp_path / "t.pb")
    save_mat_pb(T, pb)
    p0 = sorted(ref)[0]
    bases = {1: "A", 2: "C", 4: "G", 8: "T"}
    alt = 1 if ref[p0] != 1 else 2
    vcf = tmp_path / "s.vcf"
    vcf.write_text("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                   "DUP\tDUP\n"
                   f"c\t{p0}\t.\t{bases[ref[p0]]}\t{bases[alt]}\t.\t.\t.\t"
                   "GT\t1\t1\n")
    outs = []
    for run, opts, name in ((trun, DirectOptions, "t"),
                            (jrun, JOptions, "j")):
        out = str(tmp_path / name)
        assert run(pb, str(vcf), opts(outdir=out)) == 0
        outs.append(_files(out))
    assert outs[0] == outs[1]
    assert outs[0]["final-tree.nh"].count(b"DUP") == 1


def test_save_annotated_matches_jax_and_bigmat(tmp_path):
    """-o on an annotated MAT: the nodes that placement creates carry the
    empty annotation columns the Tree path writes; the port's --pb-direct
    pb equals its --bigmat pb and the JAX CLI's --pb-direct pb."""
    from usher_tpu.core.tree import Mutation
    from usher_tpu.io.newick import parse_newick_string
    from usher_tpu.io.pbio import save_mat_pb
    T = parse_newick_string("((A:1,B:1):1,(C:1,D:1):1):0;")
    for leaf, (p, par, mut) in {"A": (100, 1, 2), "B": (120, 1, 4),
                                "C": (140, 2, 8), "D": (160, 4, 1)}.items():
        T.get_node(leaf).add_mutation(Mutation("c", p, par, par, mut))
    for n in T.depth_first_expansion():
        n.clade_annotations = ["", ""]
    T.root.clade_annotations = ["19A", "X"]
    T.root.children[0].clade_annotations = ["20A", ""]
    pb = str(tmp_path / "ann.pb")
    save_mat_pb(T, pb)
    vcf = tmp_path / "s.vcf"
    vcf.write_text(
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\tS2\n"
        "c\t100\t.\tA\tC\t.\t.\t.\tGT\t1\t0\n"
        "c\t140\t.\tC\tT\t.\t.\t.\tGT\t0\t1\n")
    files = both_clis(tmp_path, ["-i", pb, "-v", str(vcf)], save=True)
    outdir = str(tmp_path / "bigmat")
    assert torch_main(["-i", pb, "-v", str(vcf), "-d", outdir, "--bigmat",
                       "-o", os.path.join(outdir, "out.pb"),
                       "--mesh-devices", "0"]) == 0
    assert _files(outdir)["out.pb"] == files["out.pb"]
