"""The port's single-process tools against the JAX package's, on the CPU:
transpose_vcf, compareVCF and check_samples_place (host code on the port's
io/vcf.py, io/transpose.py, io/diff.py, io/pbio.py and core/nuc.py), the
top-level dispatcher ``python -m usher_tpu_torch <tool>`` and
utils/instrument.py::device_trace.

Each case runs the JAX tool and the port's on the same inputs, each in a
directory of its own with relative output paths, and requires equal exit
codes, stdout, stderr and every file byte for byte
(tests/test_native_tools.py's invocations, and more).
"""

import json
import os
import sys

import pytest
import torch

from usher_tpu import __main__ as jmain
from usher_tpu.cli.check_samples_cli import main as jax_check
from usher_tpu.cli.compare_vcf_cli import main as jax_compare
from usher_tpu.cli.transpose_vcf_cli import main as jax_transpose
from usher_tpu_torch import __main__ as tmain
from usher_tpu_torch.cli.check_samples_cli import main as torch_check
from usher_tpu_torch.cli.compare_vcf_cli import main as torch_compare
from usher_tpu_torch.cli.transpose_vcf_cli import main as torch_transpose
from usher_tpu_torch.utils.instrument import device_trace

from conftest import REFERENCE_TEST_DIR
from test_torch_ripples import run_side, same_run

GLOBAL_NH = os.path.join(REFERENCE_TEST_DIR, "global_phylo.nh")
GLOBAL_VCF = os.path.join(REFERENCE_TEST_DIR, "global_samples.vcf")
NEW_VCF = os.path.join(REFERENCE_TEST_DIR, "new_samples.vcf")
REF_FA = os.path.join(REFERENCE_TEST_DIR, "NC_045512v2.fa")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("USHER_TPU_PLATFORM", "cpu")


@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    """tests/test_native_tools.py::test_check_samples_place's two pbs (the
    fixture MAT, and it with the new samples placed), by the JAX CLI."""
    from usher_tpu.cli.usher_cli import main as usher_main
    d = tmp_path_factory.mktemp("tools")
    pb, pb2 = str(d / "b" / "out.pb"), str(d / "p" / "out2.pb")
    assert usher_main(["-t", GLOBAL_NH, "-v", GLOBAL_VCF, "-o", pb,
                       "-d", str(d / "b"), "--mesh-devices", "0"]) == 0
    assert usher_main(["-i", pb, "-v", NEW_VCF, "-o", pb2,
                       "-d", str(d / "p"), "--mesh-devices", "0"]) == 0
    return pb, pb2


def _edited_vcf():
    """new_samples.vcf with one genotype changed and one sample renamed."""
    with open(NEW_VCF) as f:
        lines = f.read().splitlines()
    head = [i for i, l in enumerate(lines) if l.startswith("#CHROM")][0]
    cols = lines[head].split("\t")
    cols[-1] = cols[-1] + "_renamed"
    lines[head] = "\t".join(cols)
    row = lines[head + 3].split("\t")
    row[9] = "1" if row[9] == "0" else "0"
    lines[head + 3] = "\t".join(row)
    return "\n".join(lines) + "\n"


def test_transpose_vcf_roundtrip_matches_jax(tmp_path, monkeypatch):
    """test_native_tools.py::test_transpose_vcf_roundtrip on both sides:
    encode, print_name, to_vcf and to_fa, then --append, and the usage
    error; every file and message equal."""
    steps = [["encode", "-v", GLOBAL_VCF, "-o", "g.tvcf"],
             ["print_name", "-i", "g.tvcf"],
             ["to_vcf", "-i", "g.tvcf", "-o", "back.vcf", "-r", REF_FA],
             ["to_fa", "-i", "g.tvcf", "-o", "back.fa", "-r", REF_FA],
             ["encode", "-v", NEW_VCF, "-o", "g.tvcf", "--append"],
             ["print_name", "-i", "g.tvcf"],
             ["nosuchmode"]]
    for k, argv in enumerate(steps):
        got = same_run(jax_transpose, torch_transpose, tmp_path, argv,
                       monkeypatch)
        assert got[0] == (1 if k == len(steps) - 1 else 0)
    from usher_tpu_torch.io.vcf import read_vcf_sites
    orig = read_vcf_sites(GLOBAL_VCF)
    back = read_vcf_sites(str(tmp_path / "torch" / "back.vcf"))
    assert back.sample_ids == orig.sample_ids
    back_map = {s.position: dict(s.variants) for s in back.sites}
    checked = 0
    for s in orig.sites:
        for col, nuc in dict(s.variants).items():
            assert back_map.get(s.position, {}).get(col) == nuc
            checked += 1
    assert checked > 1000


@pytest.mark.parametrize("pair", ["same", "disjoint", "edited"])
def test_compare_vcf_matches_jax(pair, tmp_path, monkeypatch):
    inputs = {"edited.vcf": _edited_vcf()}
    second = {"same": NEW_VCF, "disjoint": GLOBAL_VCF,
              "edited": "edited.vcf"}[pair]
    rc, out, err, _ = same_run(jax_compare, torch_compare, tmp_path,
                               [NEW_VCF, second], monkeypatch, inputs)
    assert rc == (1 if pair == "edited" else 0)
    if pair == "edited":
        assert "missing in file" in out and "At " in err


@pytest.mark.parametrize("case", ["placed", "not_placed", "mats_only",
                                  "vcf_only"])
def test_check_samples_place_matches_jax(case, placed, tmp_path,
                                         monkeypatch):
    pb, pb2 = placed
    argv = {"placed": ["-i", pb, "-v", NEW_VCF, "-o", pb2],
            "not_placed": ["-v", NEW_VCF, "-o", pb],
            "mats_only": ["-i", pb, "-o", pb2],
            "vcf_only": ["-v", GLOBAL_VCF, "-o", pb2]}[case]
    rc, _o, err, _ = same_run(jax_check, torch_check, tmp_path, argv,
                              monkeypatch)
    assert rc == (1 if case == "not_placed" else 0)
    assert err.rstrip().endswith("FAILED" if rc else "OK")


def _dispatch(mod, argv, capsys):
    old = sys.argv
    sys.argv = argv
    try:
        rc = mod.main()
    finally:
        sys.argv = old
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def test_top_level_dispatcher_matches_jax(capsys, tmp_path, monkeypatch):
    """test_workflow.py::test_top_level_dispatcher on the port: the same 15
    tool names, each mapped to a module of the port, and the same usage
    text (apart from the package name) and exit codes; a tool runs through
    it."""
    assert list(tmain.TOOLS) == list(jmain.TOOLS) and len(tmain.TOOLS) == 15
    for name, mod in tmain.TOOLS.items():
        assert mod == jmain.TOOLS[name].replace("usher_tpu.",
                                                "usher_tpu_torch.", 1)
        assert os.path.exists(os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            *mod.split(".")) + ".py"), mod
    for argv, want_rc in ((["--help"], 0), ([], 1), (["nosuchtool"], 1)):
        j = _dispatch(jmain, ["usher_tpu", *argv], capsys)
        t = _dispatch(tmain, ["usher_tpu_torch", *argv], capsys)
        assert t[0] == j[0] == want_rc
        assert t[1] == j[1]
        assert t[2] == j[2].replace("python -m usher_tpu ",
                                    "python -m usher_tpu_torch ")
        if argv == ["--help"]:
            assert "matUtils" in t[2] and "ripples-filter" in t[2]
    monkeypatch.chdir(tmp_path)
    assert _dispatch(tmain, ["usher_tpu_torch", "compareVCF", NEW_VCF,
                             NEW_VCF], capsys)[0] == 0
    fa = tmp_path / "aln.fa"
    fa.write_text(">ref\nACGTACGTAC\n>s1\nACGTTCGTAC\n>s2\nACNTACGAAC\n")
    for mod, out in ((jmain, "j.vcf"), (tmain, "t.vcf")):
        _dispatch(mod, ["x", "faToVcf", str(fa), out], capsys)
    assert (tmp_path / "t.vcf").read_bytes() == \
        (tmp_path / "j.vcf").read_bytes()


def test_device_trace_writes_a_cpu_trace(tmp_path):
    """device_trace on the CPU records CPU activity only and writes a
    Chrome trace that names the ops it ran."""
    logdir = str(tmp_path / "trace")
    with device_trace(logdir) as prof:
        x = torch.arange(4096, dtype=torch.int32)
        torch.cumsum(x, 0, dtype=torch.int32)
    names = os.listdir(logdir)
    assert names == [f"trace.{os.getpid()}.json"]
    path = os.path.join(logdir, names[0])
    assert os.path.getsize(path) > 0
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
    assert any("cumsum" in a.key for a in prof.key_averages())
