"""The harness is driven by data; it imports no JAX; BENCHMARK.json keeps
to its contract; a machine without a card gets no result."""

import ast
import json
import os
import re
import shutil

import pytest

from benchmark import run as R
from conftest import ROOT, TINY, cell, tiny_traffic

BENCH = os.path.join(ROOT, "benchmark")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def py_files(top):
    for d, _, fs in os.walk(top):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_or_jax_package_anywhere():
    for path in py_files(BENCH):
        bad = set(top_imports(path)) & {"jax", "jaxlib", "flax", "usher_tpu"}
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_port():
    for path in py_files(os.path.join(BENCH, "reference")):
        assert "usher_tpu_torch" not in set(top_imports(path)), path


def test_bench_file_keeps_to_its_contract():
    b = R.load_bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(ROOT, c["file"])) as f:
            assert set(json.load(f)["reduced"]) == set(c["reduced"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        got = {m["name"] for m in R.metrics_for(b, "end_to_end", w["name"])}
        assert "setup_s" in got and len(got) >= 2
        assert R.metrics_for(b, "per_layer", w["name"])
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        mover = e2e[m["moves"]]
        for w in m.get("workloads", cells):
            assert "workloads" not in mover or w in mover["workloads"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in b["workloads"]:
        R.cell_of(b, w["name"])         # every file is found
        for m in R.metrics_for(b, "end_to_end", w["name"]):
            R.reader("e2e_metrics", m["name"])
        for m in R.metrics_for(b, "per_layer", w["name"]):
            R.reader("layer_metrics", m["name"])


def test_new_config_mix_and_metric_are_found_as_files(cpu_env):
    """A later change adds a configuration, a mix and a metric by adding
    files and entries: nothing of the harness is edited."""
    root = cpu_env / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    b = R.load_bench()
    cfg = dict(TINY, name="tiny_added")
    (root / "benchmark" / "configs" / "tiny_added.json").write_text(
        json.dumps(dict(cfg, reduced={})))
    mix = tiny_traffic("direct_jobs_1024", name="added_mix", unit_samples=48)
    (root / "benchmark" / "traffic" / "added_mix.json").write_text(
        json.dumps(mix))
    (root / "benchmark" / "layer_metrics" / "added_metric.py").write_text(
        "def read(run):\n    return float(len(run.rec.units))\n")
    b["configs"].append({"name": "tiny_added", "source": "https://example.org",
                         "file": "benchmark/configs/tiny_added.json",
                         "reduced": [], "why": "added"})
    b["workloads"].append({"name": "added_cell", "config": "tiny_added",
                           "traffic": "added_mix", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "added_metric", "unit": "units",
                           "better": "higher", "source": "host_clock",
                           "layer": "writers", "moves": "samples_per_s",
                           "workloads": ["added_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    b2 = R.load_bench(str(root))
    w, config, traffic = R.cell_of(b2, "added_cell", str(root))
    assert config["name"] == "tiny_added" and traffic["unit_samples"] == 48
    run, verdict = R.execute(w, config, traffic, 5, 0.2, True, cuda=False,
                             workroot=str(cpu_env), root=str(root))
    assert verdict["correct"]
    out = R.result(b2, run, verdict, cuda=False, root=str(root))
    assert out["metrics"]["added_metric"]["value"] == len(run.rec.units)


def test_no_card_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = R.main(["--workload", "regional_daily_direct", "--seed", "1",
                 "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_are_named(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "usher_tpu.core",
                        types.ModuleType("usher_tpu.core"))
    assert "usher_tpu" in R.forbidden_modules()
    monkeypatch.delitem(sys.modules, "usher_tpu.core")
    for name in list(sys.modules):
        if name.split(".")[0] in R.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    assert R.forbidden_modules() == []
    assert "usher_tpu_torch" not in R.FORBIDDEN


@pytest.mark.card
def test_a_cell_on_the_card(tmp_path, monkeypatch):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark.gen import inputs
    monkeypatch.setattr(inputs, "CACHE", str(tmp_path / "cache"))
    t = tiny_traffic("direct_jobs_1024")
    run, verdict = R.execute(cell("direct_jobs_1024"), TINY, t, 3, 1.0,
                             False, workroot=str(tmp_path))
    assert verdict["correct"] and run.peak_bytes > 0
