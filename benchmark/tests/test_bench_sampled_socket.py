"""The cell regional_sampled_socket at a tiny size on the CPU: its driver
(drivers/socket_requests.py) agrees with the plain reference of
usher-sampled's batch placement (reference/sampled.py) through the
harness's own window, check and readers, traced and not; the two
references differ on some units, and there the sequential check marks the
daemon wrong and the batch check marks it right; the reference follows
`place_batch` over several batches too; the harness finds the cell's files
by name as it is."""

import functools

import pytest

from benchmark import run as R
from benchmark.gen import inputs as ginputs
from benchmark.gen.mat import node_names
from benchmark.reference import check, placer
from conftest import SAMPLED, TINY, cell, tiny_traffic

MIX = "socket_requests_64"
CELL = "regional_sampled_socket"
NEW_READERS = {"tree_copy_ms_per_request", "engine_build_ms_per_request",
               "sampled_rescore_ms_per_request", "sampled_rescored_pct",
               "socket_write_ms_per_request"}


@pytest.mark.parametrize("trace", [0, 1])
def test_socket_driver_agrees_with_batch_reference(cpu_env, trace):
    t = tiny_traffic(MIX)
    c = cell(MIX)
    run, verdict = R.execute(c, SAMPLED, t, 2718281828459, 1.0, bool(trace),
                             cuda=False, workroot=str(cpu_env))
    assert verdict["correct"], verdict
    # the warm-up request went to the same loaded tree before these
    checked = min(2, len(run.rec.units))
    assert checked >= 1
    assert verdict["checked_samples"] == checked * t["unit_samples"]
    assert all(v["value"] == 0 for v in verdict["compared"].values())
    assert run.rec.samples == len(run.rec.units) * t["unit_samples"]
    assert not run.rec.unspied
    c["name"] = CELL
    out = R.result(R.load_bench(), run, verdict, cuda=False)
    assert list(out)[-1] == "compared"
    names = set(out["metrics"])
    if trace:
        # the host's readers report on the CPU too; the device's do not
        assert names == {"setup_load_s"} | NEW_READERS
        # the tree is loaded in set-up; each request copies it once
        assert run.rec.setup_spans["load_pb"]
        assert "load_pb" not in run.rec.spans
        assert run.rec.count("copy") == len(run.rec.units)
        assert 0 < out["metrics"]["sampled_rescored_pct"]["value"] <= 200
        assert out["breakdown"]["device_ops"] == []   # no card
    else:
        # a CPU run writes no device number
        assert names == {"setup_s", "samples_per_s"}


def _daemon_outputs(inp, k, outdir):
    from usher_tpu_torch.cli.usher_socket_server_cli import (TreeCollection,
                                                             handle_request)
    trees = TreeCollection([inp["pb"]])
    reply = handle_request(["-i", inp["pb"], "-v", inp["units"][k]["vcf"],
                            "-d", outdir], trees)
    assert b"request failed" not in reply and reply.endswith(b"\x04\n")
    return check.read_program(outdir)


def test_sequential_check_fails_where_the_semantics_differ(cpu_env):
    """Seed 12's first request at the tiny size: usher-sampled's batch
    placement and UShER's sequential one place some samples differently,
    so the daemon's outputs are right by the batch reference, which the
    configuration names, and wrong by the sequential one."""
    t = tiny_traffic(MIX)
    inp = ginputs.prepare(SAMPLED, t, 12, 0.01)
    got = _daemon_outputs(inp, 1, str(cpu_env / "out"))
    base = placer.BaseTree(inp["mat"], node_names(inp["mat"]), "cpu")
    unit = inp["units"][1]
    by = {}
    for config in (TINY, SAMPLED):
        ref = check.reference(config)(base).run(unit, t["batch_size"])
        by[config.get("reference")] = check.compare(unit["names"], ref, got)
    assert by["sampled_batch"] == {"wrong_samples": 0, "missing_samples": 0,
                                   "wrong_trees": 0}
    assert by[None]["wrong_samples"] > 0 and by[None]["wrong_trees"] == 1


def test_reference_follows_place_batch_over_batches(cpu_env, monkeypatch):
    """With batches of 8 (the touched set begins anew with each batch) the
    daemon and the batch reference still agree byte for byte, where the
    sequential reference differs."""
    from usher_tpu_torch.placement import sampled
    monkeypatch.setattr(sampled, "place_batch",
                        functools.partial(sampled.place_batch, batch_size=8))
    t = tiny_traffic(MIX, batch_size=8)
    inp = ginputs.prepare(SAMPLED, t, 4, 0.01)
    got = _daemon_outputs(inp, 2, str(cpu_env / "out"))
    base = placer.BaseTree(inp["mat"], node_names(inp["mat"]), "cpu")
    unit = inp["units"][2]
    ref = check.reference(SAMPLED)(base).run(unit, 8)
    assert check.compare(unit["names"], ref, got) == {
        "wrong_samples": 0, "missing_samples": 0, "wrong_trees": 0}
    seq = check.reference(TINY)(base).run(unit, 8)
    assert check.compare(unit["names"], seq, got)["wrong_samples"] > 0


def test_configuration_names_the_reference():
    """Only the new configuration names a reference; the others keep
    UShER's sequential placement, as before the key existed."""
    bench = R.load_bench()
    for c in bench["configs"]:
        _, config, _ = R.cell_of(bench, next(
            w["name"] for w in bench["workloads"] if w["config"] == c["name"]))
        want = ("sampled_batch" if c["name"] == "sc2_regional_sampled_100k"
                else "sequential")
        assert config.get("reference", "sequential") == want
    assert check.reference({}) is placer.Placer
    with pytest.raises(KeyError):
        check.reference({"reference": "no_such_semantics"})


def test_cell_found_by_the_harness_as_it_is():
    """The harness finds the cell's configuration, mix, driver and readers
    by their names, and the cell's entries come after every entry the
    benchmark had: what the cell adds is files and entries of its own."""
    bench = R.load_bench()
    w, config, traffic = R.cell_of(bench, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (
        "sc2_regional_sampled_100k", MIX, 1)
    _, regional, server = R.cell_of(bench, "regional_server_tree")
    assert config["generator"] == regional["generator"]
    assert traffic["driver"] == "socket_requests"
    assert traffic["batch_size"] == 256
    assert {k: traffic[k] for k in ("clade_ladder", "private_substitutions",
                                    "n_calls")} == {
        k: server[k] for k in ("clade_ladder", "private_substitutions",
                               "n_calls")}
    assert hasattr(R.module("drivers", traffic["driver"]), "Driver")
    layer = R.metrics_for(bench, "per_layer", CELL)
    assert {m["name"] for m in layer} == {
        "setup_load_s", "device_idle_pct", "b1_roofline",
        "gather_ms_per_batch"} | NEW_READERS
    for m in layer:
        assert callable(R.reader("layer_metrics", m["name"]))
    assert {m["name"] for m in R.metrics_for(bench, "end_to_end", CELL)} == {
        "setup_s", "samples_per_s", "peak_device_gib"}
    assert bench["workloads"][-1]["name"] == CELL
    assert bench["configs"][-1]["name"] == "sc2_regional_sampled_100k"
    tail = [m["name"] for m in bench["per_layer"][-len(NEW_READERS):]]
    assert set(tail) == NEW_READERS
    assert all(m["workloads"] == [CELL] for m in bench["per_layer"]
               if m["name"] in NEW_READERS)
