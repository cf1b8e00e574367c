"""The cell global_server_direct at a tiny size on the CPU: its driver
(drivers/server_direct_requests.py) agrees with the plain reference over
several requests on one resident tree, through the harness's own window,
check and readers, traced and not; the harness finds the cell's files by
name as it is; and a program without --pb-direct requests fails the cell's
set-up at once."""

import pytest

from benchmark import run as R
from conftest import TINY, cell, tiny_traffic

MIX = "server_direct_requests_64"
CELL = "global_server_direct"
NEW_READERS = {"restore_ms_per_request", "attach_ms_per_request",
               "direct_batch_ms_per_request", "direct_write_ms_per_request",
               "resident_reloads_per_request"}


@pytest.mark.parametrize("trace", [0, 1])
def test_server_direct_driver_agrees_with_reference(cpu_env, trace):
    t = tiny_traffic(MIX)
    c = cell(MIX)
    run, verdict = R.execute(c, TINY, t, 3141592653589, 3.0, bool(trace),
                             cuda=False, workroot=str(cpu_env))
    assert verdict["correct"], verdict
    assert len(run.rec.units) >= 2
    assert verdict["checked_samples"] == 2 * t["unit_samples"]
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
        # the tree is loaded in set-up, never in the window
        assert run.rec.setup_spans["load_pb"]
        assert "load_pb" not in run.rec.spans
        assert out["metrics"]["resident_reloads_per_request"]["value"] == 0
        assert out["breakdown"]["device_ops"] == []   # no card
    else:
        # a CPU run writes no device number
        assert names == {"setup_s", "samples_per_s"}


def test_new_readers_read_nothing_without_the_resident_tree(cpu_env):
    """On a run whose program holds no resident tree (the Tree path's server
    requests: server:request spans, no server:attach) the cell's readers
    report nothing and raise nothing."""
    t = tiny_traffic("server_requests_64")
    run, verdict = R.execute(cell("server_requests_64"), TINY, t,
                             3141592653589, 0.5, True, cuda=False,
                             workroot=str(cpu_env))
    assert verdict["correct"], verdict
    for name in sorted(NEW_READERS):
        assert R.reader("layer_metrics", name)(run) is None, name


def test_parent_program_fails_the_setup_at_once(cpu_env, monkeypatch):
    """A program whose MatStore keeps no resident direct tree fails the
    cell in its set-up, before any request."""
    from usher_tpu_torch.cli.usher_server_cli import MatStore
    monkeypatch.delattr(MatStore, "direct_tree")
    t = tiny_traffic(MIX)
    with pytest.raises(AttributeError):
        R.execute(cell(MIX), TINY, t, 3141592653589, 1.0, False,
                  cuda=False, workroot=str(cpu_env))


def test_cell_found_by_the_harness_as_it_is():
    """The harness finds the cell's configuration, mix, driver and readers
    by their names, and the cell's entries come after every entry the
    benchmark had: what the cell adds is files and entries of its own."""
    bench = R.load_bench()
    w, config, traffic = R.cell_of(bench, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (
        "sc2_global_resident_1m", MIX, 1)
    assert config["generator"]["nodes"] == 1_000_000
    assert traffic["driver"] == "server_direct_requests"
    assert hasattr(R.module("drivers", traffic["driver"]), "Driver")
    layer = R.metrics_for(bench, "per_layer", CELL)
    assert {m["name"] for m in layer} == {"setup_load_s", "device_idle_pct"} \
        | NEW_READERS
    for m in layer:
        assert callable(R.reader("layer_metrics", m["name"]))
    assert {m["name"] for m in R.metrics_for(bench, "end_to_end", CELL)} == {
        "setup_s", "samples_per_s", "peak_device_gib"}
    cells = [w["name"] for w in bench["workloads"]]
    assert cells[:cells.index(CELL)] == [
        "global_daily_direct", "regional_server_tree", "regional_daily_direct"]
    configs = [c["name"] for c in bench["configs"]]
    assert configs[:configs.index("sc2_global_resident_1m")] == [
        "sc2_global_1m", "sc2_regional_100k"]
    layer_names = [m["name"] for m in bench["per_layer"]]
    i = layer_names.index("restore_ms_per_request")
    assert set(layer_names[i:i + len(NEW_READERS)]) == NEW_READERS
    assert not {m.get("workloads", [""])[0] for m in bench["per_layer"][:i]} \
        & {CELL}
    assert all(m["workloads"] == [CELL] for m in bench["per_layer"]
               if m["name"] in NEW_READERS)
