"""The harness's own rules: a run that uses up its units gives no result,
an untraced run spies only on what its end-to-end readers read, and a spy
target that the program no longer has is left out instead of failing the
run."""

import pytest

from benchmark import harness
from benchmark import run as R
from conftest import TINY, cell, tiny_traffic

MIX = "direct_jobs_1024"


def test_units_ran_out_is_no_result(cpu_env):
    t = tiny_traffic(MIX, max_samples_per_s=1)
    with pytest.raises(R.UnitsRanOut):
        R.execute(cell(MIX), TINY, t, 8, 30.0, False, cuda=False,
                  workroot=str(cpu_env))


@pytest.mark.parametrize("mix", [MIX, "server_requests_64"])
def test_untraced_run_spies_only_for_end_to_end(cpu_env, mix):
    t = tiny_traffic(mix)
    run, verdict = R.execute(cell(mix), TINY, t, 9, 0.2, False, cuda=False,
                             workroot=str(cpu_env))
    assert verdict["correct"]
    driver = R.module("drivers", t["driver"]).Driver
    spied = set(run.rec.spans) | set(run.rec.setup_spans)
    assert spied <= set(driver.E2E_KEYS)
    assert run.rec.unspied == []
    if driver.E2E_KEYS:
        assert run.rec.latency_s


def test_vanished_target_is_left_out(cpu_env, monkeypatch):
    real = R.module

    def module(kind, name, root=R.ROOT):
        mod = real(kind, name, root)
        if kind == "drivers":
            orig = mod.Driver.targets

            def renamed(self):
                return [(spec.replace("BigMAT._flush", "BigMAT._flush_gone"),
                         key) for spec, key in orig(self)] + [
                    ("usher_tpu_torch.no_such_module:f", "gone")]
            mod.Driver.targets = renamed
        return mod
    monkeypatch.setattr(R, "module", module)
    t = tiny_traffic(MIX)
    c = dict(cell(MIX), name="regional_daily_direct")   # its readers
    run, verdict = R.execute(c, TINY, t, 10, 0.2, True, cuda=False,
                             workroot=str(cpu_env))
    assert verdict["correct"]
    assert run.rec.unspied == [
        "usher_tpu_torch.core.bigmat:BigMAT._flush_gone",
        "usher_tpu_torch.no_such_module:f"]
    out = R.result(R.load_bench(), run, verdict, cuda=False)
    assert "flush_ms_per_batch" not in out["metrics"]
    assert "direct_host_ms_per_batch" in out["metrics"]


def test_resolve():
    assert harness.resolve("os.path:join") is not None
    assert harness.resolve("os.path:no_such") is None
    assert harness.resolve("no_such_module:f") is None
    assert harness.resolve("benchmark.harness:Record.window_s") is not None
    assert harness.resolve("benchmark.harness:Record.nothing") is None
