"""Each driver's outputs agree with the plain reference at a tiny size on
the CPU, through the harness's own window, check and readers."""

import pytest

from benchmark import run as R
from conftest import cell, tiny_config, tiny_traffic

MIXES = ["direct_jobs_2048", "direct_jobs_1024", "server_requests_64",
         "socket_requests_64"]
CELLS = {"direct": "regional_daily_direct", "server": "regional_server_tree",
         "socket": "regional_sampled_socket"}


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("trace", [0, 1])
def test_driver_agrees_with_reference(cpu_env, mix, trace):
    t = tiny_traffic(mix)
    c = cell(mix)
    run, verdict = R.execute(c, tiny_config(mix), t, 1234567890123, 0.5,
                             bool(trace), cuda=False, workroot=str(cpu_env))
    assert verdict["correct"], verdict
    assert verdict["checked_samples"] >= t["unit_samples"]
    assert all(v["value"] == 0 for v in verdict["compared"].values())
    assert run.rec.samples == len(run.rec.units) * t["unit_samples"]
    bench = R.load_bench()
    kind = mix.split("_")[0]
    c["name"] = CELLS[kind]
    out = R.result(bench, run, verdict, cuda=False)
    assert list(out)[-1] == "compared"
    names = set(out["metrics"])
    if trace:
        # the host's readers report on the CPU too; the device's do not
        want = {
            "direct": {"setup_load_s", "load_ms_per_job", "flush_ms_per_batch",
                       "direct_host_ms_per_batch", "write_ms_per_job",
                       "direct_load_ms_per_job", "batch_ranks_ms_per_batch",
                       "bigmat_flush_ms_per_batch", "flushes_per_batch",
                       "host_rescore_pct", "resolve_apply_ms_per_batch",
                       "direct_write_ms_per_job"},
            "server": {"setup_load_s", "reload_ms_per_request",
                       "apply_batch_ms_per_sample", "flat_build_ms_per_request",
                       "score_batch_ms_per_request", "write_ms_per_request",
                       "matstore_reload_ms_per_request",
                       "rescore_ms_per_request", "rescored_sample_pct"},
            "socket": {"setup_load_s", "tree_copy_ms_per_request",
                       "engine_build_ms_per_request",
                       "sampled_rescore_ms_per_request",
                       "sampled_rescored_pct",
                       "socket_write_ms_per_request"}}[kind]
        assert names == want
        assert out["breakdown"]["device_ops"] == []   # no card
    else:
        assert {"setup_s", "samples_per_s"} <= names
        assert ("sample_p95_ms" in names) == ("direct" in mix)
        # a CPU run writes no device number
        assert "peak_device_gib" not in names
