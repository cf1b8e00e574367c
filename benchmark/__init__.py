"""Benchmark of usher_tpu_torch: one cell a run, driven by BENCHMARK.json.

`python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>` runs one cell once.  Each configuration is a file under
`configs/`, each traffic mix a file under `traffic/` that names its driver
under `drivers/`, each end-to-end metric a reader under `e2e_metrics/` and
each per-layer metric a reader under `layer_metrics/`; the harness finds
them by the names in BENCHMARK.json.
"""
