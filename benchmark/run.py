"""One run of one benchmark cell of usher_tpu_torch.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Makes (or finds in `benchmark/.cache/`) the cell's inputs from the seed,
does the program's set-up, warms up through the cell's own entry with one
small unit (one batch, or the mix's `warmup_samples`), then runs whole
units (jobs or requests) in a closed loop until `--seconds` have passed,
and checks the outputs of units drawn from the seed against the plain
reference.  A run that uses up the units made for it (the mix's
`max_samples_per_s`) fails with no result (exit 4).  The last line of
standard output is one JSON object; the numbers compared, each beside its
limit, are the last lines of standard error.  `--trace 1` runs the window
under torch.profiler and prints the cell's per-layer metrics instead of
its end-to-end ones.  Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse                       # noqa: E402
import contextlib                     # noqa: E402
import importlib.util                 # noqa: E402
import json                           # noqa: E402
import os                             # noqa: E402
import shutil                         # noqa: E402
import subprocess                     # noqa: E402
import sys                            # noqa: E402
import tempfile                       # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = {"jax", "jaxlib", "flax", "usher_tpu"}


class UnitsRanOut(RuntimeError):
    """The window used every unit made for it."""


def log(*a) -> None:
    print(*a, file=sys.__stderr__, flush=True)


def load_bench(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_of(bench: dict, name: str, root: str = ROOT):
    """(workload, configuration file, traffic file) of the cell `name`:
    the configuration's file as BENCHMARK.json names it, the mix from
    `benchmark/traffic/<traffic>.json`."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(os.path.join(root, cfg["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic",
                           w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return w, config, traffic


def metrics_for(bench: dict, group: str, cell: str) -> list:
    return [m for m in bench[group]
            if "workloads" not in m or cell in m["workloads"]]


def module(kind: str, name: str, root: str = ROOT):
    """benchmark/<kind>/<name>.py of the checkout at `root`."""
    path = os.path.join(root, "benchmark", kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name}", path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(kind: str, name: str, root: str = ROOT):
    return module(kind, name, root).read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def card_line() -> str:
    """nvidia-smi's reading of the card: name, clocks, power, limit."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.mem,"
             "power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read: {e}"


class Run:
    """Everything a metric reader may read about one run."""

    def __init__(self, cell, config, traffic, seed, seconds, trace):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.rec = None
        self.setup_s = None
        self.gen_s = None
        self.peak_bytes = 0


def execute(cell, config, traffic, seed: int, seconds: float, trace: bool,
            cuda: bool = True, t_process: float | None = None,
            workroot: str | None = None,
            root: str = ROOT) -> tuple[Run, dict]:
    """Set up, warm up, run the window and check one unit: (run, verdict).
    With cuda=False (the CPU tests) the device readings are skipped."""
    import torch
    from benchmark import harness
    from benchmark.gen import inputs as ginputs
    from benchmark.reference import check
    t_process = T_PROCESS if t_process is None else t_process
    run = Run(cell, config, traffic, seed, seconds, trace)
    inputs = ginputs.prepare(config, traffic, seed, seconds)
    run.gen_s = inputs["gen_s"]
    log(f"inputs: {run.gen_s:.3f} s to make or load (not set-up): "
        f"{len(inputs['units'])} units of {traffic['unit_samples']} samples")
    work = tempfile.mkdtemp(prefix="bench_", dir=workroot)
    rec = harness.Record()
    run.rec = rec
    driver = module("drivers", traffic["driver"], root).Driver(inputs,
                                                              traffic)
    driver.workdir = work
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    units = inputs["units"]
    program_log = open(os.path.join(work, "program.log"), "w")
    try:
        with harness.spying(driver.targets(), rec, trace,
                            driver.hooks(rec),
                            None if trace else driver.E2E_KEYS), \
                contextlib.redirect_stderr(program_log), \
                contextlib.redirect_stdout(program_log):
            driver.setup()
            driver.run_unit(0, os.path.join(work, "warmup"))
            if cuda:
                torch.cuda.synchronize()
            inst_path = os.path.join(work, "spans.json")
            inst = harness.instrumentor() if trace else None
            if inst is not None:
                inst.begin_session(inst_path)
            prof = None
            if trace:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if cuda:
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
                prof.__enter__()
            rec.live = True
            rec.t_start = time.perf_counter()
            run.setup_s = rec.t_start - t_process - run.gen_s
            k = 1
            while time.perf_counter() - rec.t_start < seconds:
                if k >= len(units):
                    raise UnitsRanOut(
                        f"the window used all {len(units) - 1} units made "
                        "for it: the program is faster than the mix's "
                        "max_samples_per_s, which a benchmark change has "
                        "to raise")
                n = driver.run_unit(k, os.path.join(work, f"unit_{k}"))
                if cuda:
                    torch.cuda.synchronize()
                rec.units.append((k, n, time.perf_counter()))
                k += 1
            rec.t_end = rec.units[-1][2]
            rec.live = False
            if prof is not None:
                prof.__exit__(None, None, None)
            if inst is not None:
                inst.end_session()
        if cuda:
            run.peak_bytes = torch.cuda.max_memory_allocated()
        if prof is not None:
            tpath = os.path.join(work, "trace.json")
            prof.export_chrome_trace(tpath)
            del prof
            rec.trace = harness.Trace.load(tpath)
            os.remove(tpath)
            if inst is not None:
                rec.program_spans = harness.read_instrumentor(inst_path)
        driver.release()
        if cuda:
            torch.cuda.empty_cache()
        verdict = check.check(run, inputs, work,
                              "cuda" if cuda else "cpu")
    finally:
        program_log.close()
        shutil.rmtree(work, ignore_errors=True)
    return run, verdict


def result(bench, run: Run, verdict: dict, cuda: bool = True,
           root: str = ROOT) -> dict:
    import torch
    group = "per_layer" if run.trace else "end_to_end"
    kind = "layer_metrics" if run.trace else "e2e_metrics"
    metrics = {}
    for m in metrics_for(bench, group, run.cell["name"]):
        v = reader(kind, m["name"], root)(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": run.cell["chips"],
              "memory_peak_bytes": run.peak_bytes}
    out = {"correct": verdict["correct"],
           "attempted": run.rec.samples,
           "failed": verdict["failed"],
           "metrics": metrics, "device": device}
    if run.trace and run.rec.trace is not None:
        tr = run.rec.trace
        device["busy_s"] = tr.busy_s()
        device["window_s"] = run.rec.window_s
        out["breakdown"] = {
            "device_ops": [list(p) for p in tr.top_ops()],
            "idle_gaps": [list(p) for p in tr.idle_by_span(tr.t0_us,
                                                           tr.t1_us)]}
    out["compared"] = verdict["compared"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load_bench()
    cell, config, traffic = cell_of(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        log(f"no result: {cell['name']} needs {cell['chips']} CUDA card(s), "
            f"torch sees {torch.cuda.device_count()}")
        return 2
    log(f"card: {card_line()}")
    try:
        run, verdict = execute(cell, config, traffic, args.seed,
                               args.seconds, bool(args.trace))
    except UnitsRanOut as e:
        log(f"no result: {e}")
        return 4
    bad = forbidden_modules()
    if bad:
        log(f"no result: the run loaded {', '.join(bad)}")
        return 3
    out = result(bench, run, verdict)
    log(f"card after the window: {card_line()}")
    done = [t for _, _, t in run.rec.units]
    took = [b - a for a, b in zip([run.rec.t_start] + done, done)]
    if run.rec.unspied:
        log("not spied (the program lacks them): "
            + ", ".join(run.rec.unspied))
    log(f"setup_s {run.setup_s:.4f}, window {run.rec.window_s:.4f} s, "
        f"{len(run.rec.units)} units, {run.rec.samples} samples, unit s "
        + " ".join(f"{t:.3f}" for t in took))
    for k, v in verdict["compared"].items():
        log(f"compared {k}: {v['value']} (limit {v['limit']})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
