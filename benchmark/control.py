"""The control of the comparison that decides `correct`, at a cell's own
size: the plain reference without its host corrections (each batch scored
against the tree as the batch began, then applied in order, no sample
scored again) put in the program's place, on the units a run would check,
held by the run's own comparison against the reference that the cell's
configuration names (`check.reference`: UShER's sequential placement, or
usher-sampled's batch placement with its retries).

    python3 benchmark/control.py --workload <name> --seed <n> [<n> ...]

Prints, per seed, the numbers compared and whether the control came out
correct (it must not); a card is used where there is one.  The benchmark's
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def held_against(config: dict, traffic: dict, units: list, base) -> dict:
    """The run's comparison of the control's outputs on `units` with the
    outputs of the reference that `config` names: its counts, summed."""
    from benchmark.reference import check, placer
    placer_of = check.reference(config)
    totals = dict.fromkeys(check.LIMITS, 0)
    for unit in units:
        exact = placer_of(base).run(unit, batch_size=traffic["batch_size"])
        ctl = placer.Placer(base).run(unit, batch_size=traffic["batch_size"],
                                      snapshot=True)
        got = ({ln.split("\t", 1)[0]: ln for ln in ctl[0]},
               {ln.split("\t", 1)[0]: ln for ln in ctl[1]}, ctl[2])
        for key, v in check.compare(unit["names"], exact, got).items():
            totals[key] += v
    return totals


def control(cell: str, seed: int, device: str) -> dict:
    from benchmark import run as R
    from benchmark.gen import inputs as ginputs
    from benchmark.gen.mat import node_names
    from benchmark.reference import check, placer
    bench = R.load_bench()
    w, config, traffic = R.cell_of(bench, cell)
    inp = ginputs.prepare(config, traffic, seed, 1.0)
    base = placer.BaseTree(inp["mat"], node_names(inp["mat"]), device)
    t0 = time.perf_counter()
    picked = check.pick_units(seed, list(range(1, len(inp["units"]))),
                              traffic["check_units"])
    totals = held_against(config, traffic, [inp["units"][k] for k in picked],
                          base)
    correct = all(totals[k] <= check.LIMITS[k] for k in check.LIMITS)
    return {"workload": cell, "seed": seed, "control_correct": correct,
            "seconds": time.perf_counter() - t0, **totals}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, nargs="+", required=True)
    args = p.parse_args()
    import torch
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for s in args.seed:
        print(json.dumps(control(args.workload, s, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
