"""The comparison that decides `correct`.

Units (jobs or requests) are drawn from the seed among those the window
finished, the mix's `check_units` of them, or all where it finished no
more; for each, the plain reference of the semantics that the
configuration names places the same samples in the same order, in the
mix's batches, onto its own copy of the generated tree, and the program's
placement_stats.tsv, mutation-paths.txt and final-tree.nh are held
against what it writes, byte for byte.  A configuration names them under
`"reference"`: `"sequential"` (UShER's, `placer.py`; where the key is
absent) or `"sampled_batch"` (usher-sampled's, `sampled.py`).  Each number
compared is a count with the limit 0: the configuration guarantees exact
outputs.
"""

from __future__ import annotations

import os

import numpy as np

from ..gen.mat import node_names
from . import placer, sampled

LIMITS = {"wrong_samples": 0, "missing_samples": 0, "wrong_trees": 0}


REFERENCES = {"sequential": placer.Placer,
              "sampled_batch": sampled.SampledBatchPlacer}


def reference(config: dict):
    """The plain placer of the semantics the configuration names."""
    return REFERENCES[config.get("reference", "sequential")]


def read_program(outdir: str):
    """The program's outputs of one unit: (stats by sample, paths by
    sample, final tree or None)."""
    def lines(name):
        path = os.path.join(outdir, name)
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return {ln.split("\t", 1)[0]: ln for ln in f}
    tree = os.path.join(outdir, "final-tree.nh")
    nwk = None
    if os.path.exists(tree):
        with open(tree) as f:
            nwk = f.read()
    return lines("placement_stats.tsv"), lines("mutation-paths.txt"), nwk


def compare(names, ref, got) -> dict:
    """Counts of samples whose lines differ or are missing, and whether the
    final tree differs."""
    stats, paths, nwk = ref
    g_stats, g_paths, g_nwk = got
    wrong = missing = 0
    for name, s, p in zip(names, stats, paths):
        if name not in g_stats or name not in g_paths:
            missing += 1
        elif g_stats[name] != s or g_paths[name] != p:
            wrong += 1
    return {"wrong_samples": wrong, "missing_samples": missing,
            "wrong_trees": int(g_nwk != nwk)}


def pick_units(seed: int, done: list, n: int) -> list:
    rng = np.random.default_rng(np.random.SeedSequence([seed, 99]))
    n = min(n, len(done))
    return sorted(rng.choice(done, size=n, replace=False).tolist())


def check(run, inputs: dict, work: str, device: str) -> dict:
    mat = inputs["mat"]
    base = placer.BaseTree(mat, node_names(mat), device)
    done = [k for k, _, _ in run.rec.units]
    placer_of = reference(run.config)
    totals = dict.fromkeys(LIMITS, 0)
    checked = 0
    for k in pick_units(run.seed, done, run.traffic["check_units"]):
        unit = inputs["units"][k]
        ref = placer_of(base).run(unit, batch_size=run.traffic["batch_size"])
        got = read_program(os.path.join(work, f"unit_{k}"))
        for key, v in compare(unit["names"], ref, got).items():
            totals[key] += v
        checked += len(unit["names"])
    del base
    compared = {k: {"value": totals[k], "limit": LIMITS[k]} for k in LIMITS}
    ok = checked > 0 and all(totals[k] <= LIMITS[k] for k in LIMITS)
    return {"correct": ok, "compared": compared, "checked_samples": checked,
            "failed": totals["wrong_samples"] + totals["missing_samples"]}
