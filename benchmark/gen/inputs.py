"""A run's inputs from its seed, cached per configuration and seed.

The tree of a configuration (`generate` of its file's sizes), written as a
pb, and the units of work of a traffic mix (jobs or requests), each a VCF
and its samples' arrays, are made from `--seed` alone: the same seed gives
the same files.  They live in `benchmark/.cache/<config>/<seed>/`, written
under a temporary name and renamed, and the cache is trimmed to
`CACHE_CAP` bytes, the least recently used seeds first.
"""

from __future__ import annotations

import math
import os
import shutil
import time

import numpy as np

from . import mat as gmat
from . import pbwrite
from . import samples as gsamples

CACHE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".cache")
CACHE_CAP = 4 << 30
MAT_KEYS = ("parent", "depth", "size", "is_leaf", "num_leaves", "mut_ptr",
            "mut_col", "mut_par", "mut_mut", "ref", "positions")


def _stream(seed: int, *salt: int):
    return np.random.default_rng(np.random.SeedSequence([seed, *salt]))


def _atomic(path: str, write) -> None:
    tmp = f"{path}.part"
    write(tmp)
    os.replace(tmp, path)


def _save_npz(path, **arrays):
    def w(tmp):
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
    _atomic(path, w)


def _trim(keep: str) -> None:
    seeds = []
    for cfg in os.listdir(CACHE):
        for s in os.listdir(os.path.join(CACHE, cfg)):
            d = os.path.join(CACHE, cfg, s)
            size = sum(os.path.getsize(os.path.join(r, f))
                       for r, _, fs in os.walk(d) for f in fs)
            seeds.append((os.path.getmtime(d), d, size))
    total = sum(s for _, _, s in seeds)
    for _, d, size in sorted(seeds):
        if total <= CACHE_CAP:
            break
        if os.path.abspath(d) != os.path.abspath(keep):
            shutil.rmtree(d, ignore_errors=True)
            total -= size


def units_needed(traffic: dict, seconds: float) -> int:
    """Units a run may use: one to warm up, and as many as the window could
    finish at `max_samples_per_s`, plus one that is still running when it
    closes."""
    return 2 + math.ceil(seconds * traffic["max_samples_per_s"]
                         / traffic["unit_samples"])


def unit_size(traffic: dict, k: int) -> int:
    """Samples of unit k: unit 0, the warm-up through the same entry, has
    the mix's `warmup_samples` (one batch where it names none); the
    window's units are the mix's size."""
    if k:
        return traffic["unit_samples"]
    return traffic.get("warmup_samples", traffic["batch_size"])


def prepare(config: dict, traffic: dict, seed: int, seconds: float) -> dict:
    """Make or find the run's inputs.  Returns {"pb", "mat", "units":
    [{"vcf", "names", "ptr", "col", "nuc"}], "gen_s"}; unit 0 warms up
    with one batch."""
    t0 = time.perf_counter()
    d = os.path.join(CACHE, config["name"], str(seed))
    os.makedirs(d, exist_ok=True)
    os.utime(d)
    pb = os.path.join(d, "tree.pb")
    mpath = os.path.join(d, "mat.npz")
    g = config["generator"]
    if not (os.path.exists(pb) and os.path.exists(mpath)):
        mat = gmat.generate(_stream(seed, 1), g["nodes"], g["sites"],
                            g["branch_mutations"])
        _save_npz(mpath, **{k: mat[k] for k in MAT_KEYS})
        _atomic(pb, lambda tmp: pbwrite.write_pb(mat, tmp))
    else:
        with np.load(mpath) as z:
            mat = {k: z[k] for k in MAT_KEYS}
    td = os.path.join(d, traffic["name"])
    os.makedirs(td, exist_ok=True)
    n = units_needed(traffic, seconds)
    units = []
    for k in range(n):
        vcf = os.path.join(td, f"unit_{k}.vcf")
        arr = os.path.join(td, f"unit_{k}.npz")
        if not (os.path.exists(vcf) and os.path.exists(arr)):
            job = gsamples.draw_job(_stream(seed, 3, k), mat, traffic,
                                    unit_size(traffic, k), f"s{k}")
            _atomic(vcf, lambda tmp: gsamples.write_vcf(tmp, job, mat))
            _save_npz(arr, names=np.array(job["names"]), ptr=job["ptr"],
                      col=job["col"], nuc=job["nuc"])
        with np.load(arr) as z:
            units.append(dict(vcf=vcf, names=z["names"].tolist(),
                              ptr=z["ptr"], col=z["col"], nuc=z["nuc"]))
    _trim(d)
    return dict(pb=pb, mat=mat, units=units,
                gen_s=time.perf_counter() - t0)
