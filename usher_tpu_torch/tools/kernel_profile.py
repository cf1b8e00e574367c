"""Where a row group's time goes in the B1 kernel, and what each lanes choice
costs, on one CUDA card.

    python -m usher_tpu_torch.tools.kernel_profile            # phase profile
    python -m usher_tpu_torch.tools.kernel_profile --lanes    # lanes sweep

The phase profile builds the kernel library with -DUSHER_PROFILE, which
puts clock64() reads around the phases of score_entries_kernel's row-group
loop (waiting for the stage, the sweep, the block barrier, scoring and
stores, releasing the stage), launches B1 fused and with caller-given row
sums at the shapes below and prints, per shape, the kernel's ms (CUDA events
around the launch alone, median of 7) and the mean cycles and share of each
phase over the blocks, as one thread of every block saw them.  The profiled
kernel is a few percent slower than the real one; the shares are what it is
for.

The lanes sweep times direct launches of the real B1 kernel, fused and with
given sums, with the launch plan's lanes set to 1, 2, ... 32, which is how
ops/placement_sparse.py::launch_plan's rule was chosen.

States are synthetic: the reference row with a random base in a share
`rate` of the cells (0.01: most 512-column units hold several words that
differ from ref; 0.0005: a few a row, as on a tree), parents at random.
One JSON object a line.  Needs nvcc and a card; imports no jax.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess

import numpy as np
import torch

from ..ops import _build
from ..ops import placement_sparse as ps

SHAPES = {  # name: N, P, B, K, entries a sample
    "main_batch": (125_056, 30_080, 64, 64, 28),
    "prepass": (125_056, 30_080, 1024, 64, 28),
    "genome": (100_000, 30_000, 1024, 32, 32),
    "headline": (100_000, 512, 1024, 16, 16),
    "spr": (1_000_000, 1440, 64, 32, 24),
}
LANES_SHAPES = dict(SHAPES, **{
    "mesh_shard_batch": (62_528, 30_080, 32, 64, 28),
    "mesh_shard_prepass": (62_528, 30_080, 128, 64, 28),
    "mid_b256": (125_056, 30_080, 256, 64, 28),
    "headline_b64": (100_000, 512, 64, 16, 16),
})
PHASES = ("wait", "sweep", "barrier", "score", "release")


def synth(N, P, B, K, entries, rate, seed=0):
    """(st, stp, ref, pos, gval, kmiss) on the card."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    nib = torch.tensor([1, 2, 4, 8], dtype=torch.uint8, device=dev)
    ref = nib[torch.randint(0, 4, (P,), device=dev, generator=g)]
    st = ref[None, :].repeat(N, 1)
    hit = torch.rand((N, P), device=dev, generator=g) < rate
    st = torch.where(
        hit, nib[torch.randint(0, 4, (N, P), device=dev, generator=g)], st)
    del hit
    parent = (torch.rand(N, device=dev, generator=g)
              * torch.arange(N, device=dev)).long()
    stp = st[parent]
    pos = torch.full((B, K), P, dtype=torch.int32, device=dev)
    pos[:, :entries] = torch.randint(0, P, (B, entries), device=dev,
                                     generator=g).int()
    gval = torch.randint(1, 16, (B, K), device=dev,
                         generator=g).to(torch.uint8)
    kmiss = torch.rand((B, K), device=dev, generator=g) < 0.1
    return st, stp, ref, pos, gval, kmiss


def event_ms(fn, runs=7):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def b1_launcher(lib, st, stp, ref, sums_in, pos, gval, kmiss, lanes=None):
    """A closure that launches B1 alone: fused when sums_in is None, with
    the plan's lanes replaced by `lanes` when given."""
    N, B = st.shape[0], pos.shape[0]
    base, nc_base = (None, None) if sums_in is None else sums_in[:2]
    launch = ps._launch_args(st, stp, ref, base, nc_base, pos, gval, kmiss)
    if lanes is not None:
        plan = launch.plan._replace(lanes=lanes)
        launch = launch._replace(
            head=launch.head[:-len(plan)] + tuple(plan), plan=plan)
    out = [torch.empty((N, B), dtype=torch.int32, device=st.device)
           for _ in range(2)]
    sums = torch.empty((3, N), dtype=torch.int32, device=st.device)

    def fn():
        err = lib.usher_score_entries_T(
            *launch.head, 0, out[0].data_ptr(), out[1].data_ptr(),
            sums.data_ptr() if sums_in is None else None, *launch.tail)
        _build.check(err, "usher_score_entries_T")
    return fn, launch


def phase_profile(rate):
    lib = _build.load_library(("USHER_PROFILE",))
    lib.usher_prof_read.argtypes = [ctypes.c_void_p]
    for name, shape in SHAPES.items():
        st, stp, ref, pos, gval, kmiss = synth(*shape, rate)
        given = ps.row_reductions(st, stp, ref)
        for fused in (True, False):
            fn, launch = b1_launcher(lib, st, stp, ref,
                                     None if fused else given, pos, gval,
                                     kmiss)
            ms = event_ms(fn)
            buf = (ctypes.c_longlong * (256 * 8))()
            _build.check(lib.usher_prof_read(buf), "usher_prof_read")
            prof = np.array(buf[:]).reshape(256, 8)[:launch.plan.grid, :5]
            print(json.dumps({
                "shape": name, "NPBK": shape[:4], "rate": rate,
                "fused": fused, "plan": tuple(launch.plan), "kernel_ms": ms,
                "mean_cycles": dict(zip(PHASES,
                                        prof.mean(0).round().tolist())),
                "share": dict(zip(PHASES, (prof.sum(0) / prof.sum())
                                  .round(3).tolist()))}), flush=True)
        del st, stp
        torch.cuda.empty_cache()


def lanes_sweep(rate):
    lib = _build.load_library()
    for name, shape in LANES_SHAPES.items():
        N, P, B, K, _ = shape
        st, stp, ref, pos, gval, kmiss = synth(*shape, rate)
        given = ps.row_reductions(st, stp, ref)
        out = {"shape": name, "NPBK": shape[:4], "rate": rate,
               "plan_b1": ps.launch_plan(P, B, K, True).lanes}
        for lanes in (1, 2, 4, 8, 16, 32):
            row = {"b1_fused_ms": event_ms(b1_launcher(
                       lib, st, stp, ref, None, pos, gval, kmiss, lanes)[0],
                       5),
                   "b1_given_ms": event_ms(b1_launcher(
                       lib, st, stp, ref, given, pos, gval, kmiss, lanes)[0],
                       5)}
            out[f"lanes_{lanes}"] = {k: round(v, 3) for k, v in row.items()}
        print(json.dumps(out), flush=True)
        del st, stp
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes", action="store_true",
                    help="time every lanes choice instead of the phases")
    ap.add_argument("--rate", type=float, default=0.0005,
                    help="share of cells that differ from the reference")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_profile: torch sees no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__}), flush=True)
    (lanes_sweep if args.lanes else phase_profile)(args.rate)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
