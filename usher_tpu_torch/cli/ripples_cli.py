"""ripples CLI of the port: detect recombination in a MAT, with the cost
matrix (X13) on the device that USHER_TPU_PLATFORM names (cuda by default).

Counterpart of usher_tpu/cli/ripples_cli.py with the same flags, files,
messages and exit codes; the flag surface mirrors the reference ripples
(src/ripples/main.cpp:22-44).
"""

from __future__ import annotations

import argparse
import sys

from ..io.pbio import load_mat_pb
from ..ripples import RipplesOptions, ripples_main
from ..utils.device import apply_platform_env


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ripples-torch",
        description="Detect recombination events in a mutation-annotated "
                    "tree by partial re-placement of long branches.")
    p.add_argument("--input-mat", "-i", required=True)
    p.add_argument("--branch-length", "-l", type=int, default=3)
    p.add_argument("--min-coordinate-range", "-r", type=int, default=1000)
    p.add_argument("--max-coordinate-range", "-R", type=int, default=10**7)
    p.add_argument("--outdir", "-d", default=".")
    p.add_argument("--samples-filename", "-s", default="")
    p.add_argument("--parsimony-improvement", "-p", type=int, default=3)
    p.add_argument("--num-descendants", "-n", type=int, default=10)
    p.add_argument("--start-index", "-S", type=int, default=-1)
    p.add_argument("--end-index", "-E", type=int, default=-1)
    p.add_argument("--threads", "-T", type=int, default=0,
                   help="Accepted for CLI parity; torch manages parallelism")
    p.add_argument("--version", action="version", version="ripples-torch (v0.1.0)")
    return p


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    device = apply_platform_env()
    try:
        T = load_mat_pb(a.input_mat)
    except OSError as e:
        print(f"ERROR: cannot read input MAT: {e}", file=sys.stderr)
        return 1
    opts = RipplesOptions(
        branch_len=a.branch_length,
        num_descendants=a.num_descendants,
        parsimony_improvement=a.parsimony_improvement,
        min_range=a.min_coordinate_range,
        max_range=a.max_coordinate_range,
        start_idx=a.start_index,
        end_idx=a.end_index,
        outdir=a.outdir,
        samples_file=a.samples_filename,
    )
    return ripples_main(T, opts, device)


if __name__ == "__main__":
    sys.exit(main())
