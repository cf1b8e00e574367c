"""ripples post-filtration CLI of the port: 3SEQ-style significance testing
(counterpart of usher_tpu/cli/ripples_filter_cli.py; host code).

Native equivalent of the reference's GCP filtering pipeline core
(scripts/recombination/filtering/: getABABA.py pattern extraction,
makeMNK.py statistics, combineAndGetPVals.py p-values + best-row
selection), with the 3SEQ p-value computed exactly instead of read from
shipped null tables.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ripples-filter-torch",
        description="Filter raw ripples candidates by exact 3SEQ "
                    "significance.")
    p.add_argument("--input-mat", "-i", required=True,
                   help="The MAT the ripples scan ran against")
    p.add_argument("--recombination-tsv", "-r",
                   default="recombination.tsv",
                   help="ripples recombination.tsv (or the fleet-merged one)")
    p.add_argument("--output", "-o", default="filtered_recombinants.tsv")
    p.add_argument("--pvalue", "-p", type=float, default=0.05,
                   help="significance threshold")
    return p


def main(argv=None) -> int:
    from ..utils.device import apply_platform_env
    apply_platform_env()
    args = build_parser().parse_args(argv)
    from ..io.pbio import load_mat_pb
    from ..ripples.filter import filter_recombinants
    T = load_mat_pb(args.input_mat)
    T.uncondense_leaves()
    filter_recombinants(T, args.recombination_tsv, args.output, args.pvalue)
    print(f"Wrote {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
