"""ripplesUtils CLI of the port (counterpart of
usher_tpu/cli/ripples_utils_cli.py; reference
src/ripples/util/ripplesUtils.cpp:6): post-filter helper files for the
recombination filtering pipeline.  Host code."""

from __future__ import annotations

import argparse
import sys

from ..ripples.utils import ripples_utils_main


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ripplesUtils-torch")
    p.add_argument("input_mat", help="MAT protobuf (.pb)")
    p.add_argument("--pvals",
                   default="filtering/data/combinedCatOnlyBestWithPVals.txt",
                   help="combined p-values file from the 3SEQ filter")
    p.add_argument("--data-dir", default="filtering/data")
    args = p.parse_args(argv)
    if not args.input_mat.endswith(".pb"):
        print("ERROR: Input file ending not recognized. Must be .json or "
              ".pb", file=sys.stderr)
        return 1
    ripples_utils_main(args.input_mat, args.pvals, args.data_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
