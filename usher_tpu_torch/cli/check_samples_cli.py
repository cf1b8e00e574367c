"""check_samples_place of the port (a copy of
usher_tpu/cli/check_samples_cli.py; host code): the standalone
placement-correctness oracle.

Parity with reference src/check_samples_place/main.cpp:9-50: load the
original inputs (MAT or newick+VCF) and a result MAT, verify every sample's
reconstructed genotype is identical, and detect duplicate leaf ids.
"""

from __future__ import annotations

import argparse
import sys

from ..core.nuc import N as NUC_N
from ..io.newick import parse_newick
from ..io.pbio import load_mat_pb
from ..io.vcf import read_vcf_sites


def _err(*a):
    print(*a, file=sys.stderr)


def leaf_genotypes(T):
    out = {}
    dup = []
    seen = set()
    stack = [(T.root, {})]
    while stack:
        node, state = stack.pop()
        if node.mutations:
            state = dict(state)
            for m in node.mutations:
                if not m.is_masked():
                    state[m.position] = m.mut_nuc
        if node.is_leaf():
            if node.identifier in seen:
                dup.append(node.identifier)
            seen.add(node.identifier)
            out[node.identifier] = state
        for ch in node.children:
            stack.append((ch, state))
    return out, dup


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="check_samples_place")
    p.add_argument("--original-mat", "-i", default="",
                   help="Original MAT protobuf (pre-placement)")
    p.add_argument("--vcf", "-v", default="",
                   help="VCF of the placed samples (expected genotypes)")
    p.add_argument("--result-mat", "-o", required=True,
                   help="Result MAT protobuf to check")
    a = p.parse_args(argv)

    T = load_mat_pb(a.result_mat)
    T.uncondense_leaves()
    got, dup = leaf_genotypes(T)
    rc = 0
    for d in dup:
        _err(f"ERROR: duplicate leaf id {d} in result tree")
        rc = 1

    if a.original_mat:
        T0 = load_mat_pb(a.original_mat)
        T0.uncondense_leaves()
        want, _ = leaf_genotypes(T0)
        for name, g0 in want.items():
            if name not in got:
                _err(f"ERROR: sample {name} missing from result tree")
                rc = 1
                continue
            g1 = got[name]
            for pos in set(g0) | set(g1):
                m0 = g0.get(pos)
                m1 = g1.get(pos)
                # positions absent on one side reconstruct to an ancestral
                # state; require recorded states to intersect when both exist
                if m0 is not None and m1 is not None and not (m0 & m1):
                    _err(f"ERROR: {name}@{pos}: original {m0:04b} vs "
                         f"result {m1:04b}")
                    rc = 1

    if a.vcf:
        vcf = read_vcf_sites(a.vcf)
        checked = 0
        for site in vcf.sites:
            variant_by_col = dict(site.variants)
            for j, name in enumerate(vcf.sample_ids):
                if name not in got:
                    _err(f"ERROR: sample {name} missing from result tree")
                    rc = 1
                    continue
                mask = variant_by_col.get(j, site.ref_nuc)
                state = got[name].get(site.position, site.ref_nuc)
                if mask != NUC_N and not (state & mask):
                    _err(f"ERROR: {name}@{site.position}: VCF {mask:04b} vs "
                         f"tree {state:04b}")
                    rc = 1
                checked += 1
        _err(f"Checked {checked} genotypes.")

    _err("OK" if rc == 0 else "FAILED")
    return rc


if __name__ == "__main__":
    sys.exit(main())
