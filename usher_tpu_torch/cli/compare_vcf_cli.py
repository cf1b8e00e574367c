"""compareVCF of the port (a copy of usher_tpu/cli/compare_vcf_cli.py; host
code): diff the genotype matrices of two VCFs.

Behavioral parity with reference src/compareVCF.cpp: reports samples missing
from either file and any per-(position, sample) genotype disagreements.
Exit code 0 when the shared matrix is identical.
"""

from __future__ import annotations

import argparse
import sys

from ..core.nuc import char_from_nuc_id
from ..io.vcf import read_vcf_sites


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="compareVCF")
    p.add_argument("vcf1")
    p.add_argument("vcf2")
    a = p.parse_args(argv)

    v1 = read_vcf_sites(a.vcf1)
    v2 = read_vcf_sites(a.vcf2)

    s1 = {name: i for i, name in enumerate(v1.sample_ids)}
    s2 = {name: i for i, name in enumerate(v2.sample_ids)}
    for name in v2.sample_ids:
        if name not in s1:
            print(f"sample {name} missing in file 1")
    for name in v1.sample_ids:
        if name not in s2:
            print(f"sample {name} missing in file 2")
    shared = [name for name in v1.sample_ids if name in s2]

    def genotype_map(v):
        # {pos: (ref, {col: allele})}
        return {site.position: (site.ref_nuc, dict(site.variants))
                for site in v.sites}

    g1 = genotype_map(v1)
    g2 = genotype_map(v2)
    n_diff = 0
    for pos in sorted(set(g1) | set(g2)):
        ref1, var1 = g1.get(pos, (0, {}))
        ref2, var2 = g2.get(pos, (0, {}))
        ref = ref1 or ref2
        for name in shared:
            a1 = var1.get(s1[name], ref)
            a2 = var2.get(s2[name], ref)
            if a1 != a2:
                print(f"At {pos} , sample {name} , "
                      f"{char_from_nuc_id(a2)} in file {a.vcf2}, "
                      f"{char_from_nuc_id(a1)} in file {a.vcf1}",
                      file=sys.stderr)
                n_diff += 1
    print("finished.", file=sys.stderr)
    return 0 if n_diff == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
