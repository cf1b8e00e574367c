"""Transposed-VCF tools of the port (a copy of
usher_tpu/cli/transpose_vcf_cli.py; host code, on the port's io/transpose.py
and its compiled codec), mirroring the reference's four binaries
(src/matOptimize/transpose_vcf/): transpose_vcf (encode),
transposed_vcf_to_vcf, transposed_vcf_to_fa, transposed_vcf_print_name.
"""

from __future__ import annotations

import argparse
import sys

from ..core.nuc import char_from_nuc_id
from ..io import transpose


def main_encode(argv=None) -> int:
    p = argparse.ArgumentParser(prog="transpose_vcf")
    p.add_argument("--vcf", "-v", required=True)
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--append", "-a", action="store_true",
                   help="Concatenate onto an existing file")
    p.add_argument("--threads", "-T", type=int, default=0)
    a = p.parse_args(argv)
    n = transpose.encode_vcf(a.vcf, a.output, a.append)
    print(f"Encoded {n} samples to {a.output}", file=sys.stderr)
    return 0


def main_print_name(argv=None) -> int:
    p = argparse.ArgumentParser(prog="transposed_vcf_print_name")
    p.add_argument("--input", "-i", required=True)
    a = p.parse_args(argv)
    for name, _, _ in transpose.decode(a.input):
        print(name)
    return 0


def main_to_vcf(argv=None) -> int:
    p = argparse.ArgumentParser(prog="transposed_vcf_to_vcf")
    p.add_argument("--input", "-i", required=True)
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--reference", "-r", required=True,
                   help="Reference fasta (for REF alleles)")
    p.add_argument("--threads", "-T", type=int, default=0)
    a = p.parse_args(argv)
    from ..io.diff import load_reference_fasta
    refs, chrom = load_reference_fasta(a.reference)
    samples = transpose.decode(a.input)

    # positions = union of all variant positions and N positions
    by_pos: dict[int, dict[int, int]] = {}
    for col, (name, muts, nranges) in enumerate(samples):
        for pos, allele in muts:
            by_pos.setdefault(pos, {})[col] = allele
        for start, end in nranges:
            for pos in range(start, end + 1):
                by_pos.setdefault(pos, {})[col] = 0xF

    with open(a.output, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT")
        for name, _, _ in samples:
            f.write("\t" + name)
        f.write("\n")
        for pos in sorted(by_pos):
            ref_nuc = int(refs[pos]) if pos < len(refs) else 0
            ref_ch = char_from_nuc_id(ref_nuc) if ref_nuc else "N"
            variants = by_pos[pos]
            alts = sorted({a_ for a_ in variants.values() if a_ != ref_nuc})
            if not alts:
                continue
            codes = {a_: i + 1 for i, a_ in enumerate(alts)}
            f.write(f"{chrom}\t{pos}\t"
                    + ",".join(f"{ref_ch}{pos}{char_from_nuc_id(a_)}"
                               for a_ in alts)
                    + f"\t{ref_ch}\t"
                    + ",".join(char_from_nuc_id(a_) for a_ in alts)
                    + "\t.\t.\t.\tGT")
            for col in range(len(samples)):
                allele = variants.get(col)
                f.write("\t" + ("0" if allele is None or allele == ref_nuc
                                else str(codes[allele])))
            f.write("\n")
    return 0


def main_to_fa(argv=None) -> int:
    p = argparse.ArgumentParser(prog="transposed_vcf_to_fa")
    p.add_argument("--input", "-i", required=True)
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--reference", "-r", required=True)
    a = p.parse_args(argv)
    from ..io.diff import load_reference_fasta
    refs, chrom = load_reference_fasta(a.reference)
    genome = [char_from_nuc_id(int(x)) if x else "N"
              for x in refs[1:]]
    with open(a.output, "w") as f:
        for name, muts, nranges in transpose.decode(a.input):
            seq = list(genome)
            for pos, allele in muts:
                if 1 <= pos <= len(seq):
                    seq[pos - 1] = char_from_nuc_id(allele)
            for start, end in nranges:
                for pos in range(start, min(end, len(seq)) + 1):
                    seq[pos - 1] = "N"
            f.write(">" + name + "\n")
            s = "".join(seq)
            for i in range(0, len(s), 80):
                f.write(s[i:i + 80] + "\n")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cmds = {"encode": main_encode, "to_vcf": main_to_vcf,
            "to_fa": main_to_fa, "print_name": main_print_name}
    if not argv or argv[0] not in cmds:
        print("usage: transpose_vcf {encode|to_vcf|to_fa|print_name} ...",
              file=sys.stderr)
        return 1
    return cmds[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
