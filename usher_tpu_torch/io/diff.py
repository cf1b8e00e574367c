"""MAPLE diff ingest: reference genome fasta + per-sample diff lines.

Semantics transcribed from the reference's load_diff_for_usher
(src/usher-sampled/import_vcf.cpp:551-664):

  fasta: first line ">chrom", remaining lines the genome (1-based positions;
         ambiguous reference bases are stored as 0).
  diff:  ">sample" starts a sample; data lines are
             <nuc>\t<pos>            a substitution (one-hot nibble allele)
             n|N|-\t<pos>[\t<len>]   a run of <len> (default 1) missing bases

Missing runs are kept as [start, end) ranges (the reference's
To_Place_Sample_Mutation range encoding, usher.hpp:28-63) and materialized
per segregating position at encode time.
"""

from __future__ import annotations

import numpy as np

from ..core.nuc import nuc_id_from_char
from ..core.tree import Mutation, MissingSample


def load_reference_fasta(fasta_path: str):
    """Returns (refs uint8[genome_len+1] one-hot nibbles, chrom). refs[0]=0."""
    with open(fasta_path) as f:
        header = f.readline().strip()
        if not header.startswith(">"):
            raise ValueError(f"{fasta_path}: expected fasta header")
        chrom = header[1:].split()[0]
        seq = []
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                break
            seq.append(line)
    genome = "".join(seq)
    refs = np.zeros(len(genome) + 1, dtype=np.uint8)
    for i, ch in enumerate(genome):
        nuc = nuc_id_from_char(ch)
        refs[i + 1] = 0 if nuc == 0xF else nuc
    return refs, chrom


class DiffSample(MissingSample):
    """MissingSample with missing (N) runs kept as ranges."""

    __slots__ = ("n_ranges",)

    def __init__(self, name: str):
        super().__init__(name)
        self.n_ranges: list[tuple[int, int]] = []  # [start, end)


def load_diff(diff_path: str, refs: np.ndarray, chrom: str,
              tree_node_ids=frozenset()) -> list[DiffSample]:
    """Parse a MAPLE diff file into samples-to-place.

    Samples already present in the tree are skipped with a warning, like the
    reference (import_vcf.cpp:602-607).
    """
    import sys
    samples: list[DiffSample] = []
    cur: DiffSample | None = None
    skipping = False
    with open(diff_path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith(">"):
                name = line[1:]
                if name in tree_node_ids:
                    print(f"WARNING: Sample {name} already in the tree! "
                          f"Ignoring.\n", file=sys.stderr)
                    skipping = True
                    cur = None
                else:
                    skipping = False
                    cur = DiffSample(name)
                    samples.append(cur)
                continue
            fields = line.split("\t")
            ch = fields[0]
            pos = int(fields[1])
            if ch in ("n", "N", "-"):
                length = int(fields[2]) if len(fields) > 2 else 1
                if not skipping:
                    cur.n_ranges.append((pos, pos + length))
                    cur.num_ambiguous += length
            else:
                nuc = nuc_id_from_char(ch)
                if nuc == 0xF:
                    raise ValueError(f"{diff_path}:{lineno}: bad base {ch!r}")
                if not skipping:
                    ref_nuc = int(refs[pos]) if pos < len(refs) else 0
                    cur.mutations.append(Mutation(
                        chrom=chrom, position=pos, ref_nuc=ref_nuc,
                        par_nuc=ref_nuc, mut_nuc=nuc))
                    if nuc & (nuc - 1):
                        cur.num_ambiguous += 1
    for s in samples:
        s.mutations.sort(key=lambda m: m.position)
    return samples


def materialize_missing(sample: DiffSample, positions: np.ndarray,
                        pos_ref: dict[int, int], chrom: str) -> list[Mutation]:
    """Expand the sample's N ranges into per-position missing Mutations for
    the segregating-position set, merged with its substitutions."""
    muts = list(sample.mutations)
    have = {m.position for m in muts}
    for start, end in sample.n_ranges:
        lo = int(np.searchsorted(positions, start, side="left"))
        hi = int(np.searchsorted(positions, end, side="left"))
        for p in positions[lo:hi].tolist():
            if p not in have:
                ref_nuc = pos_ref.get(int(p), 0)
                muts.append(Mutation(chrom=chrom, position=int(p),
                                     ref_nuc=ref_nuc, par_nuc=ref_nuc,
                                     mut_nuc=0xF, is_missing=True))
                have.add(p)
    muts.sort(key=lambda m: m.position)
    return muts
