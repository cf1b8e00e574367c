"""Patch leaf genotypes in a loaded MAT from auxiliary inputs.

Reference: add_ambiguous_mutation (src/matOptimize/transpose_vcf/
transpose_vcf.hpp patch-into-MAT path, used by matOptimize -V, and the MAPLE
diff path of matOptimize main.cpp:360-374).  The MAT protobuf stores
resolved single-allele states; these patchers restore the original
ambiguous/missing genotype masks on the sample leaves so state
reassignment (Fitch-Sankoff) sees the true uncertainty.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.tree import Mutation, Tree


def _err(*a):
    print(*a, file=sys.stderr)


def _leaf_patch(node, pos: int, mask: int, ref_nuc: int, chrom: str,
                missing: bool) -> None:
    for m in node.mutations:
        if m.position == pos:
            m.mut_nuc = mask
            m.is_missing = missing
            return
    node.add_mutation(Mutation(chrom=chrom, position=pos, ref_nuc=ref_nuc,
                               par_nuc=ref_nuc, mut_nuc=mask,
                               is_missing=missing))


def patch_mat_from_transposed_vcf(T: Tree, tvcf_path: str) -> int:
    """Restore ambiguous bases / N runs recorded in a transposed VCF onto the
    tree's sample leaves (matOptimize -V; the caller must re-run state
    assignment afterwards — par_nuc fields of patched entries are
    placeholders until then).  Returns the number of samples patched."""
    from ..core.flat import collect_positions
    from .transpose import decode
    positions, ref, chrom = collect_positions(T)
    pos_ref = {int(p): int(r) for p, r in zip(positions, ref)}
    patched = 0
    unknown_pos = 0
    for name, muts, nranges in decode(tvcf_path):
        node = T.get_node(name)
        if node is None or not node.is_leaf():
            continue
        patched += 1
        for pos, allele in muts:
            r = pos_ref.get(pos)
            if r is None:
                unknown_pos += 1
                continue
            _leaf_patch(node, pos, int(allele), r, chrom,
                        missing=(allele == 0xF))
        for start, end in nranges:
            lo = int(np.searchsorted(positions, start, side="left"))
            hi = int(np.searchsorted(positions, end, side="right"))
            for p in positions[lo:hi].tolist():
                _leaf_patch(node, int(p), 0xF, pos_ref[int(p)], chrom,
                            missing=True)
    if unknown_pos:
        _err(f"WARNING: {unknown_pos} transposed-VCF entries at positions "
             f"not segregating in the MAT were ignored.")
    _err(f"Patched ambiguous genotypes for {patched} samples from "
         f"{tvcf_path}")
    return patched


def assign_states_from_diff(T: Tree, diff_path: str, ref_fasta: str) -> int:
    """matOptimize -D/-R: tree from newick + MAPLE diff — assign every
    sample leaf its diff-recorded genotype (substitutions + N runs) relative
    to the reference genome.  Returns the number of leaves assigned."""
    from .diff import load_diff, load_reference_fasta, materialize_missing
    refs, chrom = load_reference_fasta(ref_fasta)
    samples = load_diff(diff_path, refs, chrom)
    # segregating set = union of all substitution positions
    pos_set = sorted({m.position for s in samples for m in s.mutations})
    positions = np.asarray(pos_set, dtype=np.int64)
    pos_ref = {int(p): int(refs[p]) if p < len(refs) else 0
               for p in pos_set}
    assigned = 0
    for s in samples:
        node = T.get_node(s.name)
        if node is None:
            _err(f"WARNING: diff sample {s.name} not found in tree; skipped")
            continue
        node.mutations = materialize_missing(s, positions, pos_ref, chrom)
        assigned += 1
    _err(f"Assigned diff genotypes to {assigned} leaves from {diff_path}")
    return assigned
