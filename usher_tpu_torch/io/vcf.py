"""VCF ingest.

Mirrors reference read_vcf (src/mutation_annotated_tree.cpp:2052-2279):

  - header row found when the 2nd column is "POS"; sample columns start at
    index 9.
  - genotype fields are parsed by their leading integer (so "0:unassigned"
    reads as allele 0); non-digit-leading fields (".", etc.) are missing (N).
  - allele 0 = reference (no entry); allele k>0 = first character of the k-th
    ALT allele converted to a one-hot nibble; 'N' or ambiguous-to-N alleles
    mark the site missing for that sample.

Two modes:
  - build mode (tree from newick): returns per-site variant tables for the
    whole-tree Fitch-Sankoff state assignment, plus mutation lists for
    samples absent from the tree.
  - placement mode (existing MAT): only collects mutation lists for samples
    absent from the tree (reference :2180-2278).
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass, field

import numpy as np

from ..core.nuc import nuc_id_from_char, N
from ..core.tree import Mutation, MissingSample, Tree


@dataclass
class VcfSite:
    chrom: str
    position: int
    ref_nuc: int                  # one-hot nibble (single bit)
    # sparse variants: (sample_column_index, one-hot nibble)
    variants: list[tuple[int, int]] = field(default_factory=list)


@dataclass
class VcfData:
    sample_ids: list[str]
    sites: list[VcfSite]


def _open(filename: str):
    if filename.endswith(".gz"):
        return gzip.open(filename, "rt")
    return open(filename)


def _leading_int(s: str):
    """Parse a leading base-10 integer like std::stoi; None if not digit-led."""
    if not s or not s[0].isdigit():
        return None
    i = 1
    while i < len(s) and s[i].isdigit():
        i += 1
    return int(s[:i])


def read_vcf_sites(vcf_filename: str) -> VcfData:
    """Parse the full VCF into per-site sparse variant lists (build mode).

    Uses the compiled parser where it is built (native/, built at first use);
    the pure-Python path below is the reference implementation and fallback.
    """
    try:
        from ..native import ext, HAVE_NATIVE
    except ImportError:
        HAVE_NATIVE = False
    if HAVE_NATIVE:
        # Large files on many-core hosts go through the parallel pipeline
        # (parse_vcf_mt, the import_vcf_fast.cpp:32-456 analog); per-row
        # Python materialization bounds its win, so small inputs stay on
        # the serial parser (measured: MT loses below ~32 MB / 8 cores).
        try:
            big = os.path.getsize(vcf_filename) > (32 << 20)
        except OSError:
            big = False
        if big and (os.cpu_count() or 1) >= 8 and hasattr(ext, "parse_vcf_mt"):
            sample_ids, raw_sites = ext.parse_vcf_mt(vcf_filename)
        else:
            sample_ids, raw_sites = ext.parse_vcf(vcf_filename)
        sites = [VcfSite(chrom=c, position=p, ref_nuc=r,
                         variants=[(int(a), int(b)) for a, b in v])
                 for c, p, r, v in raw_sites]
        for site in sites:
            if site.ref_nuc & (site.ref_nuc - 1):
                raise ValueError(
                    f"ambiguous reference base at {site.position}")
        return VcfData(sample_ids=sample_ids, sites=sites)
    sample_ids = []
    sites = []
    header_found = False
    with _open(vcf_filename) as f:
        for line in f:
            words = line.split()
            if not header_found:
                if len(words) > 1 and words[1] == "POS":
                    sample_ids = words[9:]
                    header_found = True
                continue
            if len(words) != 9 + len(sample_ids):
                raise ValueError("Incorrect VCF format.")
            alleles = [w for w in words[4].split(",") if w != ""]
            site = VcfSite(chrom=words[0], position=int(words[1]),
                           ref_nuc=nuc_id_from_char(words[3][0]))
            if site.ref_nuc & (site.ref_nuc - 1):
                raise ValueError(f"ambiguous reference base at {site.position}")
            variants = site.variants
            for j, w in enumerate(words[9:]):
                allele_id = _leading_int(w)
                if allele_id is None:
                    variants.append((j, N))
                elif allele_id > 0:
                    variants.append((j, nuc_id_from_char(alleles[allele_id - 1][0])))
            sites.append(site)
    return VcfData(sample_ids=sample_ids, sites=sites)


def collect_missing_samples_build(vcf: VcfData, tree_leaf_ids: set[str]) -> list[MissingSample]:
    """Build-mode missing-sample collection (reference usher_mapper.cpp:63-82):
    samples in the VCF header absent from the tree; their variant entries
    become their mutation list (is_missing for N).  par_nuc is set to ref
    (benign: the reference leaves it uninitialized and never reads it)."""
    missing: list[MissingSample] = []
    col_to_ms: dict[int, MissingSample] = {}
    for j, name in enumerate(vcf.sample_ids):
        if name not in tree_leaf_ids:
            ms = MissingSample(name)
            missing.append(ms)
            col_to_ms[j] = ms
    if not col_to_ms:
        return missing
    for site in vcf.sites:
        for j, nuc in site.variants:
            ms = col_to_ms.get(j)
            if ms is None:
                continue
            m = Mutation(chrom=site.chrom, position=site.position,
                         ref_nuc=site.ref_nuc, par_nuc=site.ref_nuc)
            if nuc == N:
                m.is_missing = True
                m.mut_nuc = N
            else:
                m.mut_nuc = nuc
            ms.mutations.append(m)
            # NOTE: the reference's build path never updates num_ambiguous
            # (usher_mapper.cpp:63-82); only the placement path counts it.
    return missing


def read_vcf(T: Tree, vcf_filename: str, create_new_mat: bool,
             duplicate_prefix: str = ""):
    """Placement-mode entry point matching reference read_vcf semantics.

    Returns (missing_samples, vcf_data). In placement mode (create_new_mat
    False) vcf_data still carries all sites so callers can extend the
    position set of the flattened MAT.

    duplicate_prefix: when non-empty, samples already in the tree are placed
    anyway under the name ``prefix + name`` instead of being ignored
    (reference --no-ignore-prefix, src/usher-sampled/import_vcf.cpp).
    """
    vcf = read_vcf_sites(vcf_filename)
    if create_new_mat:
        leaf_ids = set(n.identifier for n in T.breadth_first_expansion())
        missing = collect_missing_samples_build(vcf, leaf_ids)
    else:
        missing = []
        col_to_ms: dict[int, MissingSample] = {}
        for j, name in enumerate(vcf.sample_ids):
            in_tree = (T.get_node(name) is not None
                       or name in T.condensed_leaves)
            if not in_tree or duplicate_prefix:
                ms = MissingSample(duplicate_prefix + name if in_tree
                                   else name)
                missing.append(ms)
                col_to_ms[j] = ms
            else:
                import sys
                print(f"WARNING: Ignoring sample {name} as it is already in the tree.",
                      file=sys.stderr)
        for site in vcf.sites:
            for j, nuc in site.variants:
                ms = col_to_ms.get(j)
                if ms is None:
                    continue
                m = Mutation(chrom=site.chrom, position=site.position,
                             ref_nuc=site.ref_nuc, par_nuc=site.ref_nuc)
                if nuc == N:
                    m.is_missing = True
                    m.mut_nuc = N
                else:
                    m.mut_nuc = nuc
                ms.mutations.append(m)
                if m.mut_nuc & (m.mut_nuc - 1):
                    ms.num_ambiguous += 1
    return missing, vcf
