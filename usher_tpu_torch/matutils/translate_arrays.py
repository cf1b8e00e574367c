"""Array-native translate / Taxodium export: no host Tree, no resident
Mutation objects.

The Tree-path writers were refactored onto representation-agnostic
DFS-preorder index lists (matutils/translate.py _translate_core /
_taxodium_core); this module builds those lists straight from loaded
MatArrays (io/pb_arrays.py) — names/parent/children as plain int lists,
condensed nodes expanded by the shared uncondense replay, and each node's
mutations materialized TRANSIENTLY from the CSR only while the DFS visits
it.  At the pandemic-scale public MAT this replaces the minutes/GBs host
Node build the reference pays (translate.cpp:98-102, 243-295, 330-496)
with an O(N) list pass.

Byte-parity with the Tree path is asserted in tests/test_translate.py.
"""

from __future__ import annotations

from ..core.tree import Mutation


def _expanded_lists(ma):
    """(names, parent, children, muts_of) with condensed nodes expanded
    (slots are DFS preorder; appended members carry no mutations)."""
    from ..io import pb_arrays as pa
    n = ma.n
    names = ma.names()
    parent = [int(p) for p in ma.parent]
    parent[0] = -1
    children: list[list[int]] = [[] for _ in range(n)]
    for i in range(1, n):
        if parent[i] >= 0:
            children[parent[i]].append(i)
    mut_ptr = ma.mut_ptr
    counter = sum(1 for c in children if c)
    pa.expand_condensed(
        names, parent, children,
        lambda i: i < n and int(mut_ptr[i + 1]) > int(mut_ptr[i]),
        ma.condensed, counter, lambda j: None)
    positions, ref = ma.positions, ma.ref
    chrom = ma.chrom

    def muts_of(i):
        if i >= n:
            return []
        lo, hi = int(mut_ptr[i]), int(mut_ptr[i + 1])
        return [Mutation(chrom, int(positions[ma.mut_col[k]]),
                         int(ref[ma.mut_col[k]]), int(ma.mut_par[k]),
                         int(ma.mut_mut[k])) for k in range(lo, hi)]

    return names, parent, children, muts_of


def translate_arrays(ma, output_filename: str, gtf_filename: str,
                     fasta_filename: str) -> None:
    """matUtils summary -t off flat arrays (translate.cpp:243-295)."""
    from .translate import (_leaf_counts, _translate_core,
                            build_codon_map, build_reference)
    reference = build_reference(fasta_filename)
    codon_map = build_codon_map(gtf_filename, reference)
    names, _parent, children, muts_of = _expanded_lists(ma)
    with open(output_filename, "w") as out:
        _translate_core(names, children, muts_of, out, codon_map,
                        _leaf_counts(children))


def save_taxodium_arrays(ma, out_filename: str, meta_filenames,
                         gtf_filename: str, fasta_filename: str,
                         title: str = "", description: str = "",
                         additional_meta_fields=None,
                         x_scale: float = 0.2,
                         include_nt: bool = False) -> None:
    """matUtils extract -l (Taxodium pb) off flat arrays
    (translate.cpp:330-496)."""
    from .translate import (_taxodium_core, build_codon_map,
                            build_reference)
    reference = build_reference(fasta_filename)
    codon_map = build_codon_map(gtf_filename, reference)
    names, parent, children, muts_of = _expanded_lists(ma)
    # rotate_for_display over index lists: children sorted by descendant
    # count, descending (mutation_annotated_tree.cpp:1426-1453)
    # child indices always exceed the parent's (DFS-preorder slots;
    # appended members go to the end), so a reverse sweep accumulates
    counts = [0] * len(names)
    for i in range(len(names) - 1, -1, -1):
        counts[i] = 1 + sum(counts[c] for c in children[i])
    for ch in children:
        ch.sort(key=lambda c: counts[c], reverse=True)
    _taxodium_core(names, parent, children, muts_of, out_filename,
                   meta_filenames, codon_map, reference, title,
                   description, additional_meta_fields, x_scale,
                   include_nt)
