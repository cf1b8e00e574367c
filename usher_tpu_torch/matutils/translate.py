"""matUtils translate: codon-aware amino-acid annotation + Taxodium export.

Re-implements the reference's translate subcommand
(the reference's src/matUtils/translate.{hpp,cpp}):

  - build_reference           (translate.cpp:13-29)
  - build_codon_map           (translate.cpp:41-240): per-gene CDS codons from
    a GTF, +/- strand, multi-CDS genes (frame shifts) — positions map to the
    list of codons they participate in.
  - Codon.mutate/translate    (translate.hpp:53-95), ambiguous codons -> 'X'.
  - do_mutations/undo_mutations (translate.cpp:498-601): DFS over the tree
    maintaining codon state; emits per-node amino-acid changes, the nucleotide
    mutations driving them, and the codon before>after strings.
  - translate_main            (translate.cpp:243-295): TSV output.
  - taxodium export           (translate.cpp:330-496 translate_and_populate_
    node_data, :605-740 save_taxodium_tree/read_metafiles_tax): AllData pb
    per taxodium.proto, with x/y display layout, integer-encoded mutation and
    metadata mappings.

This is host-side annotation/IO work in both systems (the reference runs it
single-threaded too); the tree state walk is O(total mutations).
"""

from __future__ import annotations

import sys

from ..core.nuc import char_from_nuc_id
from ..core.tree import Tree
from ..io import proto_wire as pw

TRANSLATION_MAP = {
    "GCT": "A", "GCC": "A", "GCA": "A", "GCG": "A", "GCN": "A",
    "TGT": "C", "TGC": "C", "TGY": "C",
    "GAT": "D", "GAC": "D", "GAY": "D",
    "GAA": "E", "GAG": "E", "GAR": "E",
    "TTT": "F", "TTC": "F", "TTY": "F",
    "GGT": "G", "GGC": "G", "GGA": "G", "GGG": "G", "GGN": "G",
    "CAT": "H", "CAC": "H", "CAY": "H",
    "ATT": "I", "ATC": "I", "ATA": "I", "ATH": "I",
    "AAA": "K", "AAG": "K", "AAR": "K",
    "TTA": "L", "TTG": "L", "CTT": "L", "CTC": "L", "CTA": "L", "CTG": "L",
    "YTR": "L", "CTN": "L",
    "ATG": "M",
    "AAT": "N", "AAC": "N", "AAY": "N",
    "CCT": "P", "CCC": "P", "CCA": "P", "CCG": "P", "CCN": "P",
    "CAA": "Q", "CAG": "Q", "CAR": "Q",
    "CGT": "R", "CGC": "R", "CGA": "R", "CGG": "R", "AGA": "R", "AGG": "R",
    "CGN": "R", "MGR": "R",
    "TCT": "S", "TCC": "S", "TCA": "S", "TCG": "S", "AGT": "S", "AGC": "S",
    "TCN": "S", "AGY": "S",
    "ACT": "T", "ACC": "T", "ACA": "T", "ACG": "T", "ACN": "T",
    "GTT": "V", "GTC": "V", "GTA": "V", "GTG": "V", "GTN": "V",
    "TGG": "W",
    "TAT": "Y", "TAC": "Y", "TAY": "Y",
    "TAG": "*", "TAA": "*", "TGA": "*",
}

COMPLEMENT_MAP = {
    "A": "T", "C": "G", "G": "C", "T": "A",
    "M": "K", "R": "Y", "W": "W", "S": "S",
    "Y": "R", "K": "M", "V": "B", "H": "D",
    "D": "H", "B": "V", "N": "N",
}


def complement(nt: str) -> str:
    return COMPLEMENT_MAP.get(nt, "N")


def translate_codon(nt: str) -> str:
    return TRANSLATION_MAP.get(nt, "X")


class Codon:
    """One codon instance; `nucleotides` tracks current tree state.

    Mirrors reference translate.hpp:53-95 (note: `mutate` indexes by
    abs(pos - start_position), so '-'-strand codons whose start_position is
    the highest coordinate index correctly).
    """

    __slots__ = ("orf_name", "nucleotides", "codon_number", "start_position",
                 "protein")

    def __init__(self, orf_name: str, codon_number: int, start_position: int,
                 nt3: str):
        self.orf_name = orf_name
        self.codon_number = codon_number
        self.start_position = start_position
        self.nucleotides = nt3
        self.protein = translate_codon(nt3)

    def mutate(self, nuc_pos: int, mutated_nuc: str) -> None:
        i = abs(nuc_pos - self.start_position)
        n = self.nucleotides
        self.nucleotides = n[:i] + mutated_nuc + n[i + 1:]
        self.protein = translate_codon(self.nucleotides)


def build_reference(fasta_path: str) -> str:
    """Concatenate fasta sequence lines, uppercased (translate.cpp:13-29)."""
    out = []
    with open(fasta_path) as f:
        for line in f:
            if line.startswith(">") or line == "\n":
                continue
            out.append(line.strip().upper())
    return "".join(out)


def _add_codon(codon_map, positions, c):
    for p in positions:
        codon_map.setdefault(p, []).append(c)


def _codons_plus(codon_map, gene, start, stop, reference, counter):
    """Forward-strand codons over [start-1, stop) in 0-based coords."""
    for pos in range(start - 1, stop, 3):
        nt3 = reference[pos:pos + 3]
        c = Codon(gene, counter, pos, nt3)
        counter += 1
        _add_codon(codon_map, (pos, pos + 1, pos + 2), c)
    return counter

def _codons_minus(codon_map, gene, start, stop, reference, counter):
    """Reverse-strand codons walking down from stop-1 (translate.cpp:118-152).

    The codon's nucleotides are the complement of reference[pos], [pos-1],
    [pos-2]; start_position is the highest coordinate.
    """
    pos = stop - 1
    while pos > start:
        nt3 = (complement(reference[pos]) + complement(reference[pos - 1])
               + complement(reference[pos - 2]))
        c = Codon(gene, counter, pos, nt3)
        counter += 1
        _add_codon(codon_map, (pos, pos - 1, pos - 2), c)
        pos -= 3
    return counter


def build_codon_map(gtf_path: str, reference: str) -> dict[int, list[Codon]]:
    """position(0-based) -> codons covering it (translate.cpp:41-240).

    Per gene: codons from the first CDS feature, then codons for any further
    CDS features of the same gene with a different start (frame shifts /
    ribosomal slippage, e.g. ORF1ab).
    """
    rows = []
    with open(gtf_path) as f:
        for line in f:
            if line.startswith("#") or line == "\n":
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) <= 1:
                continue
            if not parts[8].startswith("gene_id"):
                raise ValueError("GTF file formatted incorrectly "
                                 "(attribute must start with gene_id)")
            gene = parts[8].split('"')[1]
            rows.append((parts[2], gene, int(parts[3]), int(parts[4]),
                         parts[6][0]))

    codon_map: dict[int, list[Codon]] = {}
    done = set()
    for feature, gene, start, stop, strand in rows:
        if feature != "CDS" or gene in done:
            continue
        done.add(gene)
        counter = 0
        if strand == "+":
            counter = _codons_plus(codon_map, gene, start, stop, reference,
                                   counter)
        else:
            counter = _codons_minus(codon_map, gene, start, stop, reference,
                                    counter)
        for f2, g2, s2, e2, str2 in rows:
            if f2 != "CDS" or g2 != gene:
                continue
            if s2 == start and str2 == strand:
                continue
            if str2 == "+":
                counter = _codons_plus(codon_map, gene, s2, e2, reference,
                                       counter)
            else:
                counter = _codons_minus(codon_map, gene, s2, e2, reference,
                                        counter)
    return codon_map


def do_mutations(mutations, codon_map, taxodium_format: bool) -> str:
    """Apply a node's nt mutations to the codon state; return the annotation
    string (translate.cpp:498-589).

    TSV mode returns "aa_muts\tnt_muts\tcodon_changes"; taxodium mode returns
    only nonsynonymous "ORF:par_codonnum_mut;..." entries.
    """
    mutations = sorted(mutations, key=lambda m: m.position)
    codon_to_nt: dict[str, list] = {}
    latest_codon: dict[str, str] = {}
    orig_proteins: dict[str, str] = {}
    orig_codons: dict[str, str] = {}
    affected: list[Codon] = []

    for m in mutations:
        mutated_nuc = char_from_nuc_id(m.mut_nuc)
        par_nuc = char_from_nuc_id(m.par_nuc)
        pos = m.position - 1
        for c in codon_map.get(pos, ()):
            codon_id = f"{c.orf_name}:{c.codon_number + 1}"
            # parent state first, so orig_* reflect the parent, not ref
            c.mutate(pos, par_nuc)
            orig_proteins.setdefault(codon_id, c.protein)
            if not any(c is a for a in affected):
                affected.append(c)
            orig_codons.setdefault(codon_id, c.nucleotides)
            c.mutate(pos, mutated_nuc)
            latest_codon[codon_id] = c.nucleotides
            lst = codon_to_nt.setdefault(codon_id, [])
            if not any(e.position == m.position and e.mut_nuc == m.mut_nuc
                       and e.par_nuc == m.par_nuc for e in lst):
                lst.append(m)

    prot_parts, nuc_parts, cchange_parts = [], [], []
    for c in affected:
        codon_id = f"{c.orf_name}:{c.codon_number + 1}"
        orf, num = codon_id.split(":")
        orig_protein = orig_proteins[codon_id]
        if taxodium_format:
            if orig_protein == c.protein:  # exclude synonymous
                continue
            prot_parts.append(f"{orf}:{orig_protein}_{num}_{c.protein}")
        else:
            prot_parts.append(f"{orf}:{orig_protein}{num}{c.protein}")
        nts = sorted(codon_to_nt[codon_id], key=lambda m: m.position)
        nuc_parts.append(",".join(m.get_string() for m in nts))
        cchange_parts.append(f"{orig_codons[codon_id]}>{latest_codon[codon_id]}")

    if not prot_parts or not nuc_parts or not cchange_parts:
        return ""
    if taxodium_format:
        return ";".join(prot_parts)
    return (";".join(prot_parts) + "\t" + ";".join(nuc_parts) + "\t"
            + ";".join(cchange_parts))


def undo_mutations(mutations, codon_map) -> None:
    """Revert a node's mutations to the parent state (translate.cpp:590-601)."""
    for m in mutations:
        par = char_from_nuc_id(m.par_nuc)
        pos = m.position - 1
        for c in codon_map.get(pos, ()):
            c.mutate(pos, par)


def _dfs_with_codon_state(T: Tree, codon_map, visit):
    """DFS calling visit(node) after applying the node's mutations, undoing
    them on backtrack — equivalent to the reference's trace-to-LCA revert
    (translate.cpp:275-285)."""
    stack = [(T.root, False)]
    while stack:
        node, exiting = stack.pop()
        if exiting:
            undo_mutations(node.mutations, codon_map)
            continue
        do_result = do_mutations(node.mutations, codon_map, False)
        visit(node, do_result)
        stack.append((node, True))
        for child in reversed(node.children):
            stack.append((child, False))


def _tree_lists(T: Tree):
    """Index-list view of a Tree in DFS preorder (the representation the
    shared writer cores operate on; the array path builds the same lists
    straight from MatArrays — translate_arrays.py)."""
    dfs = T.depth_first_expansion()
    idx = {id(n): i for i, n in enumerate(dfs)}
    names = [n.identifier for n in dfs]
    parent = [idx[id(n.parent)] if n.parent is not None else -1
              for n in dfs]
    children = [[idx[id(c)] for c in n.children] for n in dfs]
    return names, parent, children, (lambda i: dfs[i].mutations)


def _leaf_counts(children) -> list[int]:
    n = len(children)
    counts = [0] * n
    # children indices always exceed the parent's (DFS preorder), so a
    # reverse sweep accumulates bottom-up
    for i in range(n - 1, -1, -1):
        if not children[i]:
            counts[i] = 1
        else:
            counts[i] = sum(counts[c] for c in children[i])
    return counts


def _translate_core(names, children, muts_of, out, codon_map,
                    leaf_counts) -> None:
    """Shared row writer: DFS with codon apply/undo
    (translate.cpp:243-295)."""
    out.write("node_id\taa_mutations\tnt_mutations\tcodon_changes\t"
              "leaves_sharing_mutations\n")
    stack = [(0, False)]
    while stack:
        i, exiting = stack.pop()
        if exiting:
            undo_mutations(muts_of(i), codon_map)
            continue
        result = do_mutations(muts_of(i), codon_map, False)
        if result:
            out.write(f"{names[i]}\t{result}\t{leaf_counts[i]}\n")
        stack.append((i, True))
        for c in reversed(children[i]):
            stack.append((c, False))


def translate_main(T: Tree, output_filename: str, gtf_filename: str,
                   fasta_filename: str) -> None:
    """TSV: node_id, aa_mutations, nt_mutations, codon_changes, leaves
    (translate.cpp:243-295)."""
    if T.condensed_nodes:
        T.uncondense_leaves()
    reference = build_reference(fasta_filename)
    codon_map = build_codon_map(gtf_filename, reference)
    names, _parent, children, muts_of = _tree_lists(T)
    with open(output_filename, "w") as out:
        _translate_core(names, children, muts_of, out, codon_map,
                        _leaf_counts(children))


# --- Taxodium protobuf export ------------------------------------------------

def read_metafiles_tax(filenames: list[str],
                       additional_meta_fields: list[str] | None = None):
    """Parse metadata TSV/CSVs (translate.cpp:644-740).

    Returns (metadata: sample -> list[str] raw fields per file-concatenated
    columns, columns: list[str] column names, strain/date/genbank indices).
    """
    additional = set(additional_meta_fields or ())
    metadata: dict[str, list[str]] = {}
    columns: list[str] = []
    strain_col = date_col = genbank_col = -1
    generic_cols: list[tuple[str, int]] = []
    col_base = 0
    for fname in filenames:
        delim = "," if fname.endswith(".csv") else "\t"
        with open(fname) as f:
            header = f.readline().rstrip("\n").split(delim)
            file_strain_col = -1
            for i, name in enumerate(header):
                low = name.strip().lower()
                columns.append(name.strip())
                if low == "strain":
                    file_strain_col = i
                    strain_col = col_base + i
                elif low == "date":
                    date_col = col_base + i
                elif low in ("genbank_accession", "genbank"):
                    genbank_col = col_base + i
                elif low in ("country", "pango_lineage_usher", "lineage",
                             "pangolin_lineage") or name.strip() in additional:
                    generic_cols.append((name.strip(), col_base + i))
            # the reference requires a strain column per file
            # (translate.cpp:700-710)
            if file_strain_col < 0:
                raise ValueError(
                    'The column "strain" (sample ID) is missing from at '
                    f"least one metadata file: {fname}")
            ncol = len(header)
            seen_in_this_file: set[str] = set()
            for line in f:
                fields = line.rstrip("\n").split(delim)
                fields += [""] * (ncol - len(fields))
                key = fields[file_strain_col]
                # ignore duplicate rows within a file (translate.cpp:713-716)
                if key in seen_in_this_file:
                    continue
                seen_in_this_file.add(key)
                row = metadata.setdefault(key, [])
                row.extend([""] * (col_base - len(row)))
                row.extend(fields)
            col_base += ncol
    for v in metadata.values():
        v.extend([""] * (col_base - len(v)))
    return metadata, columns, strain_col, date_col, genbank_col, generic_cols


def save_taxodium_tree(T: Tree, out_filename: str,
                       meta_filenames: list[str],
                       gtf_filename: str, fasta_filename: str,
                       title: str = "", description: str = "",
                       additional_meta_fields: list[str] | None = None,
                       x_scale: float = 0.2,
                       include_nt: bool = False) -> None:
    """Write a Taxodium AllData protobuf (taxodium.proto; reference
    save_taxodium_tree translate.cpp + translate_and_populate_node_data
    :330-496)."""
    if T.condensed_nodes:
        T.uncondense_leaves()
    rotate_for_display(T)
    reference = build_reference(fasta_filename)
    codon_map = build_codon_map(gtf_filename, reference)
    node_names, parent_idx, children, muts_of = _tree_lists(T)
    _taxodium_core(node_names, parent_idx, children, muts_of,
                   out_filename, meta_filenames, codon_map, reference,
                   title, description, additional_meta_fields, x_scale,
                   include_nt)


def _taxodium_core(node_names, parent_idx, children, muts_of,
                   out_filename, meta_filenames, codon_map, reference,
                   title, description, additional_meta_fields, x_scale,
                   include_nt) -> None:
    """Representation-agnostic Taxodium writer over DFS-preorder index
    lists (shared by the Tree path and the no-Tree array path)."""
    metadata: dict[str, list[str]] = {}
    generic_cols: list[tuple[str, int]] = []
    date_col = genbank_col = -1
    if meta_filenames:
        metadata, _cols, _strain, date_col, genbank_col, generic_cols = \
            read_metafiles_tax(meta_filenames, additional_meta_fields)

    n_nodes = len(node_names)
    num_leaves_list = _leaf_counts(children)

    names: list[str] = []
    xs: list[float] = []
    ys: list[float] = [0.0] * n_nodes
    dates: list[int] = []
    parents: list[int] = []
    genbanks: list[str] = []
    num_tips: list[int] = []
    mutation_lists: list[list[int]] = []
    mutation_mapping: list[str] = [""]  # index 0 = no mutations
    seen_mutations: dict[str, int] = {}
    date_mapping: list[str] = [""]
    seen_dates: dict[str, int] = {}
    generic_data: list[dict] = [
        {"name": name, "col": col, "mapping": [""], "seen": {}, "values": []}
        for name, col in generic_cols
    ]

    # DFS with codon state; x = cumulative mutation count from root.
    # Output order is index order (both representations are DFS preorder,
    # so the explicit stack below visits 0..n-1 in order).
    branch_x = [0.0] * n_nodes
    out_row = [0] * n_nodes   # node index -> output row
    row_of = 0
    stack = [(0, False)]
    while stack:
        i, exiting = stack.pop()
        if exiting:
            undo_mutations(muts_of(i), codon_map)
            continue
        node_muts = muts_of(i)
        ident = node_names[i]
        out_row[i] = row_of
        row_of += 1
        px = branch_x[parent_idx[i]] if parent_idx[i] >= 0 else 0.0
        branch_x[i] = px + len(node_muts)

        mutation_result = ""
        if include_nt:
            for m in node_muts:
                mutation_result += (f"nt:{char_from_nuc_id(m.par_nuc)}_"
                                    f"{m.position}_"
                                    f"{char_from_nuc_id(m.mut_nuc)};")
        mutation_result += do_mutations(node_muts, codon_map, True)
        if parent_idx[i] < 0:
            # "fake" root mutations so Taxodium can color by amino acid
            done_codons = set()
            parts = []
            for pos in range(len(reference)):
                for c in codon_map.get(pos, ()):
                    cid = f"{c.orf_name}:{c.codon_number + 1}"
                    if cid in done_codons:
                        continue
                    done_codons.add(cid)
                    parts.append(f"{c.orf_name}:X_{c.codon_number + 1}_"
                                 f"{c.protein}")
            mutation_result = ";".join(parts) + (";" if parts else "")
        mut_ids = []
        if mutation_result:
            for mstr in mutation_result.split(";"):
                if mstr == "":
                    continue
                if mstr not in seen_mutations:
                    seen_mutations[mstr] = len(mutation_mapping)
                    mutation_mapping.append(mstr)
                mut_ids.append(seen_mutations[mstr])
        mutation_lists.append(mut_ids)

        xs.append(branch_x[i] * x_scale)
        num_tips.append(num_leaves_list[i])
        fields = metadata.get(ident)
        if ident.startswith("node_") or fields is None:
            names.append("" if ident.startswith("node_")
                         else ident.split("|")[0])
            if date_col > -1:
                dates.append(0)
            if genbank_col > -1:
                genbanks.append("")
            for g in generic_data:
                g["values"].append(0)
        else:
            names.append(ident.split("|")[0])
            if date_col > -1:
                d = fields[date_col]
                if d and d not in seen_dates:
                    seen_dates[d] = len(date_mapping)
                    date_mapping.append(d)
                dates.append(seen_dates.get(d, 0))
            if genbank_col > -1:
                genbanks.append(fields[genbank_col])
            for g in generic_data:
                v = fields[g["col"]]
                if v and v not in g["seen"]:
                    g["seen"][v] = len(g["mapping"])
                    g["mapping"].append(v)
                g["values"].append(g["seen"].get(v, 0))
        parents.append(out_row[parent_idx[i]] if parent_idx[i] >= 0
                       else 0)

        stack.append((i, True))
        for child in reversed(children[i]):
            stack.append((child, False))

    # y layout: leaves in reverse-DFS order get i/40000; internal nodes get
    # mean of children, assigned bottom-up by level (translate.cpp:469-495)
    dfs_order = sorted(range(n_nodes), key=lambda x: out_row[x])
    leaves = [x for x in dfs_order if not children[x]]
    for k, leaf in enumerate(reversed(leaves), start=1):
        ys[out_row[leaf]] = k / 40000.0
    level = [0] * n_nodes
    for x in dfs_order:
        level[x] = level[parent_idx[x]] + 1 if parent_idx[x] >= 0 else 0
    by_level: dict[int, list] = {}
    for x in dfs_order:
        by_level.setdefault(level[x], []).append(x)
    for lv in sorted(by_level, reverse=True):
        for x in by_level[lv]:
            if children[x]:
                ys[out_row[x]] = (
                    sum(ys[out_row[c]] for c in children[x])
                    / len(children[x]))

    # --- encode taxodium.proto ---
    node_data = bytearray()
    for s in names:
        pw.write_string_field(1, s, node_data)
    pw.write_packed_float_field(2, xs, node_data)
    pw.write_packed_float_field(3, ys, node_data)
    if date_col > -1:
        pw.write_packed_int32_field(7, dates, node_data)
    for mut_ids in mutation_lists:
        sub = bytearray()
        pw.write_packed_int32_field(1, mut_ids, sub)
        pw.write_bytes_field(6, bytes(sub), node_data)
    pw.write_packed_int32_field(8, parents, node_data)
    if genbank_col > -1:
        for s in genbanks:
            pw.write_string_field(9, s, node_data)
    pw.write_packed_int32_field(11, num_tips, node_data)
    # epi_isl_numbers: the reference writes a 0 per node (translate.cpp:409)
    pw.write_packed_int32_field(10, [0] * len(names), node_data)
    for g in generic_data:
        sub = bytearray()
        pw.write_string_field(1, _taxodium_meta_name(g["name"]), sub)
        for s in g["mapping"]:
            pw.write_string_field(3, s, sub)
        pw.write_packed_int32_field(4, g["values"], sub)
        pw.write_bytes_field(12, bytes(sub), node_data)

    all_data = bytearray()
    pw.write_bytes_field(1, bytes(node_data), all_data)
    for s in mutation_mapping:
        pw.write_string_field(4, s, all_data)
    for s in date_mapping:
        pw.write_string_field(5, s, all_data)
    if description:
        pw.write_string_field(6, description, all_data)
    if title:
        pw.write_string_field(7, title, all_data)

    import gzip
    opener = gzip.open if out_filename.endswith(".gz") else open
    with opener(out_filename, "wb") as f:
        f.write(bytes(all_data))


def _taxodium_meta_name(col: str) -> str:
    """Taxodium expects the standard column names renamed to plain
    "Lineage"/"Country"; anything else keeps its raw column name
    (reference translate.cpp:784-792)."""
    low = col.lower()
    if low == "country":
        return "Country"
    if low in ("pango_lineage_usher", "lineage", "pangolin_lineage"):
        return "Lineage"
    return col


def _leaves_per_node(T: Tree, dfs) -> dict[str, int]:
    counts: dict[str, int] = {}
    for n in reversed(dfs):
        counts[n.identifier] = (1 if n.is_leaf()
                                else sum(counts[c.identifier]
                                         for c in n.children))
    return counts


def rotate_for_display(T: Tree, reverse: bool = False) -> None:
    """Sort children by descendant count (reference
    mutation_annotated_tree.cpp:1426-1453)."""
    dfs = T.depth_first_expansion()
    # the reference counts all descendants (not just leaves)
    counts: dict[str, int] = {}
    for n in reversed(dfs):
        counts[n.identifier] = 1 + sum(counts[c.identifier]
                                       for c in n.children)
    for n in dfs:
        n.children.sort(key=lambda c: counts[c.identifier],
                        reverse=not reverse)
