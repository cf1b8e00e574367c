"""MAT protobuf interchange (.pb), wire-compatible with the reference format.

Schema (reference parsimony.proto):
  message data {
    string newick = 1;                       // branch lens = #mutations
    repeated mutation_list node_mutations = 2;  // per node, preorder (DFS)
    repeated condensed_node condensed_nodes = 3;
    repeated node_metadata metadata = 4;     // clade annotations, preorder
  }
  message mutation_list { repeated mut mutation = 1; }
  message mut {
    int32 position = 1;          // <0 => masked
    int32 ref_nuc = 2;           // 2-bit index (0:A 1:C 2:G 3:T); -1 masked
    int32 par_nuc = 3;
    repeated int32 mut_nuc = 4;  // 2-bit indices of the allele set
    string chromosome = 5;
  }
  message condensed_node { string node_name = 1; repeated string condensed_leaves = 2; }
  message node_metadata { repeated string clade_annotations = 1; }

Save/load semantics mirror reference mutation_annotated_tree.cpp:522-681,
including dropping mutations with mut_nuc == par_nuc at load.
"""

from __future__ import annotations

import gzip
import sys

from ..core.nuc import nuc_id_from_nt_list, nt_from_nuc_id, nt_list_from_nuc_id
from ..core.tree import Mutation, Tree
from . import proto_wire as pw
from .newick import parse_newick_string, write_newick


def save_mat_pb(T: Tree, filename: str) -> None:
    out = bytearray()
    newick = write_newick(T, print_internal=False, print_branch_len=True)
    pw.write_string_field(1, newick, out)

    dfs = T.depth_first_expansion()

    # node_mutations (field 2) in preorder.
    for node in dfs:
        ml = bytearray()
        for m in node.mutations:
            mb = bytearray()
            pw.write_varint_field(1, m.position, mb)
            if m.is_masked():
                pw.write_varint_field(2, -1, mb)
                pw.write_varint_field(3, -1, mb)
            else:
                ref_nt = nt_from_nuc_id(m.ref_nuc)
                par_nt = nt_from_nuc_id(m.par_nuc)
                if ref_nt < 0 or par_nt < 0:
                    raise ValueError(f"ambiguous ref/par nuc in {m.get_string()}")
                pw.write_varint_field(2, ref_nt, mb)
                pw.write_varint_field(3, par_nt, mb)
                pw.write_packed_int32_field(4, nt_list_from_nuc_id(m.mut_nuc), mb)
            if m.chrom:
                pw.write_string_field(5, m.chrom, mb)
            pw.write_bytes_field(1, bytes(mb), ml)
        pw.write_bytes_field(2, bytes(ml), out)

    # condensed_nodes (field 3).
    for name, leaves in T.condensed_nodes.items():
        cb = bytearray()
        pw.write_string_field(1, name, cb)
        for leaf in leaves:
            pw.write_string_field(2, leaf, cb)
        pw.write_bytes_field(3, bytes(cb), out)

    # metadata (field 4) in preorder.
    for node in dfs:
        meta = bytearray()
        for ann in node.clade_annotations:
            pw.write_string_field(1, ann, meta)
        pw.write_bytes_field(4, bytes(meta), out)

    data = bytes(out)
    if ".gz" in filename:
        with gzip.open(filename, "wb") as f:
            f.write(data)
    else:
        with open(filename, "wb") as f:
            f.write(data)


def _parse_mut(payload) -> Mutation:
    m = Mutation()
    mut_nts: list[int] = []
    for fn, wt, val in pw.iter_fields(payload):
        if fn == 1:
            m.position = pw.to_int32(val)
        elif fn == 2:
            m.ref_nuc = pw.to_int32(val)          # temporarily 2-bit index
        elif fn == 3:
            m.par_nuc = pw.to_int32(val)
        elif fn == 4:
            if wt == 2:
                mut_nts.extend(pw.decode_packed_int32(val))
            else:
                mut_nts.append(pw.to_int32(val))
        elif fn == 5:
            m.chrom = bytes(val).decode("utf-8")
    m.mut_nuc = mut_nts  # resolved by caller
    return m


def load_mat_pb(filename: str) -> Tree:
    if ".gz" in filename:
        with gzip.open(filename, "rb") as f:
            buf = f.read()
    else:
        with open(filename, "rb") as f:
            buf = f.read()

    newick = ""
    node_mutation_lists: list[list[Mutation]] = []
    condensed: list[tuple[str, list[str]]] = []
    metadata: list[list[str]] = []
    for fn, wt, val in pw.iter_fields(buf):
        if fn == 1:
            newick = bytes(val).decode("utf-8")
        elif fn == 2:
            muts = []
            for fn2, wt2, val2 in pw.iter_fields(val):
                if fn2 == 1:
                    muts.append(_parse_mut(val2))
            node_mutation_lists.append(muts)
        elif fn == 3:
            name = ""
            leaves: list[str] = []
            for fn2, wt2, val2 in pw.iter_fields(val):
                if fn2 == 1:
                    name = bytes(val2).decode("utf-8")
                elif fn2 == 2:
                    leaves.append(bytes(val2).decode("utf-8"))
            condensed.append((name, leaves))
        elif fn == 4:
            anns = [bytes(v).decode("utf-8")
                    for fn2, _, v in pw.iter_fields(val) if fn2 == 1]
            metadata.append(anns)

    has_meta = len(metadata) > 0
    if not has_meta:
        print("WARNING: This pb does not include any metadata. "
              "Filling in default values", file=sys.stderr)

    T = parse_newick_string(newick)
    dfs = T.depth_first_expansion()
    if len(node_mutation_lists) != len(dfs):
        raise ValueError(
            f"pb node_mutations count {len(node_mutation_lists)} != "
            f"tree node count {len(dfs)}")
    for idx, node in enumerate(dfs):
        if has_meta and idx < len(metadata):
            node.clade_annotations = list(metadata[idx])
        for raw in node_mutation_lists[idx]:
            m = Mutation(chrom=raw.chrom, position=raw.position)
            if not m.is_masked():
                m.ref_nuc = 1 << raw.ref_nuc
                m.par_nuc = 1 << raw.par_nuc
                m.is_missing = False
                m.mut_nuc = nuc_id_from_nt_list(raw.mut_nuc)
                if m.mut_nuc != m.par_nuc:
                    node.add_mutation(m)
            else:
                m.ref_nuc = m.par_nuc = m.mut_nuc = 0
                node.add_mutation(m)
        if any(node.mutations[i].position > node.mutations[i + 1].position
               for i in range(len(node.mutations) - 1)):
            node.mutations.sort(key=lambda mm: mm.position)

    for name, leaves in condensed:
        T.condensed_nodes[name] = leaves
        for leaf in leaves:
            T.condensed_leaves.add(leaf)
    return T
