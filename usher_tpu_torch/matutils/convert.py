"""Format writers/readers for matUtils extract.

Parity targets: make_vcf (reference src/matUtils/convert.cpp:294-322, row
semantics :120-265), make_diff (:325-401), Auspice JSON v2 write
(:585-663) and read (:421-583).
"""

from __future__ import annotations

import gzip
import json
import sys

from ..core.nuc import char_from_nuc_id, nuc_id_from_char
from ..core.tree import Mutation, Tree


def _open_out(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "wt")
    return open(path, "w")


def _leaf_genotypes_by_pos(T: Tree, samples: set[str]):
    """DFS allele propagation: {position: (ref_nuc, {sample: allele})} for
    alleles differing from ref (reference r_add_genotypes, convert.cpp:63-118)."""
    by_pos: dict[int, tuple[int, dict[str, int]]] = {}
    stack = [(T.root, {})]
    while stack:
        node, state = stack.pop()
        if node.mutations:
            state = dict(state)
            for m in node.mutations:
                if m.is_masked():
                    continue
                state[m.position] = (m.ref_nuc, m.mut_nuc)
        if node.is_leaf() and node.identifier in samples:
            for pos, (ref, allele) in state.items():
                if pos not in by_pos:
                    by_pos[pos] = (ref, {})
                if allele != ref:
                    by_pos[pos][1][node.identifier] = allele
        for ch in node.children:
            stack.append((ch, state))
    return by_pos


def make_vcf(T: Tree, vcf_filepath: str, no_genotypes: bool = False,
             samples_vec: list[str] | None = None, chrom: str = "") -> None:
    """VCF writer with AC/AN INFO and 0/1/2... genotype codes
    (reference convert.cpp:294-322)."""
    if not samples_vec:
        samples = T.get_leaves_ids()
    else:
        samples = samples_vec
    sample_set = set(samples)
    # DFS order of sample columns, like the reference header writer
    dfs_samples = [n.identifier for n in T.depth_first_expansion()
                   if n.identifier in sample_set]
    chrom = chrom or "NC_045512v2"

    by_pos = _leaf_genotypes_by_pos(T, sample_set)
    leaf_count = len(dfs_samples)
    col = {name: i for i, name in enumerate(dfs_samples)}

    with _open_out(vcf_filepath) as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO")
        if not no_genotypes:
            f.write("\tFORMAT")
            for name in dfs_samples:
                f.write("\t" + name)
        f.write("\n")
        for pos in sorted(by_pos):
            ref, variants = by_pos[pos]
            if not variants:
                continue
            counts: dict[int, int] = {}
            for allele in variants.values():
                counts[allele] = counts.get(allele, 0) + 1
            # alts ordered by count desc then allele asc (reference
            # make_alts: sort by count desc, then emitted in map (allele)
            # order -- i.e. final order is by allele value)
            alts = sorted(counts.keys())
            codes = {ref: 0}
            for i, a in enumerate(alts):
                codes[a] = i + 1
            idstr = ",".join(f"{char_from_nuc_id(ref)}{pos}{char_from_nuc_id(a)}"
                             for a in alts)
            alt_str = ",".join(char_from_nuc_id(a) for a in alts)
            info = "AC=" + ",".join(str(counts[a]) for a in alts) + \
                   ";AN=" + str(leaf_count)
            f.write(f"{chrom}\t{pos}\t{idstr}\t{char_from_nuc_id(ref)}\t"
                    f"{alt_str}\t.\t.\t{info}")
            if not no_genotypes:
                row = [0] * leaf_count
                for name, allele in variants.items():
                    row[col[name]] = codes[allele]
                f.write("\tGT\t" + "\t".join(map(str, row)))
            f.write("\n")


def make_diff(T: Tree, diff_filename: str,
              samples_vec: list[str] | None = None) -> None:
    """MAPLE diff writer (reference convert.cpp:325-401): per selected leaf,
    '>name' then lowercase-allele/position lines for net differences from the
    tree's implied reference."""
    samples = set(samples_vec) if samples_vec else set(T.get_leaves_ids())
    with _open_out(diff_filename) as f:
        # iterative DFS with mutation stack
        stack = [(T.root, False)]
        mut_stack: list[Mutation] = []
        while stack:
            node, done = stack.pop()
            if done:
                del mut_stack[len(mut_stack) - len(node.mutations):]
                continue
            mut_stack.extend(node.mutations)
            stack.append((node, True))
            for ch in reversed(node.children):
                stack.append((ch, False))
            if node.is_leaf() and node.identifier in samples:
                f.write(">" + node.identifier + "\n")
                refs: dict[int, str] = {}
                alts: dict[int, str] = {}
                for m in mut_stack:
                    if m.position not in refs:
                        refs[m.position] = char_from_nuc_id(m.par_nuc).lower()
                    alts[m.position] = char_from_nuc_id(m.mut_nuc).lower()
                for pos in sorted(alts):
                    if alts[pos] != refs[pos]:
                        f.write(f"{alts[pos]}\t{pos}\n")


# --- Auspice JSON v2 ---------------------------------------------------------

def _json_node(node: Tree, metadata: dict[str, dict[str, str]],
               div: int, use_clades: list[bool] | None = None) -> dict:
    obj: dict = {"name": node.identifier}
    attrs = {"div": div + len(node.mutations)}
    body = {"branch_attrs": {"labels": {}, "mutations":
                             {"nuc": [m.get_string() for m in node.mutations]}},
            "node_attrs": attrs}
    obj.update(body)
    clades = [c for c in node.clade_annotations if c]
    if clades:
        obj["branch_attrs"]["labels"]["clade"] = clades[0]
    if use_clades:
        # MAT_Clade_i node attrs for annotated clade columns
        # (reference get_json_entry)
        for i, used in enumerate(use_clades):
            if used and i < len(node.clade_annotations) \
                    and node.clade_annotations[i]:
                attrs[f"MAT_Clade_{i}"] = {"value": node.clade_annotations[i]}
    meta = metadata.get(node.identifier)
    if meta:
        for k, v in meta.items():
            attrs[k] = {"value": v}
    kids = [_json_node(c, metadata, div + len(node.mutations), use_clades)
            for c in node.children]
    if kids:
        obj["children"] = kids
    return obj



def _json_meta_obj(title, metadata, use_clades):
    """Shared Auspice meta/colorings builder (convert.cpp:609-644) for
    the Tree and array JSON writers."""
    colorings = [{"key": "country", "title": "Country",
                  "type": "categorical"}]
    metafields: list[str] = []
    for kv in metadata.values():
        for k in kv:
            if k not in metafields:
                metafields.append(k)
    for k in metafields:
        colorings.append({"key": k, "title": k,
                          "type": "continuous" if "continuous" in k
                          else "categorical"})
    meta_obj = {
        "title": title,
        "filters": ["country", "userOrOld"],
        "panels": ["tree"],
        "colorings": colorings,
        "display_defaults": {"branch_label": "none"},
        "description":
            "JSON generated by matUtils. If you have metadata you wish "
            "to display, you can now drag on a CSV/TSV file and it will "
            "be added into this view, [see here](https://docs.nextstrain."
            "org/projects/auspice/en/latest/advanced-functionality/"
            "drag-drop-csv-tsv.html) for more info.",
    }
    for i, used in enumerate(use_clades):
        if used:
            meta_obj.setdefault("extensions", {}).setdefault(
                "nextclade", {}).setdefault(
                "clade_node_attrs", []).append({
                    "name": f"MAT_Clade_{i}",
                    "displayName": f"MAT_Clade_{i + 1}",
                    "description": f"MAT_Clade_{i + 1}as inferred or "
                                   "proposed by UShER, matUtils, or "
                                   "Autolin.",
                    "hideInWeb": False,
                    "skipAsReference": True})
            colorings.append({"key": f"MAT_Clade_{i}",
                              "title": f"MAT_Clade_{i + 1}",
                              "type": "categorical"})
    return meta_obj


def write_json_from_mat(T: Tree, path: str, title: str = "mutation_annotated_tree",
                        metadata: dict[str, dict[str, str]] | None = None) -> None:
    """Auspice (nextstrain) v2 JSON writer (reference convert.cpp:585-663)."""
    import sys as _sys
    old_limit = _sys.getrecursionlimit()
    _sys.setrecursionlimit(max(old_limit, 4 * T.get_max_level() + 1000))
    try:
        metadata = metadata or {}
        # clade-annotation columns that carry any value (convert.cpp:593-607)
        n_ann = len(T.root.clade_annotations) if T.root is not None else 0
        use_clades = [False] * n_ann
        for n in T.depth_first_expansion():
            for i, c in enumerate(n.clade_annotations[:n_ann]):
                if c:
                    use_clades[i] = True
            if all(use_clades):
                break
        meta_obj = _json_meta_obj(title, metadata, use_clades)
        doc = {
            "version": "v2",
            "meta": meta_obj,
            "tree": {"name": "wrapper", "node_attrs": {"div": 0},
                     "children": [_json_node(T.root, metadata, 0,
                                             use_clades)]},
        }
        with _open_out(path) as f:
            json.dump(doc, f)
    finally:
        _sys.setrecursionlimit(old_limit)


def load_mat_from_json(path: str) -> Tree:
    """Auspice JSON v2 -> MAT (reference create_node_from_json,
    convert.cpp:421-583).  Mutations parsed from branch_attrs.mutations.nuc."""
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            doc = json.load(f)
    else:
        with open(path) as f:
            doc = json.load(f)
    tree_obj = doc["tree"] if "tree" in doc else doc
    # unwrap the reference's "wrapper" root (convert.cpp:622-628)
    if (tree_obj.get("name") == "wrapper"
            and len(tree_obj.get("children", [])) == 1):
        tree_obj = tree_obj["children"][0]
    T = Tree()

    def parse_muts(obj) -> list[Mutation]:
        out = []
        nuc = (obj.get("branch_attrs", {}).get("mutations", {})
               .get("nuc", []))
        for s in nuc:
            if len(s) < 3:
                continue
            par = nuc_id_from_char(s[0])
            mut = nuc_id_from_char(s[-1])
            try:
                pos = int(s[1:-1])
            except ValueError:
                continue
            out.append(Mutation(chrom="", position=pos, ref_nuc=par,
                                par_nuc=par, mut_nuc=mut))
        return out

    counter = [0]

    def name_of(obj) -> str:
        n = obj.get("name")
        if not n:
            counter[0] += 1
            n = f"node_{counter[0]}"
        return n

    root_obj = tree_obj
    root = T.create_node(name_of(root_obj))
    for m in parse_muts(root_obj):
        root.add_mutation(m)
    label = root_obj.get("branch_attrs", {}).get("labels", {}).get("clade")
    root.clade_annotations = [label or ""]
    stack = [(root_obj, root)]
    while stack:
        obj, node = stack.pop()
        for ch in obj.get("children", []):
            cn = T.create_node(name_of(ch), node)
            for m in parse_muts(ch):
                cn.add_mutation(m)
            label = ch.get("branch_attrs", {}).get("labels", {}).get("clade")
            cn.clade_annotations = [label or ""]
            stack.append((ch, cn))
    return T


def read_metafile(path: str, samples_to_use=None,
                  load_all: bool = False) -> dict[str, dict[str, str]]:
    """Metadata tsv/csv keyed by first column (reference select.cpp:468-504).

    samples_to_use: optional set restricting which rows are kept (the
    reference default keeps only selected samples); load_all=True keeps
    every row regardless (--load-all-metadata, extract.cpp:123-124)."""
    sep = "," if path.endswith(".csv") else "\t"
    out: dict[str, dict[str, str]] = {}
    with open(path) as f:
        header = f.readline().rstrip("\n").split(sep)
        for line in f:
            fields = line.rstrip("\n").split(sep)
            if not fields or not fields[0]:
                continue
            if (not load_all and samples_to_use is not None
                    and fields[0] not in samples_to_use):
                continue
            out[fields[0]] = dict(zip(header[1:], fields[1:]))
    return out


def get_minimum_subtrees(T: Tree, samples: list[str], size: int,
                         outdir: str, metadata=None, json_prefix: str = "",
                         newick_prefix: str = "",
                         retain_original_branch_len: bool = False) -> None:
    """-N: minimum set of ~`size`-leaf subtrees covering all queried samples,
    written as JSON and/or newick plus subtree-assignments.tsv
    (reference get_minimum_subtrees, convert.cpp:665-798).

    metadata: {sample: {field: value}}.  When JSON output is requested every
    queried sample additionally gets query_sample=query (convert.cpp:673-680).
    """
    import os as _os
    import sys as _sys
    from .select import get_nearby
    from .tree_filter import get_subtree

    if not json_prefix and not newick_prefix:
        print("ERROR: Either JSON (-j) or Newick (-t) output must be "
              "requested alongside -N.", file=_sys.stderr)
        raise SystemExit(1)
    metadata = dict(metadata or {})
    if json_prefix:
        for s in samples:
            metadata.setdefault(s, {})
            metadata[s] = {**metadata[s], "query_sample": "query"}

    assignment: dict[str, int] = {}   # sample/leaf -> subtree idx (-1 = none)
    subtree_sets: list[list[str]] = []
    for s in samples:
        if s in assignment:
            continue
        leaves = get_nearby(T, s, size)
        if not leaves:
            assignment[s] = -1
            continue
        for l in leaves:
            assignment.setdefault(l, len(subtree_sets))
        subtree_sets.append(leaves)

    for i, leaf_set in enumerate(subtree_sets):
        new_T = get_subtree(T, leaf_set, keep_clade_annotations=True)
        if json_prefix:
            outf = _os.path.join(outdir, f"{json_prefix}-subtree-{i}.json")
            write_json_from_mat(new_T, outf,
                                title=f"{json_prefix}-subtree-{i}",
                                metadata=metadata)
        if newick_prefix:
            outf = _os.path.join(outdir, f"{newick_prefix}-subtree-{i}.nw")
            from ..io.newick import write_newick
            with open(outf, "w") as f:
                f.write(write_newick(
                    new_T, print_internal=True, print_branch_len=True,
                    retain_original_branch_len=retain_original_branch_len))

    metafields = sorted({f for s in samples for f in metadata.get(s, ())})
    with open(_os.path.join(outdir, "subtree-assignments.tsv"), "w") as tr:
        tr.write("samples")
        if json_prefix:
            tr.write("\tjson_file")
        if newick_prefix:
            tr.write("\tnewick_file")
        for m in metafields:
            tr.write("\t" + m)
        tr.write("\n")
        for s in samples:
            idx = assignment.get(s, -1)
            if idx == -1:
                continue
            tr.write(s)
            if json_prefix:
                tr.write("\t" + _os.path.join(
                    outdir, f"{json_prefix}-subtree-{idx}.json"))
            if newick_prefix:
                tr.write("\t" + _os.path.join(
                    outdir, f"{newick_prefix}-subtree-{idx}.nw"))
            for m in metafields:
                tr.write("\t" + metadata.get(s, {}).get(m, "NA"))
            tr.write("\n")
