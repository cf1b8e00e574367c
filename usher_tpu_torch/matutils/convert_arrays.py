"""Array-native whole-MAT VCF / MAPLE-diff export (no host Tree).

The reference runs `matUtils extract -v / --write-diff` on the full
>2M-leaf public MAT (convert.cpp:294 make_vcf, :325 make_diff) — walks
that cost a full Node build here.  These writers reconstruct per-leaf
genotypes straight from loaded MatArrays: condensed nodes expand via the
shared uncondense replay (translate_arrays._expanded_lists), and the
"nearest ancestor mutation" state per (column, leaf) is a per-column
sequence of DFS-leaf-range assignments ordered shallow-to-deep (deeper
overwrites), instead of a per-node stateful walk.

Byte-parity with the Tree writers is asserted in tests/test_matutils.py.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.nuc import char_from_nuc_id
from .translate_arrays import _expanded_lists


def _err(*a):
    print(*a, file=sys.stderr)


def _leaf_layout(ma):
    """(names, leaf slot order (DFS), per-base-slot leaf ranges).

    Returns (leaf_names, leaf_rank_of_row, lo, hi) where for base slot u
    the expanded leaves under u occupy leaf columns [lo[u], hi[u])."""
    names, parent, children, _muts_of = _expanded_lists(ma)
    n_all = len(names)
    # DFS preorder over the expanded lists
    pre = []
    stack = [0]
    while stack:
        x = stack.pop()
        pre.append(x)
        stack.extend(reversed(children[x]))
    dfs_idx = [0] * n_all
    for i, x in enumerate(pre):
        dfs_idx[x] = i
    leaf_names = [names[x] for x in pre if not children[x]]
    # leaf rank per preorder row (count of leaves before the row)
    is_leaf_pre = np.array([0 if children[x] else 1 for x in pre],
                           np.int64)
    leaf_before = np.cumsum(is_leaf_pre) - is_leaf_pre
    # subtree end per expanded node (reverse accumulation)
    end = np.zeros(n_all, np.int64)
    for i in range(len(pre) - 1, -1, -1):
        x = pre[i]
        e = i + 1
        for c in children[x]:
            e = max(e, end[dfs_idx[c]])
        end[i] = e
    n_base = ma.n
    lo = np.zeros(n_base, np.int64)
    hi = np.zeros(n_base, np.int64)
    L = len(leaf_names)
    for u in range(n_base):
        r = dfs_idx[u]
        lo[u] = leaf_before[r]
        e = end[r]
        hi[u] = leaf_before[e] if e < n_all else L
    return leaf_names, lo, hi


def _column_states(ma, lo, hi, n_leaves):
    """Yield (col, state[n_leaves]) for columns carrying mutations:
    nearest-ancestor allele per leaf via shallow-to-deep range assigns."""
    n = ma.n
    # depth per base slot
    level = np.zeros(n, np.int64)
    for i in range(1, n):
        level[i] = level[ma.parent[i]] + 1
    mut_node = np.repeat(np.arange(n),
                         np.diff(ma.mut_ptr).astype(np.int64))
    order = np.lexsort((level[mut_node], ma.mut_col))
    cols = ma.mut_col[order]
    nodes = mut_node[order]
    muts = ma.mut_mut[order]
    bounds = np.nonzero(np.r_[True, cols[1:] != cols[:-1]])[0]
    bounds = np.r_[bounds, len(cols)]
    state = np.empty(n_leaves, np.uint8)
    for bi in range(len(bounds) - 1):
        s, e = bounds[bi], bounds[bi + 1]
        c = int(cols[s])
        state[:] = ma.ref[c]
        for k in range(s, e):
            u = int(nodes[k])
            state[lo[u]:hi[u]] = muts[k]
        yield c, state


def make_vcf_arrays(ma, vcf_filepath: str,
                    no_genotypes: bool = False, chrom: str = "") -> None:
    """Whole-MAT VCF off flat arrays (convert.cpp:294-322 semantics,
    byte-identical to matutils/convert.make_vcf on the uncondensed
    tree)."""
    from .convert import _open_out
    leaf_names, lo, hi = _leaf_layout(ma)
    L = len(leaf_names)
    chrom = chrom or "NC_045512v2"
    with _open_out(vcf_filepath) as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO")
        if not no_genotypes:
            f.write("\tFORMAT")
            for name in leaf_names:
                f.write("\t" + name)
        f.write("\n")
        for c, state in _column_states(ma, lo, hi, L):
            ref = int(ma.ref[c])
            pos = int(ma.positions[c])
            var_mask = state != ref
            if not var_mask.any():
                continue
            alleles, counts = np.unique(state[var_mask],
                                        return_counts=True)
            alts = [int(a) for a in alleles]
            code_of = np.zeros(16, np.uint8)
            for i, a in enumerate(alts):
                code_of[a] = i + 1
            idstr = ",".join(
                f"{char_from_nuc_id(ref)}{pos}{char_from_nuc_id(a)}"
                for a in alts)
            alt_str = ",".join(char_from_nuc_id(a) for a in alts)
            info = ("AC=" + ",".join(str(int(x)) for x in counts)
                    + ";AN=" + str(L))
            f.write(f"{chrom}\t{pos}\t{idstr}\t{char_from_nuc_id(ref)}\t"
                    f"{alt_str}\t.\t.\t{info}")
            if not no_genotypes:
                codes = code_of[state]
                if len(alts) <= 9:
                    # vectorized single-digit cell assembly
                    cells = np.empty(2 * L, np.uint8)
                    cells[0::2] = ord("\t")
                    cells[1::2] = codes + ord("0")
                    f.write("\tGT" + cells.tobytes().decode())
                else:
                    f.write("\tGT\t"
                            + "\t".join(str(int(x)) for x in codes))
            f.write("\n")


def make_diff_arrays(ma, diff_filename: str) -> None:
    """Whole-MAT MAPLE diff off flat arrays (convert.cpp:325-401
    semantics): per leaf (DFS order), net differences where the path's
    LAST allele at a position differs from its FIRST par_nuc."""
    from .convert import _open_out
    leaf_names, lo, hi = _leaf_layout(ma)
    L = len(leaf_names)
    n = ma.n
    level = np.zeros(n, np.int64)
    for i in range(1, n):
        level[i] = level[ma.parent[i]] + 1
    mut_node = np.repeat(np.arange(n),
                         np.diff(ma.mut_ptr).astype(np.int64))
    order = np.lexsort((level[mut_node], ma.mut_col))
    cols = ma.mut_col[order]
    nodes = mut_node[order]
    muts = ma.mut_mut[order]
    pars = ma.mut_par[order]
    bounds = np.nonzero(np.r_[True, cols[1:] != cols[:-1]])[0]
    bounds = np.r_[bounds, len(cols)]
    state = np.empty(L, np.uint8)
    first_par = np.empty(L, np.uint8)
    ent_leaf: list[np.ndarray] = []
    ent_pos: list[np.ndarray] = []
    ent_alt: list[np.ndarray] = []
    SENT = np.uint8(255)
    for bi in range(len(bounds) - 1):
        s, e = bounds[bi], bounds[bi + 1]
        c = int(cols[s])
        state[:] = SENT
        first_par[:] = SENT
        # deep-to-shallow for first_par (shallowest assignment wins last);
        # shallow-to-deep for state (deepest wins last)
        for k in range(s, e):
            u = int(nodes[k])
            state[lo[u]:hi[u]] = muts[k]
        for k in range(e - 1, s - 1, -1):
            u = int(nodes[k])
            first_par[lo[u]:hi[u]] = pars[k]
        m = (state != SENT) & (state != first_par)
        idx = np.nonzero(m)[0]
        if len(idx):
            ent_leaf.append(idx.astype(np.int64))
            ent_pos.append(np.full(len(idx), int(ma.positions[c]),
                                   np.int64))
            ent_alt.append(state[idx].copy())
    with _open_out(diff_filename) as f:
        if ent_leaf:
            leafv = np.concatenate(ent_leaf)
            posv = np.concatenate(ent_pos)
            altv = np.concatenate(ent_alt)
            o = np.lexsort((posv, leafv))
            leafv, posv, altv = leafv[o], posv[o], altv[o]
        else:
            leafv = np.zeros(0, np.int64)
            posv = altv = leafv
        j = 0
        for li in range(L):
            f.write(">" + leaf_names[li] + "\n")
            while j < len(leafv) and leafv[j] == li:
                f.write(f"{char_from_nuc_id(int(altv[j])).lower()}"
                        f"\t{int(posv[j])}\n")
                j += 1


def write_json_from_mat_arrays(ma, path: str,
                               title: str = "mutation_annotated_tree",
                               metadata=None) -> None:
    """Whole-MAT Auspice v2 JSON off flat arrays (convert.cpp:585-663):
    the nested node tree is assembled iteratively over the expanded index
    lists (no recursion, no Node objects), byte-identical to the Tree
    writer."""
    import json
    from ..io import pb_arrays as pa
    from .convert import _json_meta_obj, _open_out
    metadata = metadata or {}
    names, parent, children, muts_of = _expanded_lists(ma)
    anns, ncols = pa.ann_lists(ma, ma.n)

    def ann_of(i):
        if anns is not None and i < ma.n:
            return anns[i]
        return [""] * ncols

    use_clades = [False] * ncols
    if ncols:
        for i in range(len(names)):
            for k, c in enumerate(ann_of(i)[:ncols]):
                if c:
                    use_clades[k] = True
            if all(use_clades):
                break
    meta_obj = _json_meta_obj(title, metadata, use_clades)

    # iterative preorder build mirroring _json_node
    objs: list[dict] = [None] * len(names)
    divs: list[int] = [0] * len(names)
    stack = [0]
    while stack:
        i = stack.pop()
        node_muts = muts_of(i)
        pdiv = divs[parent[i]] if parent[i] >= 0 else 0
        divs[i] = pdiv + len(node_muts)
        attrs = {"div": divs[i]}
        obj = {"name": names[i],
               "branch_attrs": {"labels": {}, "mutations": {
                   "nuc": [m.get_string() for m in node_muts]}},
               "node_attrs": attrs}
        clades = [c for c in ann_of(i) if c]
        if clades:
            obj["branch_attrs"]["labels"]["clade"] = clades[0]
        if use_clades:
            arow = ann_of(i)
            for k, used in enumerate(use_clades):
                if used and k < len(arow) and arow[k]:
                    attrs[f"MAT_Clade_{k}"] = {"value": arow[k]}
        meta = metadata.get(names[i])
        if meta:
            for k, v in meta.items():
                attrs[k] = {"value": v}
        if children[i]:
            obj["children"] = []
        objs[i] = obj
        if parent[i] >= 0:
            objs[parent[i]]["children"].append(obj)
        stack.extend(reversed(children[i]))
    doc = {
        "version": "v2",
        "meta": meta_obj,
        "tree": {"name": "wrapper", "node_attrs": {"div": 0},
                 "children": [objs[0]]},
    }
    with _open_out(path) as f:
        json.dump(doc, f)
