"""matUtils summary: statistics tables over a MAT.

Output schemas transcribed from reference src/matUtils/summary.cpp
(file:line cited per writer).
"""

from __future__ import annotations

import sys
from collections import defaultdict

from ..core.nuc import char_from_nuc_id, nt_from_nuc_id
from ..core.tree import Tree


def _err(*a):
    print(*a, file=sys.stderr)


def write_sample_table(T: Tree, filename: str) -> None:
    """sample\\tparsimony\\tparent_id per leaf (summary.cpp:70-86)."""
    with open(filename, "w") as f:
        f.write("sample\tparsimony\tparent_id\n")
        for s in T.depth_first_expansion():
            if s.is_leaf():
                f.write(f"{s.identifier}\t{len(s.mutations)}\t"
                        f"{s.parent.identifier}\n")


def write_clade_table(T: Tree, filename: str) -> None:
    """clade\\tinclusive_count\\texclusive_count (summary.cpp:88-137):
    inclusive counts every (leaf, annotated ancestor) pair; exclusive only
    the first annotation encountered walking up from each leaf, per
    annotation column (first two columns only, like the reference)."""
    incl: dict[str, int] = defaultdict(int)
    excl: dict[str, int] = defaultdict(int)
    for s in T.get_leaves():
        first1, first2 = True, True
        node = s.parent
        while node is not None:
            anns = node.clade_annotations
            if len(anns) >= 1 and anns[0]:
                incl[anns[0]] += 1
                if first1:
                    excl[anns[0]] += 1
                    first1 = False
            if len(anns) >= 2 and anns[1]:
                incl[anns[1]] += 1
                if first2:
                    excl[anns[1]] += 1
                    first2 = False
            node = node.parent
    with open(filename, "w") as f:
        f.write("clade\tinclusive_count\texclusive_count\n")
        for clade in sorted(incl):
            f.write(f"{clade}\t{incl[clade]}\t{excl[clade]}\n")


def write_mutation_table(T: Tree, filename: str) -> None:
    """ID\\toccurrence across all nodes (summary.cpp:139-175)."""
    counts: dict[str, int] = defaultdict(int)
    for s in T.depth_first_expansion():
        for m in s.mutations:
            name = m.get_string()
            if name != "MASKED":
                counts[name] += 1
    with open(filename, "w") as f:
        f.write("ID\toccurrence\n")
        for name in sorted(counts):
            f.write(f"{name}\t{counts[name]}\n")


def print_mutation_type_counts(T: Tree, out=None) -> None:
    """4x4 from->to counts printed as 'X->Y\\tcount' (summary.cpp:224-243)."""
    out = out if out is not None else sys.stdout
    freq = [[0] * 4 for _ in range(4)]
    for s in T.depth_first_expansion():
        for m in s.mutations:
            a = nt_from_nuc_id(m.par_nuc)
            b = nt_from_nuc_id(m.mut_nuc)
            if a >= 0 and b >= 0:
                freq[a][b] += 1
    for a in range(4):
        for b in range(4):
            if a != b:
                out.write(f"{char_from_nuc_id(1 << a)}->"
                          f"{char_from_nuc_id(1 << b)}\t{freq[a][b]}\n")


def write_haplotype_table(T: Tree, filename: str) -> None:
    """mutation_set\\tsample_count: per distinct terminal mutation set
    (summary.cpp:246-263)."""
    counts: dict[str, int] = defaultdict(int)
    for s in T.get_leaves():
        key = ",".join(f"{m.position}{char_from_nuc_id(m.mut_nuc)}"
                       for m in s.mutations)
        counts[key] += 1
    with open(filename, "w") as f:
        f.write("mutation_set\tsample_count\n")
        for k in sorted(counts):
            f.write(f"{k}\t{counts[k]}\n")


def write_aberrant_table(T: Tree, filename: str) -> None:
    """NodeID\\tIssue sanity report (summary.cpp:266-296): duplicate ids,
    internal nodes with no mutations and <2 children, annotation-count
    mismatches."""
    num_annotations = T.get_num_annotations()
    seen: set[str] = set()
    with open(filename, "w") as f:
        f.write("NodeID\tIssue\n")
        for n in T.depth_first_expansion():
            if n.identifier in seen:
                f.write(f"{n.identifier}\tduplicate-node-id\n")
            seen.add(n.identifier)
            if (not n.is_leaf() and not n.mutations
                    and len(n.children) < 2 and n.parent is not None):
                f.write(f"{n.identifier}\tinternal-no-mutations\n")
            if len(n.clade_annotations) != num_annotations:
                f.write(f"{n.identifier}\tclade-annotations "
                        f"({len(n.clade_annotations)} not {num_annotations})\n")


def write_sample_clades_table(T: Tree, filename: str) -> None:
    """sample + first annotation found walking up, per annotation column
    (summary.cpp:297-339)."""
    num_annotations = T.get_num_annotations()
    with open(filename, "w") as f:
        f.write("sample")
        for i in range(num_annotations):
            f.write(f"\tannotation_{i+1}")
        f.write("\n")
        for s in T.get_leaves():
            found = [""] * num_annotations
            node = s
            remaining = num_annotations
            while node is not None and remaining:
                for i, a in enumerate(node.clade_annotations):
                    if a and not found[i]:
                        found[i] = a
                        remaining -= 1
                node = node.parent
            f.write(s.identifier)
            for i in range(num_annotations):
                f.write("\t" + (found[i] or "None"))
            f.write("\n")


def _sorted_muts(muts):
    return sorted(muts, key=lambda m: m.position)


def _combine_muts(parent_muts, node_muts):
    """Merge two sorted mutation lists, collapsing same-position entries and
    cancelling reversions (summary.cpp add_mutations:353-...)."""
    if not parent_muts:
        return list(node_muts)
    if not node_muts:
        return list(parent_muts)
    out = []
    px = 0
    for n in node_muts:
        while px < len(parent_muts) and parent_muts[px].position < n.position:
            out.append(parent_muts[px])
            px += 1
        if px < len(parent_muts) and parent_muts[px].position == n.position:
            p = parent_muts[px]
            if n.mut_nuc != p.par_nuc:  # else they cancel: add neither
                m = n.copy()
                m.par_nuc = p.par_nuc
                out.append(m)
            px += 1
        else:
            out.append(n)
    out.extend(parent_muts[px:])
    return out


def _count_reversions(clade_muts, node_muts) -> int:
    """#reversions to reference of clade_muts in node_muts (summary.cpp:566-585)."""
    rev = 0
    cx = 0
    if clade_muts and node_muts:
        for n in node_muts:
            while cx < len(clade_muts) and clade_muts[cx].position < n.position:
                cx += 1
            if (cx < len(clade_muts)
                    and clade_muts[cx].position == n.position
                    and n.mut_nuc == clade_muts[cx].par_nuc):
                rev += 1
    return rev


def write_node_stats(T: Tree, filename: str) -> None:
    """node\\tleaf_count\\tmut_count\\tmut_density\\trev_from_lineage
    (summary.cpp print_node_stats:587-633): per-node subtree leaf and
    mutation totals plus reversion count since the last annotated clade.

    The reference recurses and prints children before parents (post-order);
    we do the same with an explicit stack."""
    with open(filename, "w") as f:
        f.write("node\tleaf_count\tmut_count\tmut_density\trev_from_lineage\n")
        # state per visit: (node, clade_muts, my_muts, rev_count)
        leaf_counts: dict[str, int] = {}
        mut_counts: dict[str, int] = {}
        stack = [(T.root, [], [], 0, False)]
        while stack:
            node, clade_muts, parent_muts, parent_rev, exiting = stack.pop()
            if exiting:
                lc = sum(leaf_counts[c.identifier] for c in node.children)
                mc = (len(node.mutations)
                      + sum(mut_counts[c.identifier] for c in node.children))
                leaf_counts[node.identifier] = lc
                mut_counts[node.identifier] = mc
                f.write(f"{node.identifier}\t{lc}\t{mc}\t"
                        f"{_fmt_density(mc / lc if lc else 0.0)}\t{parent_rev}\n")
                continue
            muts = _sorted_muts(node.mutations)
            my_muts = _combine_muts(parent_muts, muts)
            is_clade_root = any(a != "" for a in node.clade_annotations)
            rev = 0 if is_clade_root else (parent_rev
                                           + _count_reversions(clade_muts, muts))
            if node.children:
                cmuts = my_muts if is_clade_root else clade_muts
                stack.append((node, clade_muts, parent_muts, rev, True))
                for child in reversed(node.children):
                    stack.append((child, cmuts, my_muts, rev, False))
            else:
                leaf_counts[node.identifier] = 1
                mut_counts[node.identifier] = len(node.mutations)
                f.write(f"{node.identifier}\t1\t{len(node.mutations)}\t"
                        f"{len(node.mutations)}\t{rev}\n")


def _fmt_density(v: float) -> str:
    # match C++ ostream default double formatting (6 significant digits)
    s = f"{v:.6g}"
    return s


def write_roho_table(T: Tree, filename: str, get_dates: bool = False,
                     date_metadata: dict[str, str] | None = None) -> None:
    """RoHo (ratio of homoplasic offspring, van Dorp et al. 2021) per
    mutation occurrence (summary.cpp write_roho_table:343-506).

    For each internal node: candidate mutations are those on its non-leaf
    children that never recur anywhere below; for each candidate, offspring
    with the mutation vs the median of sibling subtrees without it
    (subtrees of <=5 leaves excluded), single_roho = log10(with/median_without).
    `get_dates` adds sibling counts and earliest/latest collection dates from
    `date_metadata` (sample -> ISO date), the expanded-roho mode."""
    import math
    from datetime import date as _date
    date_metadata = date_metadata or {}

    def _parse_date(d):
        try:
            return _date.fromisoformat(d) and d
        except ValueError:
            return None

    def daterange(samples):
        # dates come from the metadata file when present, else from the
        # sample identifier suffix (name|accession|YYYY-MM-DD), matching the
        # reference daterange_from_list (introduce.cpp:395-436) which is
        # called with empty datemeta when no date file is given
        ds = []
        for s in samples:
            d = date_metadata.get(s, "")
            if not d:
                datend = s.rsplit("|", 1)[-1]
                if len(datend) == 8:
                    d = "20" + datend
                elif len(datend) == 10:
                    d = datend
                else:
                    continue
            d = _parse_date(d)
            if d:
                ds.append(d)
        ds.sort()
        return (ds[0], ds[-1]) if ds else ("None", "None")

    with open(filename, "w") as f:
        f.write("mutation\tparent_node\tchild_count\toccurrence_node\t"
                "offspring_with\tmedian_offspring_without\tsingle_roho")
        if get_dates:
            f.write("\tsister_clade_offspring_counts\t"
                    "identical_sample_sibling_count\tearliest_date\t"
                    "latest_date\tearliest_identical_sibling\t"
                    "latest_identical_sibling\tearliest_clade_sibling_dates\t"
                    "latest_clade_sibling_dates\n")
        else:
            f.write("\n")
        for n in T.depth_first_expansion():
            candidate: dict[str, str] = {}
            parent_identical: list[str] = []
            ccheck = []
            for c in n.children:
                if not c.is_leaf():
                    ccheck.append(c.identifier)
                    for m in c.mutations:
                        candidate[m.get_string()] = c.identifier
                elif not c.mutations:
                    parent_identical.append(c.identifier)
            if not candidate:
                continue
            child_increment: dict[str, int] = {}
            child_samples: dict[str, list[str]] = {}
            for c in n.children:
                if c.is_leaf():
                    continue
                samples = []
                ccount = 0
                for dn in T.depth_first_expansion(c):
                    if dn.identifier == c.identifier:
                        continue
                    if dn.is_leaf():
                        ccount += 1
                        if get_dates:
                            samples.append(dn.identifier)
                    for m in dn.mutations:
                        candidate.pop(m.get_string(), None)
                if ccount > 1:
                    child_increment[c.identifier] = ccount
                    if get_dates:
                        child_samples[c.identifier] = samples
            if not candidate or len(child_increment) <= 1:
                continue
            datemap = {}
            if get_dates:
                for cid, samples in child_samples.items():
                    datemap[cid] = daterange(samples)
                parent_identical_dates = daterange(parent_identical)
            for mstr, occ_node in sorted(candidate.items()):
                all_non = sorted(v for k, v in child_increment.items()
                                 if k != occ_node and v > 5)
                sum_wit = sum(v for k, v in child_increment.items()
                              if k == occ_node and v > 5)
                if not all_non or not sum_wit:
                    continue
                h = len(all_non) // 2
                if len(all_non) % 2 == 0:
                    # reference does integer division before assigning to float
                    med_non = float((all_non[h - 1] + all_non[h]) // 2)
                else:
                    med_non = float(all_non[h])
                roho = math.log10(sum_wit / med_non)
                # the reference writes a trailing tab after single_roho in
                # both modes (summary.cpp:483)
                f.write(f"{mstr}\t{n.identifier}\t{len(ccheck)}\t{occ_node}\t"
                        f"{sum_wit}\t{_fmt_density(med_non)}\t"
                        f"{_fmt_density(roho)}\t")
                if get_dates:
                    others = [k for k in child_increment if k != occ_node]
                    nonstrs = ",".join(str(len(child_samples[k]))
                                       for k in others)
                    ned = ",".join(datemap[k][0] for k in others)
                    nld = ",".join(datemap[k][1] for k in others)
                    dd = datemap.get(occ_node, ("None", "None"))
                    f.write(f"{nonstrs}\t{len(parent_identical)}\t"
                            f"{dd[0]}\t{dd[1]}\t")
                    if parent_identical:
                        f.write(f"{parent_identical_dates[0]}\t"
                                f"{parent_identical_dates[1]}\t")
                    else:
                        f.write("None\tNone\t")
                    f.write(f"{ned}\t{nld}\n")
                else:
                    f.write("\n")


def print_summary(T: Tree, out=None) -> None:
    """Default console summary: counts + parsimony (summary.cpp main)."""
    out = out if out is not None else sys.stdout
    leaves = T.get_leaves()
    total_nodes = T.num_nodes()
    score = T.get_parsimony_score()
    out.write(f"Total Nodes in Tree: {total_nodes}\n")
    out.write(f"Total Samples in Tree: {len(leaves)}\n")
    out.write(f"Total Tree Parsimony: {score}\n")
    num_annotations = T.get_num_annotations()
    clades: set[str] = set()
    for n in T.depth_first_expansion():
        for a in n.clade_annotations:
            if a:
                clades.add(a)
    out.write(f"Number of Annotated Clade Sets: {num_annotations}\n")
    out.write(f"Total Number of Clades: {len(clades)}\n")
