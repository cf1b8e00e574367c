"""matUtils uncertainty: per-sample placement uncertainty (EPP count +
neighborhood size), batched on the placement kernel.

Parity with reference src/matUtils/uncertainty.cpp: findEPPs (:132-257)
re-places each sample (its root-path mutation set) against the full tree
with self-mapping excluded; neighborhood size (:4-123) is the longest direct
path between any two optimal placements through their MRCA.

The reference runs one tbb loop per sample; here samples batch through the
fused device scorer.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.tree import Mutation, Node, Tree
from ..placement.driver import PlacementEngine


def _err(*a):
    print(*a, file=sys.stderr)


def ancestral_mutation_set(T: Tree, node: Node) -> list[Mutation]:
    """The sample's genotype as mutations-from-reference: own mutations first,
    then ancestors', keeping the nearest entry per position (uncertainty.cpp
    :144-167)."""
    seen: set[int] = set()
    out: list[Mutation] = []
    for m in node.mutations:
        if m.is_masked() or m.position not in seen:
            out.append(m.copy())
            if not m.is_masked():
                seen.add(m.position)
    cur = node.parent
    while cur is not None:
        for m in cur.mutations:
            if m.is_masked() or m.position not in seen:
                out.append(m.copy())
                if not m.is_masked():
                    seen.add(m.position)
        cur = cur.parent
    out.sort(key=lambda m: m.position)
    # drop entries that equal the reference (no net difference)
    return [m for m in out if m.is_masked() or m.mut_nuc != m.ref_nuc]


def path_to_root(node: Node) -> list[Node]:
    out = [node]
    while out[-1].parent is not None:
        out.append(out[-1].parent)
    return out


def get_neighborhood_size(nodes: list[Node]) -> int:
    """Longest direct path between any two placements through their MRCA
    (uncertainty.cpp:41-123)."""
    if len(nodes) < 2:
        return 0
    paths = [path_to_root(n) for n in nodes]
    common = set(id(x) for x in paths[0])
    for p in paths[1:]:
        common &= set(id(x) for x in p)
    # MRCA = common ancestor with the smallest total distance
    best_anc = None
    best_total = None
    for anc in paths[0]:
        if id(anc) not in common:
            continue
        total = 0
        for p in paths:
            d = 0
            for n in p:
                if n is anc:
                    break
                d += len(n.mutations)
            total += d
        if best_total is None or total < best_total:
            best_total = total
            best_anc = anc
    dists = []
    for p in paths:
        d = 0
        for n in p:
            if n is best_anc:
                break
            d += len(n.mutations)
        dists.append(d)
    dists.sort()
    return int(dists[-1] + dists[-2])


def find_epps(T: Tree, sample_names: list[str], batch_size: int = 64,
              want_neighborhood: bool = True):
    """Returns {sample: (num_best, neighborhood_size, [placement nodes])}."""
    engine = PlacementEngine(T)
    results = {}
    todo = [s for s in sample_names if T.get_node(s) is not None]
    for start in range(0, len(todo), batch_size):
        chunk = todo[start:start + batch_size]
        muts = []
        excl = []
        for name in chunk:
            node = T.get_node(name)
            muts.append(ancestral_mutation_set(T, node))
            excl.append(node.slot)
        res = engine.score_samples(muts, exclude_slots=excl)
        for name, r in zip(chunk, res):
            node = T.get_node(name)
            if r.num_best > 1:
                placements = r.tied_nodes
                nsize = (get_neighborhood_size(placements)
                         if want_neighborhood else 0)
            else:
                placements = [node.parent]
                nsize = 0
            results[name] = (r.num_best, nsize, placements)
    return results


def get_samples_under_max_epps(T: Tree, max_epps: int) -> list[str]:
    """Samples whose EPP count <= max_epps (extract -e)."""
    leaves = T.get_leaves_ids()
    epps = find_epps(T, leaves, want_neighborhood=False)
    return [s for s in leaves
            if s in epps and epps[s][0] <= max_epps]


def uncertainty_main(T: Tree, sample_file: str, epps_out: str = "",
                     locs_out: str = "") -> int:
    """The uncertainty subcommand driver (uncertainty.cpp:259-340)."""
    from .select import read_sample_names
    samples = read_sample_names(sample_file)
    results = find_epps(T, samples)
    if epps_out:
        with open(epps_out, "w") as f:
            f.write("sample\tequally_parsimonious_placements\t"
                    "neighborhood_size\n")
            for s in samples:
                if s not in results:
                    _err(f"WARNING: sample {s} not found in tree")
                    continue
                nb, ns, _ = results[s]
                f.write(f"{s}\t{nb}\t{ns}\n")
    if locs_out:
        with open(locs_out, "w") as f:
            f.write("placement\tsample\n")
            for s in samples:
                if s not in results:
                    continue
                nb, ns, placements = results[s]
                if nb == 1:
                    f.write(f"{s}\t{s}\n")
                else:
                    for pn in placements:
                        f.write(f"{pn.identifier}\t{s}\n")
    return 0


# --- primer-dropout detection (reference uncertainty.cpp:412-527) -----------

def _fisher_test(a: int, b: int, c: int, d: int) -> float:
    """Two-tailed Fisher's exact test by hypergeometric pdf-cutoff summation
    (reference fisher_test, uncertainty.cpp:412-437)."""
    from math import exp, lgamma

    N = a + b + c + d
    r = a + c
    n = c + d

    def log_comb(nn, kk):
        if kk < 0 or kk > nn:
            return float("-inf")
        return (lgamma(nn + 1) - lgamma(kk + 1) - lgamma(nn - kk + 1))

    def pdf(k):
        return exp(log_comb(r, k) + log_comb(N - r, n - k) - log_comb(N, n))

    max_k = min(r, n)
    min_k = max(0, r + n - N)
    cutoff = pdf(c)
    total = 0.0
    for k in range(min_k, max_k + 1):
        p = pdf(k)
        if p <= cutoff:
            total += p
    return total


def _mutation_counts(T: Tree, root=None, by_location=False):
    counts: dict[str, int] = {}
    for n in T.depth_first_expansion(root):
        for m in n.mutations:
            key = str(m.position) if by_location else m.get_string()
            counts[key] = counts.get(key, 0) + 1
    return counts


def check_for_droppers(T: Tree, outf: str) -> None:
    """Find mutations enriched within subtrees (possible primer dropout):
    per split with subtree parsimony >= 50, Fisher's exact test of each
    mutation occurring >= 10 times inside vs the rest of the tree; mutations
    passing p < 0.05 get a secondary location-based test
    (check_for_droppers, uncertainty.cpp:444-527)."""
    gmap = _mutation_counts(T)
    locmap = _mutation_counts(T, by_location=True)
    global_parsimony = sum(gmap.values())

    pvals: dict[str, float] = {}
    lpvals: dict[str, float] = {}
    nodetrack: dict[str, str] = {}
    ocintrack: dict[str, int] = {}
    splitstrack: dict[str, int] = {}
    tests_performed = 0
    loc_tests_performed = 0
    for n in T.depth_first_expansion():
        lmap = _mutation_counts(T, n)
        local_parsimony = sum(lmap.values())
        if local_parsimony < 50:
            continue
        mloc = _mutation_counts(T, n, by_location=True)
        for mut, cnt in lmap.items():
            if cnt < 10:
                continue
            pv = _fisher_test(cnt, local_parsimony, gmap[mut] - cnt,
                              global_parsimony - local_parsimony)
            tests_performed += 1
            if pv < 0.05:
                locstr = mut[1:-1]
                lpv = _fisher_test(mloc.get(locstr, 0), local_parsimony,
                                   locmap.get(locstr, 0) - mloc.get(locstr, 0),
                                   global_parsimony - local_parsimony)
                loc_tests_performed += 1
                if mut not in pvals or pv < pvals[mut]:
                    pvals[mut] = pv
                    lpvals[mut] = lpv
                    nodetrack[mut] = n.identifier
                    ocintrack[mut] = cnt
                    splitstrack[mut] = local_parsimony
    with open(outf, "w") as f:
        f.write("mutation\tbranch\tpvalue\tcorrected_pvalue\toccurrences_in\t"
                "occurrences_out\tsplit_size\tlocation_pvalue\t"
                "location_corrected_pvalue\n")
        for mut in sorted(pvals):
            f.write(f"{mut}\t{nodetrack[mut]}\t{pvals[mut]}\t"
                    f"{pvals[mut] * tests_performed}\t{ocintrack[mut]}\t"
                    f"{gmap[mut] - ocintrack[mut]}\t{splitstrack[mut]}\t"
                    f"{lpvals[mut]}\t"
                    f"{lpvals[mut] * loc_tests_performed}\n")
