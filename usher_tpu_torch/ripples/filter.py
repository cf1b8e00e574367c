"""RIPPLES post-filtration: 3SEQ-style significance testing of candidates.

The reference filters raw ripples candidates with a GCP pipeline
(scripts/recombination/filtering/): trio sequences are reduced to the
informative-site pattern between recombinant and its two parents
(getABABA.py), summarized as (m, n, k) = (#sites matching the first parent,
#sites matching the other, maximum descent of the +1/-1 random walk —
makeMNK.py:47-60), and assigned a 3SEQ p-value from precomputed null tables
(combineAndGetPVals.py; Boni et al. 2007 statistic).

This native implementation computes the p-value EXACTLY instead of from
shipped tables: P(max drawdown >= k) for a uniformly random arrangement of
m up-steps and n down-steps, by dynamic programming over (steps used,
current drawdown), O((m+n) * k) per evaluation.  Candidate pre-filtering
follows combineAndGetPVals.py's essence: keep only each node's
best-improvement rows, deduplicate identical (donor, acceptor, interval)
trios, then report significant trios sorted by p-value.
"""

from __future__ import annotations

import sys
from functools import lru_cache

from ..core.tree import Tree


def max_descent(pattern: str, a: str = "A", b: str = "B") -> int:
    """Maximum descent of the +1 (a) / -1 (b) walk (makeMNK.py getK)."""
    height = 0
    peak = 0
    worst = 0
    for ch in pattern:
        if ch == a:
            height += 1
        else:
            height -= 1
        peak = max(peak, height)
        worst = max(worst, peak - height)
    return worst


@lru_cache(maxsize=65536)
def mnk_pvalue(m: int, n: int, k: int) -> float:
    """Exact P(max drawdown >= k) over uniformly random orderings of m
    up-steps and n down-steps.

    DP over probabilities: state = current drawdown (peak-so-far minus
    current height), capped at k (absorbing = "descent reached").  An
    up-step reduces drawdown by 1 (floor 0); a down-step increases it by 1.
    """
    if k <= 0:
        return 1.0
    if n < k:
        return 0.0
    # exact DP over (#ups used u, drawdown d), counting arrangements:
    # f[(u, d)] = number of length-t prefixes (t = u + v) using u ups and v
    # downs with drawdown d that never reached k.  Counts are exact Python
    # ints; normalize by C(m+n, m) at the end.
    from math import comb
    f = {(0, 0): 1}
    for t in range(m + n):
        nf: dict[tuple[int, int], int] = {}
        for (u, d), c in f.items():
            v = t - u
            if u < m:  # take an up-step
                key = (u + 1, max(d - 1, 0))
                nf[key] = nf.get(key, 0) + c
            if v < n:  # take a down-step
                d2 = d + 1
                if d2 < k:
                    key = (u, d2)
                    nf[key] = nf.get(key, 0) + c
                # d2 == k -> absorbed (excluded from survivor counts)
        f = nf
    survivors = sum(c for (u, d), c in f.items() if u == m)
    total = comb(m + n, m)
    p = 1.0 - survivors / total
    return min(max(p, 0.0), 1.0)


def node_states(T: Tree, node_id: str) -> dict[int, int]:
    """Path-accumulated allele per mutated position for a node."""
    node = T.get_node(node_id)
    if node is None:
        return {}
    chain = []
    cur = node
    while cur is not None:
        chain.append(cur)
        cur = cur.parent
    states: dict[int, int] = {}
    for nd in reversed(chain):
        for m in nd.mutations:
            if m.position >= 0:
                states[m.position] = m.mut_nuc
    return states


def trio_pattern(T: Tree, recomb_id: str, donor_id: str,
                 acceptor_id: str) -> str:
    """Informative-site pattern: at positions where donor and acceptor
    differ, 'A' if the recombinant matches the donor, 'B' if the acceptor;
    ambiguous/missing matches are skipped (getABABA.py semantics)."""
    r = node_states(T, recomb_id)
    d = node_states(T, donor_id)
    a = node_states(T, acceptor_id)
    pattern = []
    for pos in sorted(set(d) | set(a) | set(r)):
        dv = d.get(pos, 0)
        av = a.get(pos, 0)
        rv = r.get(pos, 0)
        if dv == av:
            continue
        if rv == dv:
            pattern.append("A")
        elif rv == av:
            pattern.append("B")
    return "".join(pattern)


def pattern_mnk(pattern: str) -> tuple[int, int, int]:
    """(m, n, k) with the walk oriented by the first symbol
    (makeMNK.py:26-30)."""
    if not pattern:
        return 0, 0, 0
    if pattern.startswith("A"):
        return (pattern.count("A"), pattern.count("B"),
                max_descent(pattern, "A", "B"))
    return (pattern.count("B"), pattern.count("A"),
            max_descent(pattern, "B", "A"))


def filter_recombinants(T: Tree, recombination_tsv: str, out_tsv: str,
                        pval_threshold: float = 0.05) -> int:
    """Read a ripples recombination.tsv, keep each node's best-improvement
    trios (combineAndGetPVals.py catOnlyBest), deduplicate, score with the
    exact 3SEQ statistic, and write significant rows sorted by p-value.
    Returns the number of significant trios."""
    rows: dict[str, list[list[str]]] = {}
    best_improvement: dict[str, int] = {}
    with open(recombination_tsv) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            cols = line.rstrip("\n").split("\t")
            node = cols[0]
            improvement = int(cols[-2]) - int(cols[-1])
            if node not in best_improvement \
                    or improvement > best_improvement[node]:
                best_improvement[node] = improvement
                rows[node] = []
            if improvement == best_improvement[node]:
                rows[node].append(cols)

    out_rows = []
    seen: set[tuple] = set()
    for node in sorted(rows):
        for cols in rows[node]:
            donor, acceptor = cols[3], cols[6]
            key = (node, donor, acceptor, cols[1], cols[2])
            if key in seen:
                continue
            seen.add(key)
            pattern = trio_pattern(T, node, donor, acceptor)
            m, n, k = pattern_mnk(pattern)
            if m + n == 0:
                continue
            p = mnk_pvalue(m, n, k)
            out_rows.append((p, node, donor, acceptor, cols[1], cols[2],
                             m, n, k, best_improvement[node]))

    out_rows.sort()
    n_sig = 0
    with open(out_tsv, "w") as f:
        f.write("#recomb_node_id\tdonor_node_id\tacceptor_node_id\t"
                "breakpoint-1_interval\tbreakpoint-2_interval\tm\tn\tk\t"
                "parsimony_improvement\t3seq_pvalue\tsignificant\n")
        for (p, node, donor, acceptor, bp1, bp2, m, n, k, imp) in out_rows:
            sig = p < pval_threshold
            n_sig += int(sig)
            f.write(f"{node}\t{donor}\t{acceptor}\t{bp1}\t{bp2}\t{m}\t{n}\t"
                    f"{k}\t{imp}\t{p:.6g}\t{'yes' if sig else 'no'}\n")
    print(f"{n_sig} significant trios (p < {pval_threshold}) of "
          f"{len(out_rows)}", file=sys.stderr)
    return n_sig
