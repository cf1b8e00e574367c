"""Sample selection engine behind matUtils extract.

Behavioral parity with reference src/matUtils/select.cpp (functions cited
per-line); every filter returns a sample-name list and extract intersects
them.
"""

from __future__ import annotations

import re
import sys

import numpy as np

from ..core.tree import Tree


def _err(*a):
    print(*a, file=sys.stderr)


def read_sample_names(path: str) -> list[str]:
    """One sample name per line (reference select.cpp:8-36; tolerates
    quotes/CR, warns on tab-containing lines)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n").rstrip("\r").strip('"').strip("'")
            if not line:
                continue
            if "\t" in line:
                _err("WARNING: sample file contains tabs; using first field")
                line = line.split("\t")[0]
            out.append(line)
    return out


def get_clade_samples(T: Tree, clade_name: str) -> list[str]:
    """Leaves below any node annotated with clade_name (select.cpp:38-65)."""
    samples: list[str] = []
    for node in T.depth_first_expansion():
        if clade_name in node.clade_annotations:
            samples.extend(l.identifier for l in T.get_leaves(node.identifier))
    return samples


def get_mutation_samples(T: Tree, mut_str: str) -> list[str]:
    """Leaves whose root-path carries the mutation string, e.g. "A23403G" or
    "23403" for any mutation at the position (select.cpp:67-111)."""
    samples = []
    pos_only = mut_str.isdigit()
    for leaf in T.get_leaves():
        found = False
        node = leaf
        while node is not None and not found:
            for m in node.mutations:
                s = m.get_string()
                if (pos_only and str(m.position) == mut_str) or s == mut_str:
                    found = True
                    break
            node = node.parent
        if found:
            samples.append(leaf.identifier)
    return samples


def get_parsimony_samples(T: Tree, max_parsimony: int) -> list[str]:
    """Leaves with terminal branch length (mutation count) <= max
    (select.cpp:113-127)."""
    return [l.identifier for l in T.get_leaves()
            if len(l.mutations) <= max_parsimony]


def get_short_steppers(T: Tree, samples: list[str],
                       max_branch: int) -> list[str]:
    """Samples with no ancestral branch longer than max_branch
    (select.cpp:278-307)."""
    out = []
    for name in samples:
        node = T.get_node(name)
        if node is None:
            continue
        ok = True
        cur = node
        while cur is not None:
            if len(cur.mutations) > max_branch:
                ok = False
                break
            cur = cur.parent
        if ok:
            out.append(name)
    return out


def get_short_paths(T: Tree, samples: list[str], max_path: int) -> list[str]:
    """Samples whose total root-path mutation count <= max_path
    (select.cpp:309-335)."""
    out = []
    for name in samples:
        node = T.get_node(name)
        if node is None:
            continue
        total = 0
        cur = node
        while cur is not None:
            total += len(cur.mutations)
            cur = cur.parent
        if total <= max_path:
            out.append(name)
    return out


def get_sample_match(T: Tree, pattern: str) -> list[str]:
    """Leaves whose identifier matches the regex (select.cpp:506-520)."""
    rx = re.compile(pattern)
    return [l.identifier for l in T.get_leaves() if rx.search(l.identifier)]


def get_nearby(T: Tree, sample_id: str, k: int) -> list[str]:
    """The sample plus its k nearest leaves by mutation path distance
    (select.cpp:206-276: walks up from the sample expanding subtrees until
    >= k+1 leaves are within the best distance bound)."""
    node = T.get_node(sample_id)
    if node is None:
        _err(f"ERROR: sample {sample_id} not found in tree")
        return []
    # distances via upward walk: for each ancestor, descend into the other
    # children accumulating branch lengths (mutation counts)
    dists: dict[str, int] = {sample_id: 0}

    def descend(start, base):
        stack = [(start, base + len(start.mutations))]
        while stack:
            cur, d = stack.pop()
            if cur.is_leaf():
                prev = dists.get(cur.identifier)
                if prev is None or d < prev:
                    dists[cur.identifier] = d
            for ch in cur.children:
                stack.append((ch, d + len(ch.mutations)))

    prev = node
    up = len(node.mutations)
    cur = node.parent
    while cur is not None:
        for ch in cur.children:
            if ch is not prev:
                descend(ch, up)
        prev = cur
        up += len(cur.mutations)
        cur = cur.parent
    ranked = sorted((d, name) for name, d in dists.items() if name != sample_id)
    return [sample_id] + [name for _, name in ranked[:k]]


def get_closest_samples(T: Tree, nid: str, fixed_k: bool,
                        k: int) -> tuple[list[str], int]:
    """Closest leaves to a sample by mutation-path distance
    (reference select.cpp:596-713 get_closest_samples).

    fixed_k=False: the set of equidistant closest relatives and their
    distance (-V/--closest-relatives).  fixed_k=True: every leaf within
    distance k (--within-distance / mask -D); returned distance is 0.

    The walk mirrors the reference exactly: climb ancestors accumulating
    branch lengths; at each level collect sibling-subtree leaves (internal
    siblings are expanded depth-first, pruned at the current bound); stop
    climbing when a found leaf is closer than the next hop up (non-fixed)
    or the next hop alone exceeds k (fixed)."""
    target = T.get_node(nid)
    if target is None:
        _err(f"WARNING: Node {nid} not found in tree")
        return [], 0
    target_parent = target.parent
    curr_target = target

    closest: list[str] = []
    closest_dist = 0
    min_dist = 1 << 60
    dist_to_orig_parent = 0
    go_up = True
    parent = target.parent
    while go_up and parent is not None:
        parent_branch_length = len(parent.mutations) + dist_to_orig_parent
        found: list[tuple[str, int]] = []

        # minimum sibling-leaf branch length bounds the non-fixed descent
        min_sib = 1 << 60
        for child in parent.children:
            if child.is_leaf() and child.identifier != curr_target.identifier:
                min_sib = min(min_sib, len(child.mutations))

        for child in parent.children:
            if child.identifier == curr_target.identifier:
                continue
            if (target_parent is not None
                    and child.identifier == target_parent.identifier):
                continue  # don't go back down the path
            dist_so_far = (dist_to_orig_parent + len(target.mutations)
                           + len(child.mutations))
            if not child.is_leaf():
                if fixed_k:
                    max_path = k
                elif min_sib == (1 << 60):
                    max_path = min_sib
                else:
                    max_path = min_sib + dist_so_far
                # iterative DFS of closest_samples_dfs (select.cpp:577-594)
                stack = [(child, dist_so_far)]
                while stack:
                    node, plen = stack.pop()
                    if plen > max_path:
                        continue
                    for ch in node.children:
                        d = plen + len(ch.mutations)
                        if ch.is_leaf():
                            if not fixed_k or d <= max_path:
                                found.append((ch.identifier, d))
                        else:
                            stack.append((ch, d))
            else:
                if not fixed_k or dist_so_far <= k:
                    found.append((child.identifier, dist_so_far))

        if fixed_k:
            if parent_branch_length > k:
                go_up = False
            closest.extend(name for name, _ in found)
        else:
            for name, d in found:
                if d < parent_branch_length:
                    go_up = False
                if d < min_dist:
                    min_dist = d
                    closest = [name]
                    closest_dist = d
                elif d == min_dist:
                    closest.append(name)

        curr_target = parent
        parent = curr_target.parent
        dist_to_orig_parent = parent_branch_length
    return closest, closest_dist


def get_mrca_samples(T: Tree, samples: list[str]) -> list[str]:
    """All leaves under the MRCA of the given samples (select.cpp:570-596)."""
    nodes = [T.get_node(s) for s in samples]
    nodes = [n for n in nodes if n is not None]
    if not nodes:
        return []
    # LCA by level-walk
    cur = nodes[0]
    for other in nodes[1:]:
        a, b = cur, other
        while a.level > b.level:
            a = a.parent
        while b.level > a.level:
            b = b.parent
        while a is not b:
            a = a.parent
            b = b.parent
        cur = a
    return [l.identifier for l in T.get_leaves(cur.identifier)]


def get_internal_descendents(T: Tree, node_id: str) -> list[str]:
    """Leaves under an internal node (extract -I)."""
    if T.get_node(node_id) is None:
        _err(f"ERROR: node {node_id} not found in tree")
        return []
    return [l.identifier for l in T.get_leaves(node_id)]


def filter_mut_density(T: Tree, samples: list[str],
                       max_density: float) -> list[str]:
    """Drop samples under internal nodes whose mean descendant mutation count
    exceeds max_density (select.cpp:337-466)."""
    # accumulate (sum of subtree mutation counts, leaf count) bottom-up
    dfs = T.depth_first_expansion()
    tot = {id(n): len(n.mutations) for n in dfs}
    cnt = {id(n): (1 if n.is_leaf() else 0) for n in dfs}
    for n in reversed(dfs):
        if n.parent is not None:
            tot[id(n.parent)] += tot[id(n)]
            cnt[id(n.parent)] += cnt[id(n)]
    keep = set(samples)
    for n in dfs:
        if not n.is_leaf() and cnt[id(n)] > 0:
            dens = tot[id(n)] / cnt[id(n)]
            if dens > max_density:
                for l in T.get_leaves(n.identifier):
                    keep.discard(l.identifier)
    return [s for s in samples if s in keep]


def get_clade_representatives(T: Tree, per_clade: int = 2) -> list[str]:
    """At least `per_clade` representative samples per annotated clade: the
    longest and shortest path leaves below each clade root
    (select.cpp:129-204)."""
    samples: set[str] = set()
    seen_clades: set[str] = set()
    for node in T.breadth_first_expansion():
        for ann in node.clade_annotations:
            if ann and ann not in seen_clades:
                seen_clades.add(ann)
                leaves = T.get_leaves(node.identifier)
                if not leaves:
                    continue
                ranked = sorted(leaves, key=lambda l: l.level)
                chosen = [ranked[0], ranked[-1]]
                for extra in ranked[1:-1]:
                    if len(chosen) >= per_clade:
                        break
                    chosen.append(extra)
                samples.update(l.identifier for l in chosen[:max(per_clade, 2)])
    return sorted(samples)


def fill_random_samples(T: Tree, samples: list[str], target_size: int,
                        lca_limit: bool = False, seed: int = 0) -> list[str]:
    """Grow/shrink the selection to target_size with random leaves, optionally
    only below the selection's MRCA (select.cpp:522-568)."""
    rng = np.random.default_rng(seed)
    current = list(dict.fromkeys(samples))
    if len(current) > target_size:
        idx = rng.choice(len(current), size=target_size, replace=False)
        return [current[i] for i in sorted(idx)]
    pool_source = (get_mrca_samples(T, current)
                   if (lca_limit and current) else T.get_leaves_ids())
    pool = [s for s in pool_source if s not in set(current)]
    need = target_size - len(current)
    if need >= len(pool):
        current.extend(pool)
    elif need > 0:
        idx = rng.choice(len(pool), size=need, replace=False)
        current.extend(pool[i] for i in sorted(idx))
    return current
