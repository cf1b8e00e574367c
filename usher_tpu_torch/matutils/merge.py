"""matUtils merge: combine two MATs sharing a common base.

Parity with reference src/matUtils/merge.cpp:125 (merge_main): the larger
tree is the base; samples common to both are consistency-checked by exact
genotype reconstruction; samples exclusive to the second tree are placed
into the base by maximum parsimony (batched on the placement kernel,
replacing the reference's per-sample mapper loop).
"""

from __future__ import annotations

import sys

from ..core.tree import MissingSample, Mutation, Tree


def _err(*a):
    print(*a, file=sys.stderr)


def sample_genotype_mutations(T: Tree, name: str) -> list[Mutation]:
    """Sample's net mutations from the reference (nearest entry per
    position along the root path; reference merge.cpp consistency check)."""
    node = T.get_node(name)
    seen: set[int] = set()
    out = []
    cur = node
    while cur is not None:
        for m in cur.mutations:
            if not m.is_masked() and m.position not in seen:
                seen.add(m.position)
                if m.mut_nuc != m.ref_nuc:
                    out.append(m.copy())
        cur = cur.parent
    out.sort(key=lambda m: m.position)
    return out


def consistent(T1: Tree, T2: Tree, name: str) -> bool:
    g1 = {m.position: m.mut_nuc for m in sample_genotype_mutations(T1, name)}
    g2 = {m.position: m.mut_nuc for m in sample_genotype_mutations(T2, name)}
    if set(g1) != set(g2):
        return False
    return all(g1[p] & g2[p] for p in g1)


def _first_leaf(node):
    """First leaf reached by always descending children[0]
    (merge.cpp:41-47 get_first_leaf)."""
    while node.children:
        node = node.children[0]
    return node.identifier


def _lca(T: Tree, id1: str, id2: str):
    a, b = T.get_node(id1), T.get_node(id2)
    if a is None or b is None:
        return None
    while a.level > b.level:
        a = a.parent
    while b.level > a.level:
        b = b.parent
    while a is not b:
        a = a.parent
        b = b.parent
    return a


def consistent_nodes(base: Tree, other: Tree,
                     common: list[str]) -> dict[str, str]:
    """other-node-id -> base-node-id map over the common-leaf backbone
    (merge.cpp:52-122 consistent): prune base to the common leaves,
    drop unary chains, then for every surviving internal node take the
    first leaves of its first two children and map LCA(other) ->
    LCA(base); common leaves map to themselves."""
    out: dict[str, str] = {}
    if not common:
        return out
    sub = base.copy()
    keep = set(common)
    for leaf in list(sub.get_leaves_ids()):
        if leaf not in keep:
            sub.remove_node(leaf, False)
    sub.remove_single_child_nodes()
    for n in sub.depth_first_expansion():
        if len(n.children) > 1:
            l1 = _first_leaf(n.children[0])
            l2 = _first_leaf(n.children[1])
            lca_base = _lca(base, l1, l2)
            lca_other = _lca(other, l1, l2)
            if lca_base is not None and lca_other is not None:
                out[lca_other.identifier] = lca_base.identifier
        elif not n.children:
            out[n.identifier] = n.identifier
    return out


def _restricted_ids(T: Tree, anchor_id: str, max_depth: int) -> set[str]:
    """Identifiers of nodes within max_depth levels below the anchor
    (merge.cpp:238,254-258: bfs from curr, skip level gaps > max_levels)."""
    anchor = T.get_node(anchor_id)
    if anchor is None:
        anchor = T.root
    out = set()
    stack = [(anchor, 0)]
    while stack:
        n, d = stack.pop()
        out.add(n.identifier)
        if d < max_depth:
            stack.extend((c, d + 1) for c in n.children)
    return out


def merge_mats(T1: Tree, T2: Tree, max_uncertainty: int = 1_000_000,
               max_depth: int = 20) -> Tree:
    """Merge T2 into T1 (the reference picks the larger tree as base;
    callers should order arguments accordingly).  Returns the base tree.

    max_depth (-d, merge.cpp:16,133): each new sample's placement search
    is bounded to the subtree within max_depth levels of its closest
    consistent anchor node, like the reference's bounded BFS.  Samples are
    batch-scored globally first; a sample whose global winner lies inside
    its bound keeps it (the global optimum restricted to a subset is the
    subset optimum), others are re-scored with the restriction applied."""
    if T1.condensed_nodes:
        T1.uncondense_leaves()
    if T2.condensed_nodes:
        T2.uncondense_leaves()
    leaves1 = set(T1.get_leaves_ids())
    leaves2 = T2.get_leaves_ids()

    common = [s for s in leaves2 if s in leaves1]
    new = [s for s in leaves2 if s not in leaves1]
    _err(f"{len(common)} shared samples, {len(new)} samples to place.")

    bad = [s for s in common if not consistent(T1, T2, s)]
    if bad:
        raise ValueError(
            f"ERROR: {len(bad)} shared samples have inconsistent genotypes "
            f"(e.g. {bad[0]}); trees do not share a common base")

    if new:
        from ..placement.driver import PlacementEngine
        from ..placement.mapper import score_placement

        consist = consistent_nodes(T1, T2, common)
        # per-sample anchor: first consistent ancestor in T2, else root
        anchors: dict[str, str] = {}
        for name in new:
            anchor = T1.root.identifier
            for anc in T2.rsearch(name, True):
                got = consist.get(anc.identifier)
                if got is not None:
                    anchor = got
                    break
            anchors[name] = anchor

        missing = []
        # positions in T2 samples may be absent from T1; collect the union
        extra_positions = {}
        for name in new:
            muts = sample_genotype_mutations(T2, name)
            s = MissingSample(name)
            s.mutations = muts
            missing.append(s)
            for m in muts:
                extra_positions[m.position] = m

        # seed T1's position set with any new positions via a pseudo "vcf"
        class _Site:
            __slots__ = ("position", "ref_nuc", "chrom", "variants")

            def __init__(self, m):
                self.position = m.position
                self.ref_nuc = m.ref_nuc
                self.chrom = m.chrom
                self.variants = []

        class _Vcf:
            def __init__(self, sites):
                self.sites = sites
                self.sample_ids = []

        vcf = _Vcf([_Site(m) for m in extra_positions.values()])
        engine = PlacementEngine(T1, vcf)
        placed = retried = 0
        bsz = 256
        for start in range(0, len(missing), bsz):
            chunk = [s for s in missing[start:start + bsz]
                     if T1.get_node(s.name) is None]
            if not chunk:
                continue
            results = engine.score_samples([s.mutations for s in chunk])
            touched: set[str] = set()
            for s, res in zip(chunk, results):
                allow = _restricted_ids(T1, anchors[s.name], max_depth)
                best = res.best_node
                stale = (best is None
                         or best.identifier not in allow
                         or T1.get_node(best.identifier) is not best
                         or best.identifier in touched
                         or (best.parent is not None
                             and best.parent.identifier in touched))
                if stale:
                    allow_slots = [
                        {T1.get_node(i).slot for i in allow
                         if T1.get_node(i) is not None}]
                    res = engine.score_samples(
                        [s.mutations], restrict_slots=allow_slots)[0]
                    best = res.best_node
                    retried += 1
                if best is None or res.num_best > max_uncertainty:
                    # no valid candidate in range: the reference's default
                    # placement target is the anchor itself
                    # (merge.cpp:243-247 best_node = bfs[0])
                    anchor_node = T1.get_node(anchors[s.name]) or T1.root
                    detail = score_placement(anchor_node, s.mutations)
                    from ..placement.driver import SampleResult
                    res = SampleResult(
                        best_score=detail.set_difference, num_best=1,
                        best_node=anchor_node, best_has_unique=False)
                    best = anchor_node
                else:
                    detail = score_placement(best, s.mutations)
                    if detail.set_difference != res.best_score:
                        allow_slots = [
                            {T1.get_node(i).slot for i in allow
                             if T1.get_node(i) is not None}]
                        res = engine.score_samples(
                            [s.mutations],
                            restrict_slots=allow_slots)[0]
                        best = res.best_node
                        detail = score_placement(best, s.mutations)
                        retried += 1
                parent_before = best.parent
                engine.apply_placement(s.name, res, detail.excess)
                placed += 1
                touched.add(best.identifier)
                touched.add(s.name)
                if parent_before is not None:
                    touched.add(parent_before.identifier)
                if (best.parent is not None
                        and best.parent is not parent_before):
                    touched.add(best.parent.identifier)
        _err(f"Placed {placed} samples ({retried} bounded/stale "
             f"re-scores).")
    return T1
