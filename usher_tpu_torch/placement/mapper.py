"""Host-side exact placement scorer for a single (node, sample) pair.

Semantically identical to the device kernel (ops/placement.py) but also
produces the excess/imputed mutation vectors that drive tree surgery and
reporting.  Used for the winning node of each sample, as the -p per-node
reporting path, and as the independent oracle the device kernel is tested
against.  Behavior transcribed from reference usher_mapper.cpp:167-504.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..core.tree import Mutation, Node


@dataclass
class PlacementScore:
    set_difference: int = 0
    node_num_mut: int = 0
    num_common: int = 0
    has_unique: bool = False
    is_valid: bool = False
    excess: list[Mutation] = field(default_factory=list)
    imputed: list[Mutation] = field(default_factory=list)


def score_placement(node: Node, sample_muts: list[Mutation],
                    compute_vecs: bool = True) -> PlacementScore:
    res = PlacementScore()
    sample_by_pos: dict[int, Mutation] = {}
    for m in sample_muts:
        sample_by_pos.setdefault(m.position, m)

    # --- accumulate the effective root->node path state ("ancestral
    # mutations"), conditionally including the node's own branch mutations
    # (usher_mapper.cpp:186-289).
    anc: dict[int, Mutation] = {}
    if node.parent is not None:
        for m1 in node.mutations:
            res.node_num_mut += 1
            if m1.is_masked():
                res.has_unique = True
                break
            anc_nuc = m1.mut_nuc
            m2 = sample_by_pos.get(m1.position)
            found = False
            if m2 is not None:
                if m2.is_missing:
                    found = True
                    res.num_common += 1
                elif m2.mut_nuc & anc_nuc:
                    mm = m1.copy()
                    mm.mut_nuc = anc_nuc
                    anc[mm.position] = mm
                    if compute_vecs:
                        res.excess.append(mm)
                    found = True
                    res.num_common += 1
            else:
                if anc_nuc == m1.ref_nuc:
                    mm = m1.copy()
                    mm.mut_nuc = anc_nuc
                    anc[mm.position] = mm
                    if compute_vecs:
                        res.excess.append(mm)
                    res.num_common += 1
                    found = True
            if not found and not (m2 is None and anc_nuc == m1.ref_nuc):
                res.has_unique = True
    else:
        for m in node.mutations:
            anc[m.position] = m

    n = node
    while n.parent is not None:
        n = n.parent
        for m in n.mutations:
            if not m.is_masked() and m.position not in anc:
                anc[m.position] = m

    # --- new mutations required by the sample (usher_mapper.cpp:291-388)
    for m1 in sample_muts:
        if m1.is_missing:
            continue
        has_ref = (m1.mut_nuc & m1.ref_nuc) != 0
        m2 = anc.get(m1.position)
        found_pos = m2 is not None and not m2.is_masked()
        anc_nuc = m2.mut_nuc if found_pos else m1.ref_nuc
        found = found_pos and (m1.mut_nuc & anc_nuc) != 0
        ambiguous = (m1.mut_nuc & (m1.mut_nuc - 1)) != 0
        if found:
            if compute_vecs and ambiguous:
                res.imputed.append(Mutation(m1.chrom, m1.position, m1.ref_nuc,
                                            anc_nuc, anc_nuc))
        elif not found_pos and has_ref:
            if compute_vecs and ambiguous:
                res.imputed.append(Mutation(m1.chrom, m1.position, m1.ref_nuc,
                                            anc_nuc, m1.ref_nuc))
        else:
            if has_ref:
                mut_nuc = m1.ref_nuc
            else:
                mut_nuc = m1.mut_nuc & (-m1.mut_nuc)  # lowest set bit
            m = Mutation(m1.chrom, m1.position, m1.ref_nuc, anc_nuc, mut_nuc)
            if compute_vecs and ambiguous:
                res.imputed.append(m)
            if m.mut_nuc != m.par_nuc:
                if compute_vecs:
                    res.excess.append(m)
                res.set_difference += 1

    # --- back mutations for path states the sample does not carry
    # (usher_mapper.cpp:390-445)
    for pos in sorted(anc):
        m1 = anc[pos]
        if m1.is_masked():
            continue
        anc_nuc = m1.mut_nuc
        m2 = sample_by_pos.get(pos)
        found_pos = m2 is not None
        found = found_pos and (m2.is_missing or (m2.mut_nuc & anc_nuc) != 0)
        if found:
            pass
        elif not found_pos and anc_nuc == m1.ref_nuc:
            pass
        elif found_pos and not found:
            pass  # already counted above
        else:
            m = Mutation(m1.chrom, pos, m1.ref_nuc, anc_nuc, m1.ref_nuc)
            if m.mut_nuc != m.par_nuc:
                res.set_difference += 1
                if compute_vecs:
                    res.excess.append(m)

    # --- placement validity (usher_mapper.cpp:452-455)
    is_leaf = node.is_leaf()
    res.is_valid = (
        node.parent is None
        or (res.has_unique and not is_leaf and res.num_common > 0
            and res.node_num_mut != res.num_common)
        or (is_leaf and res.num_common > 0)
        or (not res.has_unique and not is_leaf
            and res.node_num_mut == res.num_common))
    return res
