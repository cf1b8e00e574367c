"""RIPPLES recombination detection on the port (counterpart of
usher_tpu/ripples/detect.py; semantics transcribed from reference
src/ripples/main.cpp:167-714 with the ripples-fast prefix-count
acceleration, src/ripples/ripples_fast/ripples.hpp Mut_Count_t).

For each candidate node (branch length >= branch_len, >= num_descendants
leaves) the node's root-path mutation set is the "pruned sample".  X13 gives
the per-(node, position) parsimony-cost indicators C[n,p] (the summand of
the placement score), so

  full placement score[n]             = sum_p C[n,p]
  donor score  (i,j)[n]               = sum_{p in [pos_i, pos_{j-1}]} C[n,p]
  acceptor score (i,j)[n]             = score[n] - donor score[n]

through one prefix sum along the sorted position axis.  X13 runs as torch
ops on the FlatMAT's device (``_cost_matrix``): in row blocks, with the
prefix sums gathered at the only columns the pair loop reads (the sample's
columns c and c - 1, and column 0), so no [cap, P] array is formed or copied
to the host.  ``_cost_matrix_plain`` is the JAX program's form (the whole
[cap, P_pad] prefix-sum matrix), kept as the plain version the tests and
chip_smoke.py hold the device form against.

Donor/acceptor pairing, interval refinement against the donor's path
mutations and interval merging (combine_intervals, main.cpp:133-164) run on
the host as in the JAX module, restructured only where the output stays
byte-identical: the node names, DFS indices and leaf mask are built once
per run, the first 1,000 nodes of each (interval parsimony, name) order are
selected by a name rank with np.argpartition, and the pair search stops
once no later (donor, acceptor) can meet the parsimony bound.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass

import numpy as np
import torch

from ..core.flat import FlatMAT, collect_positions
from ..core.tree import Mutation, Tree
from ..ops.placement import parent_states

# elements of one [rows, P_pad] block of X13's temporaries
BLOCK_ELEMS = 1 << 27
# donors and acceptors tried per breakpoint pair (main.cpp's 1,000)
MAX_TRIED = 1000


def _err(*a):
    print(*a, file=sys.stderr, flush=True)


@dataclass
class RipplesOptions:
    branch_len: int = 3            # -l
    num_descendants: int = 10      # -n
    parsimony_improvement: int = 3 # -p
    min_range: int = 1_000         # -r
    max_range: int = 10_000_000    # -R
    start_idx: int = -1            # -S
    end_idx: int = -1              # -E
    outdir: str = "."
    samples_file: str = ""


@dataclass
class RecombNode:
    name: str
    node_parsimony: int
    parsimony: int
    is_sibling: str


@dataclass
class RecombInterval:
    d: RecombNode
    a: RecombNode
    start_range_low: int
    start_range_high: int
    end_range_low: int
    end_range_high: int


def pruned_sample_mutations(node) -> list[Mutation]:
    """Node->root path mutations, nearest-per-position, net-reference entries
    dropped, par_nuc reset to ref (reference Pruned_Sample::add_mutation,
    main.cpp:68-82)."""
    positions: set[int] = set()
    out: list[Mutation] = []
    cur = node
    while cur is not None:
        for m in cur.mutations:
            if m.position not in positions:
                if m.ref_nuc != m.mut_nuc:
                    mm = m.copy()
                    mm.par_nuc = mm.ref_nuc
                    out.append(mm)
            positions.add(m.position)
        cur = cur.parent
    out.sort(key=lambda m: m.position)
    return out


def _cost_matrix_plain(st, stp, ref, active, g, E, miss):
    """X13 as the JAX program computes it: per-(node, position) cost
    indicators of one sample (g, E, miss [1, P_pad]) against every node
    slot, their int32 prefix sums along positions ``csum`` [cap, P_pad], the
    per-node totals and has_unique [cap].  ``active`` is unused, as there."""
    bm = st != stp
    gb = g[:, None, :]
    matched = (gb & st[None, :, :]) != 0
    excl = bm[None, :, :] & ~matched
    A = torch.where(excl, stp[None, :, :], st[None, :, :])
    Eb = E[:, None, :]
    term1 = Eb & (~miss[:, None, :]) & ((gb & A) == 0)
    term2 = (~Eb) & (A != ref[None, None, :])
    C = (term1 | term2)[0]                                   # [N,P]
    del A, term1, term2
    num_common = (bm[None, :, :] & matched)[0].sum(-1, dtype=torch.int32)
    node_num_mut = bm.sum(-1, dtype=torch.int32)
    has_unique = num_common < node_num_mut
    total = C.sum(-1, dtype=torch.int32)
    csum = torch.cumsum(C, dim=-1, dtype=torch.int32)
    return csum, total, has_unique


def gather_columns(cols_of_sample) -> np.ndarray:
    """The sorted prefix-sum columns the pair loop reads for a sample whose
    mutations sit at columns ``cols_of_sample``: each c, each c - 1 > -1,
    and column 0 (the loop's j = 0 read)."""
    c = np.asarray(cols_of_sample, dtype=np.int64)
    return np.unique(np.concatenate([[0], c, c[c > 0] - 1]))


def _cost_matrix(st, stp, ref, g, E, miss, cols):
    """X13 on the device: ``_cost_matrix_plain`` for one sample (g uint8,
    E, miss bool, each [P_pad]) with ``csum`` gathered at the sorted columns
    ``cols`` (int64 [G]).  Returns (csum [cap, G] int32, total [cap] int32,
    has_unique [cap] bool), on st's device.

    Row blocks of BLOCK_ELEMS elements keep the temporaries at a few
    [rows, P_pad] arrays.  Within E the indicator is term1 and outside it
    term2, so C = where(E, ~miss & (g & A) == 0, A != ref); all nibble
    arithmetic stays uint8 and every sum is an int32 count."""
    cap, P = st.shape
    dev = st.device
    csum = torch.empty((cap, cols.shape[0]), dtype=torch.int32, device=dev)
    total = torch.empty(cap, dtype=torch.int32, device=dev)
    has_unique = torch.empty(cap, dtype=torch.bool, device=dev)
    keep = E & ~miss
    rows = max(1, BLOCK_ELEMS // max(1, P))
    for r0 in range(0, cap, rows):
        s = st[r0:r0 + rows]
        sp = stp[r0:r0 + rows]
        bm = s != sp
        matched = (g & s) != 0
        A = torch.where(bm & ~matched, sp, s)
        C = torch.where(E, keep & ((g & A) == 0), A != ref)
        del A
        num_common = (bm & matched).sum(-1, dtype=torch.int32)
        has_unique[r0:r0 + rows] = num_common < bm.sum(-1, dtype=torch.int32)
        del bm, matched
        total[r0:r0 + rows] = C.sum(-1, dtype=torch.int32)
        csum[r0:r0 + rows] = torch.cumsum(C, dim=-1, dtype=torch.int32)[
            :, cols]
    return csum, total, has_unique


def combine_intervals(pairs: list[RecombInterval]) -> list[RecombInterval]:
    """Merge adjacent equal-scoring intervals (reference main.cpp:133-164)."""
    pairs = sorted(pairs, key=lambda p: p.end_range_low)
    i = 0
    while i < len(pairs):
        j = i + 1
        while j < len(pairs):
            pi, pj = pairs[i], pairs[j]
            if (pi.d.name == pj.d.name and pi.a.name == pj.a.name
                    and pi.start_range_low == pj.start_range_low
                    and pi.start_range_high == pj.start_range_high
                    and pi.end_range_high == pj.end_range_low
                    and pi.d.parsimony + pi.a.parsimony
                    == pj.d.parsimony + pj.a.parsimony):
                pi.end_range_high = pj.end_range_high
                del pairs[j]
            else:
                j += 1
        i += 1
    pairs.sort(key=lambda p: p.start_range_low)
    i = 0
    while i < len(pairs):
        j = i + 1
        while j < len(pairs):
            pi, pj = pairs[i], pairs[j]
            if (pi.d.name == pj.d.name and pi.a.name == pj.a.name
                    and pi.end_range_low == pj.end_range_low
                    and pi.end_range_high == pj.end_range_high
                    and pi.start_range_high == pj.start_range_low
                    and pi.d.parsimony + pi.a.parsimony
                    == pj.d.parsimony + pj.a.parsimony):
                pi.start_range_high = pj.start_range_high
                del pairs[j]
            else:
                j += 1
        i += 1
    return pairs


def first_by_parsimony(p, rank, n_names: int, limit: int = MAX_TRIED):
    """Indices of the first ``limit`` entries of p in the order (p, name),
    given each entry's name rank: the JAX module's
    ``sorted((p, name, slot))[:limit]`` (names are unique, so the order is
    total and the slot never decides)."""
    key = p.astype(np.int64) * n_names + rank
    if len(key) > limit:
        part = np.argpartition(key, limit - 1)[:limit]
        return part[np.argsort(key[part])]
    return np.argsort(key)


def first_pair(don, acc, don_p, acc_p, names, bound: int):
    """The first (donor, acceptor) of the JAX module's double loop over the
    two ordered lists whose names differ and whose parsimonies sum to at
    most ``bound``; (i, j) into don / acc, or None.  Both lists ascend in
    parsimony, so an acceptor past the bound ends its row and a donor whose
    sum with the first acceptor passes it ends the search."""
    if len(acc) == 0:
        return None
    a_min = int(acc_p[0])
    for i in range(len(don)):
        dp = int(don_p[i])
        if dp + a_min > bound:
            return None
        dname = names[don[i]]
        for j in range(len(acc)):
            if dp + int(acc_p[j]) > bound:
                break
            if names[acc[j]] != dname:
                return i, j
    return None


def ripples_main(T: Tree, opts: RipplesOptions, device: torch.device) -> int:
    """The ripples run, X13 on ``device``; files and messages as the JAX
    module's."""
    T.uncondense_leaves()
    bfs = T.breadth_first_expansion()

    # candidate long branches (main.cpp:196-254)
    if opts.samples_file:
        from ..matutils.select import read_sample_names
        cand_set: set[str] = set()
        for s in read_sample_names(opts.samples_file):
            n = T.get_node(s)
            if n is None:
                _err(f"ERROR: Node id {s} not found!")
                return 1
            cur = n
            while cur is not None:
                cand_set.add(cur.identifier)
                cur = cur.parent
        candidates = sorted(cand_set)
    else:
        candidates = sorted(
            n.identifier for n in bfs
            if n.parent is not None and len(n.mutations) >= opts.branch_len
            and T.get_num_leaves(n) >= opts.num_descendants)
    # the reference shuffles with seed 0 for load balancing across -S/-E
    import random
    random.Random(0).shuffle(candidates)
    _err(f"Found {len(candidates)} long branches")

    os.makedirs(opts.outdir, exist_ok=True)
    desc_file = open(os.path.join(opts.outdir, "descendants.tsv"), "w")
    desc_file.write("#node_id\tdescendants\n")
    recomb_file = open(os.path.join(opts.outdir, "recombination.tsv"), "w")
    recomb_file.write(
        "#recomb_node_id\tbreakpoint-1_interval\tbreakpoint-2_interval\t"
        "donor_node_id\tdonor_is_sibling\tdonor_parsimony\tacceptor_node_id\t"
        "acceptor_is_sibling\tacceptor_parsimony\toriginal_parsimony\t"
        "min_starting_parsimony\trecomb_parsimony\n")

    s = 0
    e = len(candidates)
    if opts.start_idx >= 0 and opts.end_idx >= 0:
        s = opts.start_idx
        e = min(opts.end_idx, e)

    positions, ref, chrom = collect_positions(T)
    flat = FlatMAT(T, positions, ref, chrom, device=device)
    st_dev, parent_dev = flat.sync()
    stp_dev = parent_states(st_dev, parent_dev, flat.root_slot)
    meta = flat.order_arrays()
    num_leaves_arr = meta["num_leaves"]

    # per-run host arrays over the BFS nodes (the tree does not change in
    # the loop): slot, DFS index, name and its rank, leaf mask
    T.depth_first_expansion()
    bfs_slot = np.array([n2.slot for n2 in bfs], dtype=np.int64)
    bfs_dfs = np.array([n2.dfs_idx for n2 in bfs], dtype=np.int64)
    names = [None] * flat.cap
    for n2 in bfs:
        names[n2.slot] = n2.identifier
    name_rank = np.zeros(flat.cap, dtype=np.int64)
    by_name = sorted(bfs, key=lambda n2: n2.identifier)
    name_rank[[n2.slot for n2 in by_name]] = np.arange(len(by_name))
    n_names = max(1, len(by_name))
    leaf_slots = np.array([n2.slot for n2 in bfs if n2.is_leaf()],
                          dtype=np.int64)
    enough_leaves = num_leaves_arr[bfs_slot] >= opts.num_descendants

    GENOME_SIZE = 10 ** 9
    num_done = 0
    for idx in range(s, e):
        nid = candidates[idx]
        node = T.get_node(nid)
        _err(f"At node id: {nid}")
        orig_parsimony = len(node.mutations)

        sample_muts = pruned_sample_mutations(node)
        num_mutations = len(sample_muts)
        if num_mutations == 0:
            num_done += 1
            continue

        g, E, miss = flat.encode_samples([sample_muts])
        pos_of = [m.position for m in sample_muts]
        col_of = [flat.pos_index[p] for p in pos_of]
        gcols = gather_columns(col_of)
        at = {int(c): k for k, c in enumerate(gcols.tolist())}
        csum, total, has_unique = _cost_matrix(
            st_dev, stp_dev, flat.ref_dev,
            torch.from_numpy(g[0]).to(device),
            torch.from_numpy(E[0]).to(device),
            torch.from_numpy(miss[0]).to(device),
            torch.from_numpy(gcols).to(device))
        csum = csum.cpu().numpy()
        total = total.cpu().numpy()
        has_unique = has_unique.cpu().numpy()

        # node eligibility: enough descendants, not in candidate's subtree
        lo, hi = node.dfs_idx, node.dfs_end_idx
        elig_bfs = enough_leaves & ~((lo <= bfs_dfs) & (bfs_dfs < hi))
        elig = np.sort(bfs_slot[elig_bfs])
        leaf_or_unique = has_unique.copy()
        leaf_or_unique[leaf_slots] = True
        csum_e = csum[elig]
        total_e = total[elig]
        rank_e = name_rank[elig]

        valid_pairs: list[RecombInterval] = []
        has_recomb = False
        for i in range(num_mutations):
            for j in range(i, num_mutations):
                start_range_high = pos_of[i]
                start_range_low = pos_of[i - 1] if i >= 1 else 0
                end_range_high = GENOME_SIZE
                end_range_low = pos_of[j - 1] if j >= 1 else 0

                donor_count = j - i
                acceptor_count = num_mutations - donor_count
                if (donor_count < opts.branch_len
                        or acceptor_count < opts.branch_len
                        or end_range_low - start_range_high < opts.min_range
                        or end_range_low - start_range_high > opts.max_range):
                    continue

                # donor interval = positions in [pos_i, pos_{j-1}]
                hi_col = col_of[j - 1] if j >= 1 else 0
                lo_col = col_of[i]
                donor_p = csum_e[:, at[hi_col]] - (
                    csum_e[:, at[lo_col - 1]] if lo_col > 0 else 0)
                acceptor_p = total_e - donor_p

                thr = orig_parsimony - opts.parsimony_improvement
                acc_ok = np.nonzero(acceptor_p <= thr)[0]
                don_ok = np.nonzero(donor_p <= thr)[0]
                if not len(acc_ok) or not len(don_ok):
                    continue

                # reference sorts candidates by (interval parsimony, name)
                acc = acc_ok[first_by_parsimony(acceptor_p[acc_ok],
                                                rank_e[acc_ok], n_names)]
                don = don_ok[first_by_parsimony(donor_p[don_ok],
                                                rank_e[don_ok], n_names)]
                hit = first_pair(elig[don], elig[acc], donor_p[don],
                                 acceptor_p[acc], names, thr)
                if hit is None:
                    continue
                dk, ak = int(elig[don[hit[0]]]), int(elig[acc[hit[1]]])
                dp, ap_ = int(donor_p[don[hit[0]]]), int(acceptor_p[acc[hit[1]]])
                dname, aname = names[dk], names[ak]

                # refine breakpoint intervals against donor-path and sample
                # mutations (main.cpp:609-663)
                donor_path = pruned_sample_mutations(T.get_node(dname))
                sample_pos = set(pos_of)
                donor_pos = {m.position for m in donor_path}
                for p in donor_pos:
                    if start_range_low < p <= start_range_high and \
                            p not in sample_pos:
                        start_range_low = p
                    if end_range_low < p <= end_range_high and \
                            p not in sample_pos:
                        end_range_high = p
                for p in sample_pos:
                    if start_range_low < p <= start_range_high and \
                            p not in donor_pos:
                        start_range_low = p
                    if end_range_low < p <= end_range_high and \
                            p not in donor_pos:
                        end_range_high = p

                d = RecombNode(dname, int(total[dk]), dp,
                               "y" if leaf_or_unique[dk] else "n")
                a = RecombNode(aname, int(total[ak]), ap_,
                               "y" if leaf_or_unique[ak] else "n")
                valid_pairs.append(RecombInterval(
                    d, a, start_range_low, start_range_high,
                    end_range_low, end_range_high))
                has_recomb = True

        valid_pairs = combine_intervals(valid_pairs)
        for p in valid_pairs:
            erh = ("GENOME_SIZE" if p.end_range_high == GENOME_SIZE
                   else str(p.end_range_high))
            recomb_file.write(
                f"{nid}\t({p.start_range_low},{p.start_range_high})\t"
                f"({p.end_range_low},{erh})\t{p.d.name}\t{p.d.is_sibling}\t"
                f"{p.d.node_parsimony}\t{p.a.name}\t{p.a.is_sibling}\t"
                f"{p.a.node_parsimony}\t{orig_parsimony}\t"
                f"{min(orig_parsimony, p.d.node_parsimony, p.a.node_parsimony)}\t"
                f"{p.d.parsimony + p.a.parsimony}\n")
        recomb_file.flush()

        num_done += 1
        if has_recomb:
            desc_file.write(nid + "\t" + ",".join(
                l.identifier for l in T.get_leaves(nid)) + ",\n")
            desc_file.flush()
            _err(f"Done {num_done}/{len(candidates)} branches "
                 f"[RECOMBINATION FOUND!]\n")
        else:
            _err(f"Done {num_done}/{len(candidates)} branches\n")

    desc_file.close()
    recomb_file.close()
    return 0
