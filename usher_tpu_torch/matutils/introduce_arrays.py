"""matUtils introduce over MatArrays: pandemic-scale introduction
inference without host Node objects.

The Tree path (matutils/introduce.py) rebuilds a full Python Tree and
runs one reverse-BFS dict sweep per region — minutes and GBs at the
reference's >2M-leaf public MAT.  Here the per-region O(N) confidence
sweep (reference src/matUtils/introduce.cpp:270-395) is a vectorized
level-synchronous numpy reduction, the uncertainty re-estimate
(:330-360) is a batched pointer-jump over all leaves at once, and only
the per-QUERY-sample introduction walks (:476-944) stay as host loops
(O(samples x depth), independent of N).  Outputs are byte-identical to
the Tree path — asserted by tests/test_introduce.py parity tests — which
is itself parity-tested against transcribed reference semantics.

Shared pure helpers (date parsing/formatting, two-column reader) are
imported from the Tree module; only the traversal layer is re-derived.
"""

from __future__ import annotations

import math
import os
import random
import sys
from collections import deque
from datetime import date as _date

import numpy as np

from .arrays import _children_lists, _dfs_arrays
from .introduce import (_fmt, _parse_any_date, _simple_date,
                        daterange_from_list, read_two_column)

BIG = 10_000_000


def _err(*a):
    print(*a, file=sys.stderr)


class IdxTree:
    """Uncondensed MAT as parallel index arrays (slots preserve the
    loader's DFS-preorder child order, so BFS/DFS sweeps visit nodes in
    exactly the host Tree's order)."""

    def __init__(self, ma):
        (self.names, nmut, self.muts_of, parent, self.children,
         self.root) = _children_lists(ma)
        self.ma = ma
        n = self.n = len(self.names)
        self.parent = np.asarray(parent, dtype=np.int64)
        self.parent[self.root] = -1
        self.nmut = np.asarray(nmut, dtype=np.int64)
        self.is_leaf = np.fromiter((not c for c in self.children),
                                   dtype=bool, count=n)
        dfs, size, level, pre = _dfs_arrays(self.children, self.root, n)
        self.dfs_idx = np.asarray(dfs, dtype=np.int64)
        self.dfs_size = np.asarray(size, dtype=np.int64)
        self.level = np.asarray(level, dtype=np.int64)
        self.pre = np.asarray(pre, dtype=np.int64)
        bfs = np.empty(n, dtype=np.int64)
        dq = deque([self.root])
        k = 0
        while dq:
            x = dq.popleft()
            bfs[k] = x
            k += 1
            dq.extend(self.children[x])
        self.bfs = bfs
        from ..io import pb_arrays as pa
        self.ann, self.ncols = pa.ann_lists(ma, n)
        self._name_idx: dict[str, int] | None = None

    def index(self) -> dict[str, int]:
        if self._name_idx is None:
            self._name_idx = {nm: i for i, nm in enumerate(self.names)}
        return self._name_idx

    def bfs_from(self, subroot: int) -> np.ndarray:
        out = []
        dq = deque([subroot])
        while dq:
            x = dq.popleft()
            out.append(x)
            dq.extend(self.children[x])
        return np.asarray(out, dtype=np.int64)

    def mut_strings(self, i: int) -> list[str]:
        """The node's mutation strings in stored order
        (Mutation.get_string: par_char + position + mut_char)."""
        from ..core.nuc import char_from_nuc_id
        k = self.muts_of[i]
        if k < 0:
            return []
        ma = self.ma
        lo, hi = int(ma.mut_ptr[k]), int(ma.mut_ptr[k + 1])
        return [char_from_nuc_id(int(ma.mut_par[j]))
                + str(int(ma.positions[ma.mut_col[j]]))
                + char_from_nuc_id(int(ma.mut_mut[j]))
                for j in range(lo, hi)]

    def anns_of(self, i: int) -> list[str]:
        return self.ann[i] if self.ann is not None else []


def get_assignments_arr(it: IdxTree, in_mask: np.ndarray,
                        eval_uncertainty: bool = False) -> np.ndarray:
    """Per-node IN/OUT confidence (introduce.cpp:270-395) as one
    level-synchronous numpy sweep: each node contributes
    (in_leaves, out_leaves, min_to_in+blen, min_to_out+blen) to its
    parent; deepest level first.  Matches the Tree path's reverse-BFS
    reduction exactly (child level is always parent level + 1)."""
    n = it.n
    inl = np.zeros(n, dtype=np.int64)
    outl = np.zeros(n, dtype=np.int64)
    mti = np.full(n, BIG, dtype=np.int64)
    mto = np.full(n, BIG, dtype=np.int64)
    order = np.argsort(it.level, kind="stable")
    lvl_sorted = it.level[order]
    maxlvl = int(lvl_sorted[-1]) if n else 0
    bounds = np.searchsorted(lvl_sorted, np.arange(maxlvl + 2))
    for li in range(maxlvl, 0, -1):
        idx = order[bounds[li]:bounds[li + 1]]
        if not len(idx):
            continue
        leaf = it.is_leaf[idx]
        s_in = in_mask[idx]
        bl = it.nmut[idx]
        c_inl = np.where(leaf, s_in.astype(np.int64), inl[idx])
        c_outl = np.where(leaf, (~s_in).astype(np.int64), outl[idx])
        c_mti = np.where(leaf, np.where(s_in, bl, BIG), mti[idx] + bl)
        c_mto = np.where(leaf, np.where(~s_in, bl, BIG), mto[idx] + bl)
        p = it.parent[idx]
        np.add.at(inl, p, c_inl)
        np.add.at(outl, p, c_outl)
        np.minimum.at(mti, p, c_mti)
        np.minimum.at(mto, p, c_mto)
    with np.errstate(divide="ignore", invalid="ignore"):
        vor = mto / outl
        vir = mti / inl
        frac = 1.0 / (1.0 + vir / vor)
    conf = np.where(outl == 0, 1.0,
                    np.where(inl == 0, 0.0,
                             np.where(mti == 0, 1.0,
                                      np.where(mto == 0, 0.0, frac))))
    conf = np.where(it.is_leaf, in_mask.astype(np.float64), conf)
    if eval_uncertainty:
        _err("Leaf label uncertainty estimate requested; calculating...")
        leaves = np.nonzero(it.is_leaf)[0]
        traversed = it.nmut[leaves].astype(np.float64)
        total = np.zeros(len(leaves))
        mx = np.zeros(len(leaves))
        cur = it.parent[leaves].copy()
        live = cur >= 0
        while live.any():
            c = cur[live]
            w = 1.0 / (1.0 + traversed[live]) ** 2
            total[live] += conf[c] * w
            mx[live] += w
            traversed[live] += it.nmut[c]
            cur[live] = it.parent[c]
            live = cur >= 0
        leafconf = np.where(mx > 0, total / np.where(mx > 0, mx, 1.0), 0.0)
        conf = conf.copy()
        conf[leaves] = leafconf
    return conf


def get_association_index_arr(it: IdxTree, conf: np.ndarray,
                              permute: bool = False,
                              subroot: int | None = None,
                              rng: random.Random | None = None) -> float:
    """Association index (introduce.cpp:108-198).  The non-permute case
    vectorizes: per-internal-node IN/OUT leaf counts come from one level
    sweep, and each node's term ((1 - max//total)/2^(total-1), integer
    division quirk and C++ pow-saturation preserved) sums in the Tree
    path's reversed-BFS order.  The permute case must consume the RNG in
    the exact per-leaf-child encounter order, so it stays a host loop."""
    rng = rng or random.Random()
    bfs = it.bfs if subroot is None else it.bfs_from(subroot)
    if permute:
        leaf_mask = it.is_leaf[bfs]
        leaf_count = int(leaf_mask.sum())
        sample_count = int((conf[bfs[leaf_mask]] > 0.5).sum())
        total_ai = 0.0
        tracker: dict[int, tuple[int, int]] = {}
        for x in reversed(bfs.tolist()):
            if it.is_leaf[x]:
                continue
            in_c = out_c = 0
            for c in it.children[x]:
                if it.is_leaf[c]:
                    if rng.randrange(leaf_count) <= sample_count:
                        in_c += 1
                    else:
                        out_c += 1
                else:
                    ti, to = tracker[c]
                    in_c += ti
                    out_c += to
            tracker[x] = (in_c, out_c)
            total = in_c + out_c
            if total > 0:
                total_ai += ((1 - max(in_c, out_c) // total)
                             / (2.0 ** (total - 1))
                             if total <= 1024 else 0.0)
        return total_ai
    # vectorized: IN-leaf / OUT-leaf counts under every node of the
    # subtree equal the global subtree counts (subtrees are intact)
    n = it.n
    inl = np.zeros(n, dtype=np.int64)
    outl = np.zeros(n, dtype=np.int64)
    order = np.argsort(it.level, kind="stable")
    lvl_sorted = it.level[order]
    maxlvl = int(lvl_sorted[-1]) if n else 0
    bounds = np.searchsorted(lvl_sorted, np.arange(maxlvl + 2))
    for li in range(maxlvl, 0, -1):
        idx = order[bounds[li]:bounds[li + 1]]
        if not len(idx):
            continue
        leaf = it.is_leaf[idx]
        s_in = conf[idx] > 0.5
        c_inl = np.where(leaf, s_in.astype(np.int64), inl[idx])
        c_outl = np.where(leaf, (~s_in).astype(np.int64), outl[idx])
        p = it.parent[idx]
        np.add.at(inl, p, c_inl)
        np.add.at(outl, p, c_outl)
    nodes = bfs[~it.is_leaf[bfs]]
    total = inl[nodes] + outl[nodes]
    q = 1 - np.maximum(inl[nodes], outl[nodes]) // np.maximum(total, 1)
    with np.errstate(over="ignore"):
        terms = np.where((total > 0) & (total <= 1024),
                         q / np.power(2.0, np.minimum(total, 1025) - 1),
                         0.0)
    # sequential sum in reversed-BFS order (float-add order parity)
    total_ai = 0.0
    for t in terms[::-1].tolist():
        total_ai += t
    return total_ai


def get_monophyletic_cladesize_arr(it: IdxTree, conf: np.ndarray,
                                   subroot: int | None = None) -> int:
    """Longest contiguous IN run over DFS-preorder leaves
    (introduce.cpp:200-233), vectorized over the dfs interval."""
    if subroot is None:
        seg = it.pre
    else:
        lo = int(it.dfs_idx[subroot])
        seg = it.pre[np.searchsorted(it.dfs_idx[it.pre], lo):]
        seg = seg[:int(it.dfs_size[subroot])]
    leaves = seg[it.is_leaf[seg]]
    if not len(leaves):
        return 0
    g = conf[leaves] >= 0.5
    # longest run of True: split at False boundaries
    padded = np.concatenate(([False], g, [False]))
    d = np.diff(padded.astype(np.int8))
    starts = np.nonzero(d == 1)[0]
    ends = np.nonzero(d == -1)[0]
    return int((ends - starts).max()) if len(starts) else 0


def record_clade_regions_arr(it: IdxTree, region_assignments: dict,
                             filename: str) -> None:
    """Per-clade-root IN support per region (introduce.cpp:236-266);
    rows in DFS order, trailing tabs as the reference writes them."""
    regions = list(region_assignments)
    with open(filename, "w") as f:
        f.write("clade\t")
        for r in regions:
            f.write(f"{r}\t")
        f.write("\n")
        for x in it.pre.tolist():
            for ca in it.anns_of(x):
                if not ca:
                    continue
                f.write(f"{ca}\t")
                for r in regions:
                    f.write(f"{_fmt(float(region_assignments[r][x]))}\t")
                f.write("\n")


def find_introductions_arr(it: IdxTree,
                           sample_regions: dict[str, list[str]],
                           add_info: bool = False, clade_output: str = "",
                           min_origin_confidence: float = 0.5,
                           bycluster: str = "", dump_assignments: str = "",
                           eval_uncertainty: bool = False,
                           earliest_date: str = "1500/1/1",
                           latest_date: str = "1500/1/1",
                           datemeta: dict[str, str] | None = None,
                           minimum_reporting: float = 0.05,
                           num_to_report: int = 1, look_ahead: int = 0,
                           minimum_gap: int = 0,
                           rng: random.Random | None = None) -> list[str]:
    """Core driver (introduce.cpp:476-944) over index arrays.  Structure
    and output construction mirror matutils/introduce.find_introductions
    line for line; node handles are slot ints, per-node dicts are numpy
    arrays."""
    datemeta = datemeta or {}
    rng = rng or random.Random(0)
    recency_filter = _parse_any_date(latest_date)
    early_filter = _parse_any_date(earliest_date)
    if recency_filter is None:
        raise ValueError("ERROR: Minimum latest date argument (-l) could "
                         "not be parsed.")
    if early_filter is None:
        raise ValueError("ERROR: Minimum earliest date argument (-L) "
                         "could not be parsed.")

    idx = it.index()
    region_assignments: dict[str, np.ndarray] = {}
    for region, samples in sample_regions.items():
        _err(f"Processing region {region} with {len(samples)} total "
             f"samples")
        smask = np.zeros(it.n, dtype=bool)
        for s in samples:
            j = idx.get(s)
            if j is not None:
                smask[j] = True
        assignments = get_assignments_arr(it, smask, eval_uncertainty)
        if add_info:
            global_mc = get_monophyletic_cladesize_arr(it, assignments)
            global_ai = get_association_index_arr(it, assignments)
            _err(f"Region largest monophyletic clade: {global_mc}, "
                 f"regional association index: {global_ai:f}")
            permvec = sorted(get_association_index_arr(it, assignments,
                                                       True, rng=rng)
                             for _ in range(100))
            _err(f"Real value {global_ai:f}. Quantiles of random expected "
                 f"AI for this sample size: {permvec[5]:f}, "
                 f"{permvec[25]:f}, {permvec[50]:f}, {permvec[75]:f}, "
                 f"{permvec[95]:f}")
        region_assignments[region] = assignments

    if clade_output:
        _err("Clade root region support requested; recording...")
        record_clade_regions_arr(it, region_assignments, clade_output)

    # nodes IN (> minimum_reporting) per region, for origin calls
    region_ins: dict[int, list[str]] = {}
    region_cons: dict[int, list[float]] = {}
    rev_bfs = it.bfs[::-1]
    for region, assigns in region_assignments.items():
        hot = rev_bfs[assigns[rev_bfs] > minimum_reporting]
        for x in hot.tolist():
            region_ins.setdefault(x, []).append(region)
            region_cons.setdefault(x, []).append(float(assigns[x]))

    _err("Regions processed; identifying introductions.")
    nann = len(it.anns_of(it.root))
    header = ("sample\tintroduction_node\tintroduction_rank\tgrowth_score"
              "\tearliest_date\tlatest_date\tcluster_size\tcluster_span\t"
              "intro_confidence\tparent_confidence\tdistance\torigin_gap")
    if len(region_assignments) > 1:
        header += "\tregion\torigins\torigins_confidence"
    for i in range(1, nann + 1):
        header += f"\tannotation_{i}"
    header += "\tmutation_path"
    if eval_uncertainty:
        header += "\tmeta_uncertainty"
    header += "\tmonophyl_size\tassoc_index\n" if add_info else "\n"
    outstrs = [header]
    bycluster_output: list[str] = []

    parent = it.parent
    nmut = it.nmut
    for region, assignments in region_assignments.items():
        samples = sample_regions[region]
        recorded_mc: dict[str, int] = {}
        recorded_ai: dict[str, float] = {}
        clusters: dict[str, dict[str, str]] = {}
        clustermeta: dict[str, str] = {}
        total_processed = 0

        for s in samples:
            node = idx.get(s)
            if node is None:
                _err(f"WARNING: query sample {s} not found in tree. "
                     f"continuing")
                continue
            last_encountered = s
            muts_of_last = 0
            last_node: int | None = None
            last_anc_state = 1.0
            traversed = int(nmut[node])
            a = int(parent[node])
            while a >= 0:
                aname = it.names[a]
                if parent[a] < 0:
                    last_encountered = aname
                    muts_of_last = int(nmut[a])
                    anc_state = 0.0
                else:
                    anc_state = float(assignments[a])
                if anc_state >= min_origin_confidence:
                    last_encountered = aname
                    muts_of_last = int(nmut[a])
                    last_node = a
                    last_anc_state = anc_state
                    traversed += int(nmut[a])
                    a = int(parent[a])
                    continue
                # look-ahead filter (introduce.cpp:594-625)
                lookahead_skip = False
                if parent[a] >= 0:
                    cnode = a
                    for _ in range(look_ahead):
                        cnode = int(parent[cnode])
                        if float(assignments[cnode]) > anc_state:
                            lookahead_skip = True
                            break
                        if parent[cnode] < 0:
                            break
                if lookahead_skip:
                    last_encountered = aname
                    muts_of_last = int(nmut[a])
                    last_node = a
                    last_anc_state = anc_state
                    traversed += int(nmut[a])
                    a = int(parent[a])
                    continue

                origins = ""
                origins_cons = ""
                if len(region_assignments) > 1 and parent[a] >= 0:
                    cand = region_ins.get(a)
                    if cand is not None:
                        count = (num_to_report if num_to_report > 0
                                 else len(cand))
                        oriscores: list[tuple[float, str]] = []
                        for i, rname in enumerate(cand):
                            if rname == region:
                                continue
                            oriscores.append((region_cons[a][i], rname))
                            oriscores.sort()
                            if (len(oriscores) > count
                                    and oriscores[0][0] < 1):
                                oriscores.pop(0)
                        if len(oriscores) > count and oriscores[0][0] == 1:
                            origins = (f"indeterminate: {len(oriscores)} "
                                       f"potential origins.")
                            origins_cons = "1"
                        else:
                            parts_r, parts_c = [], []
                            for conf_v, rname in oriscores:
                                parts_r.append(rname)
                                parts_c.append(_fmt(conf_v))
                            origins = ",".join(parts_r)
                            origins_cons = ",".join(parts_c)
                    else:
                        origins = "indeterminate: no information."
                        origins_cons = "0"
                if not origins:
                    origins = "indeterminate: no regions with support"
                    origins_cons = "0"

                # clades + mutation path from introduction point to root
                clid_count = len(it.anns_of(a))
                clades_rec: dict[int, str] = {}
                intro_mut_path = ""
                asn = a
                while asn >= 0:
                    intro_mut_path += ",".join(it.mut_strings(asn)) + "<"
                    for i, ann in enumerate(it.anns_of(asn)):
                        if ann and i not in clades_rec:
                            clades_rec[i] = ann
                    if len(clades_rec) == clid_count:
                        break
                    asn = int(parent[asn])
                intro_clades = ""
                for i in range(clid_count):
                    intro_clades += "\t" + clades_rec.get(i, "none")

                mc, ai = 0, 0.0
                if add_info:
                    if aname in recorded_mc:
                        mc = recorded_mc[aname]
                    else:
                        mc = get_monophyletic_cladesize_arr(
                            it, assignments, last_node)
                        recorded_mc[aname] = mc
                    if aname in recorded_ai:
                        ai = recorded_ai[aname]
                    else:
                        ai = get_association_index_arr(
                            it, assignments, False, last_node)
                        recorded_ai[aname] = ai

                if muts_of_last <= minimum_gap:
                    mgap = int(nmut[a])
                else:
                    mgap = muts_of_last
                    traversed -= muts_of_last

                ostr = (f"\t{_fmt(last_anc_state)}\t{_fmt(anc_state)}\t"
                        f"{traversed}\t{mgap}")
                mcl = (f"{_fmt(last_anc_state)}\t{_fmt(anc_state)}\t"
                       f"{mgap}")
                if len(region_assignments) > 1:
                    ostr += f"\t{region}\t{origins}\t{origins_cons}"
                    mcl += f"\t{region}\t{origins}\t{origins_cons}"
                ostr += f"{intro_clades}\t{intro_mut_path}"
                mcl += f"{intro_clades}\t{intro_mut_path}"
                if eval_uncertainty:
                    ostr += f"\t{_fmt(float(assignments[node]))}"
                if add_info:
                    ostr += f"\t{mc}\t{_fmt(ai)}\n"
                    mcl += f"\t{mc}\t{_fmt(ai)}"
                else:
                    ostr += "\n"

                key = (aname if muts_of_last <= minimum_gap
                       else last_encountered)
                clusters.setdefault(key, {})[s] = ostr
                clustermeta[key] = mcl
                total_processed += 1
                break

        # growth scoring + ranking (introduce.cpp:808-900)
        growthv: list[float] = []
        cgm: dict[float, list[str]] = {}
        date_tracker: dict[str, str] = {}
        for cid, csamples in clusters.items():
            dates = daterange_from_list(list(csamples), datemeta)
            diff_days = 0
            if dates is None:
                _err(f"WARNING: Cluster {cid} has no valid dates included "
                     f"among samples")
                ldatestr = "no-valid-date\tno-valid-date"
            else:
                if recency_filter > dates[1]:
                    continue
                if early_filter > dates[0]:
                    continue
                ldatestr = (_simple_date(dates[0]) + "\t"
                            + _simple_date(dates[1]))
                diff_days = (_date.today() - dates[0]).days
            date_tracker[cid] = ldatestr
            gv = math.sqrt(len(csamples)) / (diff_days // 7 + 1)
            growthv.append(gv)
            cgm.setdefault(gv, []).append(cid)
        growthv = sorted(set(growthv), reverse=True)
        rankr = 0
        for gv in growthv:
            for cid in cgm[gv]:
                if cid not in date_tracker:
                    continue
                cs = list(clusters[cid])
                span = 0
                if len(cs) > 1:
                    ancm: set[str] = set()
                    for s in cs:
                        cur = idx[s]
                        while cur >= 0:
                            nm = it.names[cur]
                            if nm == cid:
                                break
                            if nm not in ancm:
                                span += int(nmut[cur])
                                ancm.add(nm)
                            else:
                                break
                            cur = int(parent[cur])
                else:
                    span = int(nmut[idx[cs[0]]])
                rankr += 1
                clo = (f"{region}_{cid}\t{len(clusters[cid])}\t"
                       f"{date_tracker[cid]}\t{_fmt(gv)}\t{span}\t"
                       f"{clustermeta[cid]}\t" + ",".join(clusters[cid]))
                bycluster_output.append(clo + "\n")
                for s, srest in clusters[cid].items():
                    outstrs.append(
                        f"{s}\t{region}_{cid}\t{rankr}\t{_fmt(gv)}\t"
                        f"{date_tracker[cid]}\t{len(clusters[cid])}\t"
                        f"{span}{srest}")
        _err(f"Region {region} complete, {total_processed} samples "
             f"processed.")

    if dump_assignments:
        os.makedirs(dump_assignments, exist_ok=True)
        for region, assigns in region_assignments.items():
            with open(os.path.join(dump_assignments,
                                   f"{region}_assignments.tsv"), "w") as f:
                f.write("sample\tconfidence_continuous\n")
                # Tree-path dict insertion order == reversed BFS
                for x in rev_bfs.tolist():
                    conf = float(assigns[x])
                    if conf > 0:
                        f.write(f"{it.names[x]}\t{_fmt(conf)}\n")

    if bycluster:
        with open(bycluster, "w") as f:
            f.write("cluster_id\tsample_count\tearliest_date\tlatest_date"
                    "\tgrowth_score\tspan\tintro_confidence\t"
                    "parent_confidence\torigin_gap")
            if add_info:
                f.write("\tmonophyletic_cladesize\tassociation_index")
            if len(region_assignments) > 1:
                f.write("\tregion\tinferred_origin\t"
                        "inferred_origin_confidence")
            for i in range(1, nann + 1):
                f.write(f"\tannotation_{i}")
            f.write("\tmutation_path\tsamples\n")
            for line in bycluster_output:
                f.write(line)
    return outstrs


def introduce_main_arrays(input_mat: str, samples_filename: str,
                          additional_info: bool = False,
                          clade_regions: str = "", date_metadata: str = "",
                          full_output: str = "",
                          origin_confidence: float = 0.5,
                          evaluate_metadata: bool = False,
                          dump_assignments: str = "",
                          latest_date: str = "1500/1/1",
                          cluster_output: str = "",
                          earliest_date: str = "1500/1/1",
                          num_to_report: int = 1,
                          minimum_to_report: float = 0.05,
                          num_to_look: int = 0, minimum_gap: int = 0,
                          ma=None) -> list[str]:
    """CLI entry (introduce.cpp:944-996) off flat pb arrays — no host
    Tree; condensed nodes expand over index lists (same replay as the
    Tree path's uncondense_leaves)."""
    if ma is None:
        from ..io.pb_arrays import load_mat_arrays
        ma = load_mat_arrays(input_mat)
    it = IdxTree(ma)
    region_map = read_two_column(samples_filename)
    datemeta: dict[str, str] = {}
    if date_metadata:
        import csv
        delim = "," if date_metadata.endswith(".csv") else "\t"
        with open(date_metadata) as f:
            rdr = csv.DictReader(f, delimiter=delim)
            if rdr.fieldnames is None or "date" not in rdr.fieldnames:
                raise ValueError("ERROR: Metadata file does not contain "
                                 "required column 'date'; exiting")
            want = {s for ss in region_map.values() for s in ss}
            key_col = ("strain" if "strain" in rdr.fieldnames
                       else rdr.fieldnames[0])
            for row in rdr:
                k = row.get(key_col, "")
                if k in want:
                    datemeta[k] = row.get("date", "")
    outstrings = find_introductions_arr(
        it, region_map, additional_info, clade_regions, origin_confidence,
        cluster_output, dump_assignments, evaluate_metadata, earliest_date,
        latest_date, datemeta, minimum_to_report, num_to_report,
        num_to_look, minimum_gap)
    if full_output:
        with open(full_output, "w") as f:
            for o in outstrings:
                f.write(o)
    return outstrings
