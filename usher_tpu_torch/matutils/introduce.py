"""matUtils introduce: geographic introduction inference.

Parity with reference src/matUtils/introduce.cpp:
  read_two_column          (:70-108)   region assignment file reader
  get_association_index    (:108-198)  Wang et al 2005 AI over reverse BFS,
                                       with the reference's integer-division
                                       quirk reproduced exactly (:196)
  get_monophyletic_cladesize (:200-233) longest IN run over DFS leaves
  get_assignments          (:270-395)  leaf->root IN/OUT confidence heuristic
  daterange_from_list      (:395-444)  metadata or name-suffix dates
  find_introductions       (:476-944)  per-sample/per-cluster outputs,
                                       origins for multi-region, growth rank
  introduce_main           (:944-996)
"""

from __future__ import annotations

import math
import os
import random
import sys
from datetime import date as _date

from ..core.tree import Tree


def _err(*a):
    print(*a, file=sys.stderr)


def _fmt(v) -> str:
    """C++ ostream default float formatting (6 significant digits)."""
    if isinstance(v, int):
        return str(v)
    return f"{float(v):.6g}"


def read_two_column(filename: str) -> dict[str, list[str]]:
    """sample[\tregion] lines -> region -> [samples]; single-column files get
    region "default" (introduce.cpp:70-108)."""
    amap: dict[str, list[str]] = {}
    with open(filename) as f:
        for line in f:
            line = line.rstrip("\n").rstrip("\r")
            if not line:
                continue
            words = line.split("\t")
            if len(words) == 1:
                amap.setdefault("default", []).append(words[0])
            elif len(words) == 2:
                amap.setdefault(words[1], []).append(words[0])
            else:
                raise ValueError(
                    f"ERROR: Too many columns in file {filename}- check format")
    return amap


def get_association_index(T: Tree, assignments: dict[str, float],
                          permute: bool = False, subroot=None,
                          rng: random.Random | None = None) -> float:
    """Association index (small = strong correlation) over a reverse-BFS
    sweep.  NOTE: the reference computes max(in,out)/total in INTEGER
    division (introduce.cpp:196), so each internal node contributes
    1/2^(leaves-1) unless one trait covers all its leaves — reproduced
    exactly for parity."""
    rng = rng or random.Random()
    bfs = T.breadth_first_expansion(subroot.identifier if subroot else "")
    leaf_count = 0
    sample_count = 0
    if permute:
        for b in bfs:
            if b.is_leaf():
                leaf_count += 1
                if assignments.get(b.identifier, 0.0) > 0.5:
                    sample_count += 1
    total_ai = 0.0
    tracker: dict[str, tuple[int, int]] = {}
    for n in reversed(bfs):
        if n.is_leaf():
            continue
        in_c = out_c = 0
        for c in n.children:
            if c.is_leaf():
                if permute:
                    if rng.randrange(leaf_count) <= sample_count:
                        in_c += 1
                    else:
                        out_c += 1
                else:
                    a = assignments.get(c.identifier)
                    if a is not None:
                        if a > 0.5:
                            in_c += 1
                        else:
                            out_c += 1
            else:
                ti, to = tracker[c.identifier]
                in_c += ti
                out_c += to
        tracker[n.identifier] = (in_c, out_c)
        total = in_c + out_c
        if total > 0:
            # integer division quirk preserved; C++ pow(2, total-1)
            # saturates to inf past DBL_MAX (2^1024) making the term 0,
            # where Python ** raises OverflowError — mirror the C++
            total_ai += ((1 - max(in_c, out_c) // total)
                         / (2.0 ** (total - 1)) if total <= 1024 else 0.0)
    return total_ai


def get_monophyletic_cladesize(T: Tree, assignments: dict[str, float],
                               subroot=None) -> int:
    """Largest fully-IN clade = longest contiguous IN run over DFS leaves
    (introduce.cpp:200-233)."""
    biggest = current = 0
    for n in T.depth_first_expansion(subroot):
        if not n.is_leaf():
            continue
        a = assignments.get(n.identifier)
        if a is None:
            continue
        if a >= 0.5:
            current += 1
        else:
            biggest = max(biggest, current)
            current = 0
    return max(biggest, current)


def get_assignments(T: Tree, sample_set: set[str],
                    eval_uncertainty: bool = False) -> dict[str, float]:
    """IN/OUT confidence per node (introduce.cpp:270-395): leaves by
    membership; internal nodes all-IN/all-OUT, else
    C = 1/(1 + (min_to_in/in_leaves)/(min_to_out/out_leaves)), with
    identical-child override."""
    BIG = 10_000_000
    assignments: dict[str, float] = {}
    stored: dict[str, tuple[int, int, int, int]] = {}
    bfs = T.breadth_first_expansion()
    for n in reversed(bfs):
        if n.is_leaf():
            assignments[n.identifier] = (1.0 if n.identifier in sample_set
                                         else 0.0)
            continue
        in_leaves = out_leaves = 0
        min_to_in = min_to_out = BIG
        for c in n.children:
            blen = len(c.mutations)
            if not c.is_leaf():
                ci, co, mi, mo = stored[c.identifier]
                in_leaves += ci
                out_leaves += co
                min_to_in = min(min_to_in, mi + blen)
                min_to_out = min(min_to_out, mo + blen)
            elif c.identifier in sample_set:
                in_leaves += 1
                min_to_in = min(min_to_in, blen)
            else:
                out_leaves += 1
                min_to_out = min(min_to_out, blen)
        stored[n.identifier] = (in_leaves, out_leaves, min_to_in, min_to_out)
        if out_leaves == 0:
            assignments[n.identifier] = 1.0
        elif in_leaves == 0:
            assignments[n.identifier] = 0.0
        elif min_to_in == 0:
            assignments[n.identifier] = 1.0
        elif min_to_out == 0:
            assignments[n.identifier] = 0.0
        else:
            vor = min_to_out / out_leaves
            vir = min_to_in / in_leaves
            assignments[n.identifier] = 1.0 / (1.0 + (vir / vor))
    if eval_uncertainty:
        _err("Leaf label uncertainty estimate requested; calculating...")
        for leaf in T.get_leaves():
            total_conf = 0.0
            max_conf = 0.0
            traversed = float(len(leaf.mutations))
            for anc in T.rsearch(leaf.identifier, False):
                acv = assignments[anc.identifier]
                total_conf += acv / ((1 + traversed) ** 2)
                max_conf += 1 / ((1 + traversed) ** 2)
                traversed += float(len(anc.mutations))
            assignments[leaf.identifier] = (total_conf / max_conf
                                            if max_conf else 0.0)
    return assignments


def _parse_any_date(s: str):
    """boost::gregorian::from_string accepts '2021-01-05' and '2021/1/5'."""
    for sep in ("-", "/"):
        parts = s.split(sep)
        if len(parts) == 3:
            try:
                return _date(int(parts[0]), int(parts[1]), int(parts[2]))
            except ValueError:
                return None
    return None


def daterange_from_list(sample_list, datemeta: dict[str, str]):
    """(earliest, latest) over metadata dates, falling back to the sample
    name suffix name|acc|YYYY-MM-DD (introduce.cpp:395-444); None if no
    valid dates."""
    earliest = latest = None
    for s in sample_list:
        d = None
        if s in datemeta:
            d = _parse_any_date(datemeta[s])
            if d is None:
                _err(f"WARNING: Malformed date {datemeta[s]} provided in "
                     f"date file for sample {s}; ignoring sample date")
                continue
        else:
            datend = s.rsplit("|", 1)[-1]
            if len(datend) == 8:
                d = _parse_any_date("20" + datend)
            elif len(datend) == 10:
                d = _parse_any_date(datend)
            if d is None:
                continue
        earliest = d if earliest is None or d < earliest else earliest
        latest = d if latest is None or d > latest else latest
    if earliest is None:
        return None
    return (earliest, latest)


def _simple_date(d: _date) -> str:
    """boost to_simple_string: 2021-Jan-05."""
    months = ["Jan", "Feb", "Mar", "Apr", "May", "Jun",
              "Jul", "Aug", "Sep", "Oct", "Nov", "Dec"]
    return f"{d.year}-{months[d.month - 1]}-{d.day:02d}"


def find_introductions(T: Tree, sample_regions: dict[str, list[str]],
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
    """Core driver (introduce.cpp:476-944).  Returns the per-sample output
    lines (header first); writes clade/cluster/assignment side outputs."""
    datemeta = datemeta or {}
    rng = rng or random.Random(0)
    recency_filter = _parse_any_date(latest_date)
    early_filter = _parse_any_date(earliest_date)
    if recency_filter is None:
        raise ValueError("ERROR: Minimum latest date argument (-l) could not "
                         "be parsed.")
    if early_filter is None:
        raise ValueError("ERROR: Minimum earliest date argument (-L) could "
                         "not be parsed.")

    region_assignments: dict[str, dict[str, float]] = {}
    for region, samples in sample_regions.items():
        _err(f"Processing region {region} with {len(samples)} total samples")
        sample_set = set(samples)
        assignments = get_assignments(T, sample_set, eval_uncertainty)
        if add_info:
            global_mc = get_monophyletic_cladesize(T, assignments)
            global_ai = get_association_index(T, assignments)
            _err(f"Region largest monophyletic clade: {global_mc}, regional "
                 f"association index: {global_ai:f}")
            permvec = sorted(get_association_index(T, assignments, True,
                                                   rng=rng)
                             for _ in range(100))
            _err(f"Real value {global_ai:f}. Quantiles of random expected AI "
                 f"for this sample size: {permvec[5]:f}, {permvec[25]:f}, "
                 f"{permvec[50]:f}, {permvec[75]:f}, {permvec[95]:f}")
        region_assignments[region] = assignments

    if clade_output:
        _err("Clade root region support requested; recording...")
        record_clade_regions(T, region_assignments, clade_output)

    # nodes that are IN (> minimum_reporting) per region, for origin calls
    region_ins: dict[str, list[str]] = {}
    region_cons: dict[str, list[float]] = {}
    for region, assigns in region_assignments.items():
        for nid, conf in assigns.items():
            if conf > minimum_reporting:
                region_ins.setdefault(nid, []).append(region)
                region_cons.setdefault(nid, []).append(conf)

    _err("Regions processed; identifying introductions.")
    nann = T.get_num_annotations()
    header = ("sample\tintroduction_node\tintroduction_rank\tgrowth_score\t"
              "earliest_date\tlatest_date\tcluster_size\tcluster_span\t"
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

    for region, assignments in region_assignments.items():
        samples = sample_regions[region]
        recorded_mc: dict[str, int] = {}
        recorded_ai: dict[str, float] = {}
        clusters: dict[str, dict[str, str]] = {}
        clustermeta: dict[str, str] = {}
        total_processed = 0

        for s in samples:
            node = T.get_node(s)
            if node is None:
                _err(f"WARNING: query sample {s} not found in tree. "
                     f"continuing")
                continue
            last_encountered = s
            muts_of_last = 0
            last_node = None
            last_anc_state = 1.0
            traversed = len(node.mutations)
            for a in T.rsearch(s, False):
                if a.parent is None:
                    last_encountered = a.identifier
                    muts_of_last = len(a.mutations)
                    anc_state = 0.0
                else:
                    anc_state = assignments[a.identifier]
                if anc_state >= min_origin_confidence:
                    last_encountered = a.identifier
                    muts_of_last = len(a.mutations)
                    last_node = a
                    last_anc_state = anc_state
                    traversed += len(a.mutations)
                    continue
                # look-ahead filter (introduce.cpp:594-625)
                lookahead_skip = False
                if a.parent is not None:
                    cnode = a
                    for _ in range(look_ahead):
                        cnode = cnode.parent
                        if assignments.get(cnode.identifier, -1.0) > anc_state:
                            lookahead_skip = True
                            break
                        if cnode.parent is None:
                            break
                if lookahead_skip:
                    last_encountered = a.identifier
                    muts_of_last = len(a.mutations)
                    last_node = a
                    last_anc_state = anc_state
                    traversed += len(a.mutations)
                    continue

                origins = ""
                origins_cons = ""
                if len(region_assignments) > 1 and a.parent is not None:
                    cand = region_ins.get(a.identifier)
                    if cand is not None:
                        count = (num_to_report if num_to_report > 0
                                 else len(cand))
                        oriscores: list[tuple[float, str]] = []
                        for i, rname in enumerate(cand):
                            if rname == region:
                                continue
                            oriscores.append(
                                (region_cons[a.identifier][i], rname))
                            oriscores.sort()
                            if len(oriscores) > count and oriscores[0][0] < 1:
                                oriscores.pop(0)
                        if len(oriscores) > count and oriscores[0][0] == 1:
                            origins = (f"indeterminate: {len(oriscores)} "
                                       f"potential origins.")
                            origins_cons = "1"
                        else:
                            parts_r, parts_c = [], []
                            for conf, rname in oriscores:
                                parts_r.append(rname)
                                parts_c.append(_fmt(conf))
                            origins = ",".join(parts_r)
                            origins_cons = ",".join(parts_c)
                    else:
                        origins = "indeterminate: no information."
                        origins_cons = "0"
                if not origins:
                    origins = "indeterminate: no regions with support"
                    origins_cons = "0"

                # clades + mutation path from the introduction point to root
                clid_count = len(a.clade_annotations)
                clades_rec: dict[int, str] = {}
                intro_mut_path = ""
                for asn in T.rsearch(a.identifier, True):
                    intro_mut_path += ",".join(
                        m.get_string() for m in asn.mutations) + "<"
                    for i, ann in enumerate(asn.clade_annotations):
                        if ann and i not in clades_rec:
                            clades_rec[i] = ann
                    if len(clades_rec) == clid_count:
                        break
                intro_clades = ""
                for i in range(clid_count):
                    intro_clades += "\t" + clades_rec.get(i, "none")

                mc, ai = 0, 0.0
                if add_info:
                    if a.identifier in recorded_mc:
                        mc = recorded_mc[a.identifier]
                    else:
                        mc = get_monophyletic_cladesize(T, assignments,
                                                        last_node)
                        recorded_mc[a.identifier] = mc
                    if a.identifier in recorded_ai:
                        ai = recorded_ai[a.identifier]
                    else:
                        ai = get_association_index(T, assignments, False,
                                                   last_node)
                        recorded_ai[a.identifier] = ai

                if muts_of_last <= minimum_gap:
                    mgap = len(a.mutations)
                else:
                    mgap = muts_of_last
                    traversed -= muts_of_last

                ostr = (f"\t{_fmt(last_anc_state)}\t{_fmt(anc_state)}\t"
                        f"{traversed}\t{mgap}")
                mcl = f"{_fmt(last_anc_state)}\t{_fmt(anc_state)}\t{mgap}"
                if len(region_assignments) > 1:
                    ostr += f"\t{region}\t{origins}\t{origins_cons}"
                    mcl += f"\t{region}\t{origins}\t{origins_cons}"
                ostr += f"{intro_clades}\t{intro_mut_path}"
                mcl += f"{intro_clades}\t{intro_mut_path}"
                if eval_uncertainty:
                    ostr += f"\t{_fmt(assignments[s])}"
                if add_info:
                    ostr += f"\t{mc}\t{_fmt(ai)}\n"
                    mcl += f"\t{mc}\t{_fmt(ai)}"
                else:
                    ostr += "\n"

                key = (a.identifier if muts_of_last <= minimum_gap
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
                        for a in T.rsearch(s, True):
                            if a.identifier == cid:
                                break
                            if a.identifier not in ancm:
                                span += len(a.mutations)
                                ancm.add(a.identifier)
                            else:
                                break
                else:
                    span = len(T.get_node(cs[0]).mutations)
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
                for nid, conf in assigns.items():
                    if conf > 0:
                        f.write(f"{nid}\t{_fmt(conf)}\n")

    if bycluster:
        with open(bycluster, "w") as f:
            f.write("cluster_id\tsample_count\tearliest_date\tlatest_date\t"
                    "growth_score\tspan\tintro_confidence\t"
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


def record_clade_regions(T: Tree, region_assignments, filename: str) -> None:
    """Per-clade-root IN support per region (introduce.cpp:236-266);
    reference rows/header carry a trailing tab."""
    regions = list(region_assignments)
    with open(filename, "w") as f:
        f.write("clade\t")
        for r in regions:
            f.write(f"{r}\t")
        f.write("\n")
        for n in T.depth_first_expansion():
            for ca in n.clade_annotations:
                if not ca:
                    continue
                f.write(f"{ca}\t")
                for r in regions:
                    f.write(f"{_fmt(region_assignments[r].get(n.identifier, 0.0))}\t")
                f.write("\n")


def introduce_main(input_mat: str, samples_filename: str,
                   additional_info: bool = False, clade_regions: str = "",
                   date_metadata: str = "", full_output: str = "",
                   origin_confidence: float = 0.5,
                   evaluate_metadata: bool = False,
                   dump_assignments: str = "", latest_date: str = "1500/1/1",
                   cluster_output: str = "",
                   earliest_date: str = "1500/1/1", num_to_report: int = 1,
                   minimum_to_report: float = 0.05, num_to_look: int = 0,
                   minimum_gap: int = 0, T: Tree | None = None) -> list[str]:
    """CLI entry (introduce.cpp:944-996)."""
    if T is None:
        from ..io.pbio import load_mat_pb
        T = load_mat_pb(input_mat)
    if T.condensed_nodes:
        T.uncondense_leaves()
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
    outstrings = find_introductions(
        T, region_map, additional_info, clade_regions, origin_confidence,
        cluster_output, dump_assignments, evaluate_metadata, earliest_date,
        latest_date, datemeta, minimum_to_report, num_to_report, num_to_look,
        minimum_gap)
    if full_output:
        with open(full_output, "w") as f:
            for o in outstrings:
                f.write(o)
    return outstrings
