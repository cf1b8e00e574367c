"""The matUtils invocations of the port's tests, shared by
tests/test_torch_matutils.py (the port's CLI against the JAX CLI on the
CPU) and chip_smoke.py (the port's CLI on the card against a CPU run).

Every invocation of tests/test_matutils.py, tests/test_introduce.py,
tests/test_translate.py and the matUtils goldens of tests/test_golden.py
is a case here, with extract -e through both paths and the CLI's own
errors beside them: ``CASES[name](inp, fx)`` writes the case's inputs under
``inp`` and returns ``dict(steps=[(argv, rc)], same=[(a, b)],
rc_pairs=[(i, j)], golden=(subdir, names))``.  An argv may name ``{d}``,
the output directory of the run; ``rc`` is the exit code the JAX CLI
gives (None: the test requires only that paired runs agree); ``same``
lists output files that must be equal within a run (the Tree path and
``--pb-direct``), ``rc_pairs`` steps whose exit codes must be equal, and
``golden`` the files of tests/goldens/<subdir> the run must reproduce.
Inputs are built with the port's host classes only (no JAX), so the card
run can build them too.
"""

import os

import numpy as np

from usher_tpu_torch.cli.usher_cli import main as usher_main
from usher_tpu_torch.core.tree import Mutation, Tree
from usher_tpu_torch.io.newick import parse_newick, parse_newick_string
from usher_tpu_torch.io.pbio import load_mat_pb, save_mat_pb
from usher_tpu_torch.io.vcf import read_vcf_sites
from usher_tpu_torch.matutils.tree_filter import filter_master
from usher_tpu_torch.ops.sankoff import assign_states_from_vcf

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures")
GLOBAL_NH = os.path.join(FIXTURES, "global_phylo.nh")
GLOBAL_VCF = os.path.join(FIXTURES, "global_samples.vcf")
BL2_NWK = os.path.join(FIXTURES, "testBranchLen2.nwk")
BL2_VCF = os.path.join(FIXTURES, "testBranchLen2.vcf")
GOLDENS = os.path.join(HERE, "goldens")
# tests/test_translate.py's reference: ATG GCT TGT TAA -> M A C *
REF_SEQ = "ATGGCTTGTTAA"


class Fixtures:
    """The MATs the cases read, each built once on first use in a new
    directory ``mktemp(name)`` (Sankoff runs on ``device``): ``mat``
    (test_matutils.py's condensed fixture MAT), ``smoke`` (the usher CLI's
    pb of the fixture), ``bl2`` (testBranchLen2's pb)."""

    def __init__(self, mktemp, device):
        self._mktemp = mktemp
        self._device = device
        self._made = {}

    def _get(self, name, build):
        if name not in self._made:
            self._made[name] = build(self._mktemp(name))
        return self._made[name]

    @property
    def mat(self):
        def build(d):
            T = parse_newick(GLOBAL_NH)
            assign_states_from_vcf(T, read_vcf_sites(GLOBAL_VCF),
                                   self._device)
            T.condense_leaves()
            save_mat_pb(T, os.path.join(d, "mat.pb"))
            return os.path.join(d, "mat.pb")
        return self._get("mat", build)

    def _usher(self, name, nwk, vcf):
        def build(d):
            pb = os.path.join(d, "o.pb")
            if usher_main(["-t", nwk, "-v", vcf, "-o", pb, "-d", d]) != 0:
                raise RuntimeError(f"usher CLI failed on {nwk}")
            return pb
        return self._get(name, build)

    @property
    def smoke(self):
        return self._usher("smoke", GLOBAL_NH, GLOBAL_VCF)

    @property
    def bl2(self):
        return self._usher("bl2", BL2_NWK, BL2_VCF)

    @staticmethod
    def leaves(pb):
        """The leaves of a pb, condensed ones expanded."""
        T = load_mat_pb(pb)
        T.uncondense_leaves()
        return T.get_leaves_ids()


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


def _lines(names):
    return "".join(s + "\n" for s in names)


def _first_mutation(pb):
    T = load_mat_pb(pb)
    T.uncondense_leaves()
    for node in T.depth_first_expansion():
        if node.mutations:
            return node.mutations[0].get_string()


def _internal(pb, k=2):
    T = load_mat_pb(pb)
    return [n.identifier for n in T.depth_first_expansion()
            if not n.is_leaf() and len(n.children) > 1][k]


def _split_pbs(inp, fx, n_new=10, n_shared=50, novel=False):
    """test_matutils.py's merge inputs: a base without the last n_new
    leaves and an extension of n_shared shared leaves plus those."""
    T = load_mat_pb(fx.mat)
    T.uncondense_leaves()
    leaves = T.get_leaves_ids()
    T1 = filter_master(T, leaves[:-n_new], False, True)
    T2 = filter_master(T, leaves[:n_shared] + leaves[-n_new:], False, True)
    if novel:
        for k, nm in enumerate(leaves[-n_new:-n_new + 4]):
            n = T2.get_node(nm)
            if n is not None:
                n.add_mutation(Mutation("NC_045512v2", 900000 + k, 1, 1, 4))
    pb1, pb2 = os.path.join(inp, "t1.pb"), os.path.join(inp, "t2.pb")
    save_mat_pb(T1, pb1)
    save_mat_pb(T2, pb2)
    return pb1, pb2


def _save(inp, T, name="in.pb"):
    pb = os.path.join(inp, name)
    save_mat_pb(T, pb)
    return pb


# --- the cases (the module docstring gives their form) -----------------------

W_UT = ["-u", "used.txt", "-t", "t.nh"]


def case_summary_console(inp, fx):
    return dict(steps=[(["summary", "-i", fx.mat], 0)])


def case_summary_tables(inp, fx):
    return dict(steps=[(["summary", "-i", fx.mat, "-d", "{d}",
                         "-s", "samples.tsv", "-m", "mutations.tsv",
                         "-H", "haplotypes.tsv", "-a", "aberrant.tsv"], 0)])


def case_extract_clade_free_outputs(inp, fx):
    sf = _write(os.path.join(inp, "samples.txt"),
                _lines(load_mat_pb(fx.mat).get_leaves_ids()[:20]))
    return dict(steps=[(["extract", "-i", fx.mat, "-s", sf, "-d", "{d}",
                         "-t", "sub.nh", "-v", "sub.vcf", "-o", "sub.pb",
                         "-u", "used.txt", "-S", "paths.tsv",
                         "--write-diff", "sub.diff", "-j", "sub.json"], 0)])


def case_extract_vcf_all(inp, fx):
    return dict(steps=[(["extract", "-i", fx.mat, "-d", "{d}",
                         "-v", "all.vcf"], 0)])


def case_annotate_by_nid_and_sample_clades(inp, fx):
    T = load_mat_pb(fx.mat)
    target = next(n for n in T.depth_first_expansion()
                  if not n.is_leaf() and n.parent is not None
                  and len(T.get_leaves_ids(n.identifier)) > 10)
    c2n = _write(os.path.join(inp, "c2n.tsv"), f"20A\t{target.identifier}\n")
    T.uncondense_leaves()
    members = T.get_leaves_ids(target.identifier)[:30]
    cn = _write(os.path.join(inp, "cnames.tsv"), "".join(f"CLADEX\t{m}\n"
                                            for m in members))
    return dict(steps=[
        (["annotate", "-i", fx.mat, "-o", "{d}/ann.pb", "-C", c2n], 0),
        (["annotate", "-i", fx.mat, "-o", "{d}/ann2.pb", "-c", cn,
          "-f", "0.8", "-s", "0.5"], 0)])


def case_uncertainty(inp, fx):
    sf = _write(os.path.join(inp, "s.txt"), _lines(fx.leaves(fx.mat)[:10]))
    return dict(steps=[(["uncertainty", "-i", fx.mat, "-s", sf,
                         "-e", "{d}/epps.tsv", "-o", "{d}/locs.tsv"], 0)])


def case_merge(inp, fx):
    pb1, pb2 = _split_pbs(inp, fx)
    return dict(steps=[(["merge", "-1", pb1, "-2", pb2,
                         "-o", "{d}/merged.pb"], 0)])


def case_mask_rename_and_simplify(inp, fx):
    rn = _write(os.path.join(inp, "rename.tsv"),
                f"{fx.leaves(fx.mat)[0]}\trenamed_sample_1\n")
    return dict(steps=[
        (["mask", "-i", fx.mat, "-o", "{d}/masked.pb", "-r", rn], 0),
        (["mask", "-i", fx.mat, "-o", "{d}/simple.pb", "-S"], 0)])


def case_fix_grandparent_reversion(inp, fx):
    def mk(pos, par, mut):
        return Mutation(chrom="c", position=pos, ref_nuc=par, par_nuc=par,
                        mut_nuc=mut)
    T = Tree()
    root = T.create_node("root")
    a = T.create_node("A", root)
    a.mutations = [mk(100, 1, 4)]
    b = T.create_node("B", a)
    b.mutations = [mk(200, 1, 2)]
    r = T.create_node("R", b)
    r.mutations = [Mutation(chrom="c", position=100, ref_nuc=1, par_nuc=4,
                            mut_nuc=1)]
    T.create_node("L2", b)
    T.create_node("L3", a)
    pb = _save(inp, T, "fix_in.pb")
    return dict(steps=[(["fix", "-i", pb, "-o", "{d}/fix_out.pb",
                         "-c", "0"], 0)])


def case_extract_error_on_empty_selection(inp, fx):
    sf = _write(os.path.join(inp, "none.txt"), "not_a_real_sample\n")
    return dict(steps=[(["extract", "-i", fx.mat, "-s", sf, "-d", "{d}",
                         "-t", "x.nh"], 1)])


def case_extract_select_nearest_add_random_clades(inp, fx):
    s = _write(os.path.join(inp, "s.txt"), "a\n")
    anchors = _write(os.path.join(inp, "anchor.txt"), "h\n")
    return dict(steps=[(["extract", "-i", fx.bl2, "-s", s, "-Y", "2",
                         "-W", "1", "-X", "4", "--usher-anchor-samples",
                         anchors, "-u", "used.txt", "-d", "{d}/ex"], 0)])


def case_mask_local_snp_distance(inp, fx):
    T = Tree()
    T.create_node("root")
    T.create_node("anc", "root")
    s1 = T.create_node("s1", "anc")
    s2 = T.create_node("s2", "anc")
    far = T.create_node("far", "root")
    s1.add_mutation(Mutation("c", 150, 1, 1, 8))
    s2.add_mutation(Mutation("c", 300, 1, 1, 4))
    for m in range(5):
        far.add_mutation(Mutation("c", 400 + m, 1, 1, 2))
    pb = _save(inp, T)
    diff = _write(os.path.join(inp, "d.diff"), ">s1\n>s2\n-\t100\t100\n")
    return dict(steps=[(["mask", "-i", pb, "-o", "{d}/out.pb", "-D", "3",
                         "-f", diff], 0)])


def case_annotate_clade_mutations(inp, fx):
    cm = _write(os.path.join(inp, "cm.tsv"), "X\tA1T,A2T A3T,A4T,A5T\nY\tX A6T\n")
    return dict(steps=[(["annotate", "-i", fx.bl2, "-o", "{d}/ann.pb",
                         "-M", cm, "-D", "details.tsv", "-d", "{d}"], 0)])


def case_uncertainty_dropout(inp, fx):
    rng = np.random.default_rng(0)
    T = Tree()
    T.create_node("root")
    T.create_node("hot", "root")
    T.create_node("cold", "root")
    for i in range(60):
        n = T.create_node(f"h{i}", "hot")
        if i < 15:
            n.add_mutation(Mutation("c", 100, 1, 1, 8))
        n.add_mutation(Mutation("c", int(rng.integers(200, 1000)), 1, 1, 4))
    for i in range(120):
        n = T.create_node(f"c{i}", "cold")
        n.add_mutation(Mutation("c", int(rng.integers(200, 1000)), 1, 1, 4))
    pb = _save(inp, T)
    return dict(steps=[(["uncertainty", "-i", pb, "-d", "{d}/drop.tsv"],
                        0)])


def case_extract_reroot_reference_rewrite(inp, fx):
    T = Tree()
    T.create_node("root")
    mid = T.create_node("mid", "root")
    mid.add_mutation(Mutation("c", 2, 1, 1, 8))
    T.create_node("l1", "mid").add_mutation(Mutation("c", 4, 1, 1, 4))
    T.create_node("l2", "mid")
    T.create_node("l3", "root")
    pb = _save(inp, T)
    fa = _write(os.path.join(inp, "ref.fa"), ">ref\nAAAAA\n")
    return dict(steps=[(["extract", "-i", pb, "-y", "node_2", "-f", fa,
                         "--write-reroot-reference", "newref.fa",
                         "-t", "t.nh", "-d", "{d}/o"], 0)])


def case_summary_pb_direct(inp, fx):
    w = ["-s", "s.tsv", "-c", "c.tsv", "-m", "m.tsv"]
    return dict(
        steps=[(["summary", "-i", fx.mat, "-d", "{d}/t"] + w, 0),
               (["summary", "-i", fx.mat, "-d", "{d}/a", "--pb-direct"] + w,
                0),
               (["summary", "-i", fx.mat, "-d", "{d}/t"], 0),
               (["summary", "-i", fx.mat, "-d", "{d}/a", "--pb-direct"], 0)],
        same=[("t/s.tsv", "a/s.tsv"), ("t/c.tsv", "a/c.tsv"),
              ("t/m.tsv", "a/m.tsv")])


def case_summary_pb_direct_clades_annotated(inp, fx):
    T = parse_newick_string("((A:1,B:1):1,(C:1,D:1):1):0;")
    T.root.clade_annotations = ["19A", ""]
    T.root.children[0].clade_annotations = ["20A", "B.1"]
    T.root.children[1].clade_annotations = ["20B", ""]
    for n in T.depth_first_expansion():
        if not n.clade_annotations:
            n.clade_annotations = ["", ""]
    pb = _save(inp, T, "ann.pb")
    return dict(
        steps=[(["summary", "-i", pb, "-d", "{d}/t", "-c", "c.tsv"], 0),
               (["summary", "-i", pb, "-d", "{d}/a", "--pb-direct",
                 "-c", "c.tsv"], 0)],
        same=[("t/c.tsv", "a/c.tsv")])


def case_extract_pb_direct_selections(inp, fx):
    sf = _write(os.path.join(inp, "names.txt"), _lines(fx.leaves(fx.mat)[5:17]))
    w = ["-u", "used.txt", "-t", "t.nh", "-v", "v.vcf", "-S", "paths.txt"]
    m = _first_mutation(fx.mat)
    return dict(
        steps=[(["extract", "-i", fx.mat, "-s", sf, "-d", "{d}/t"] + w, 0),
               (["extract", "-i", fx.mat, "-s", sf, "--pb-direct",
                 "-d", "{d}/a"] + w, 0),
               (["extract", "-i", fx.mat, "-m", m, "-d", "{d}/t2"] + W_UT,
                0),
               (["extract", "-i", fx.mat, "-m", m, "--pb-direct",
                 "-d", "{d}/a2"] + W_UT, 0)],
        same=[("t/" + f, "a/" + f) for f in ("used.txt", "t.nh", "v.vcf",
                                             "paths.txt")]
        + [("t2/used.txt", "a2/used.txt"), ("t2/t.nh", "a2/t.nh")])


def case_extract_pb_direct_clade_selection(inp, fx):
    T = parse_newick_string("((A:1,B:1):1,(C:1,D:1):1):0;")
    pos = {"A": (100, 1, 2), "B": (120, 1, 4), "C": (140, 2, 8),
           "D": (160, 4, 1)}
    for leaf, (p, par, mut) in pos.items():
        T.get_node(leaf).add_mutation(Mutation("c", p, par, par, mut))
    for n in T.depth_first_expansion():
        n.clade_annotations = [""]
    T.root.children[0].clade_annotations = ["20A"]
    pb = _save(inp, T, "ann.pb")
    w = ["-u", "used.txt", "-t", "t.nh", "-S", "p.txt"]
    return dict(
        steps=[(["extract", "-i", pb, "-c", "20A", "-d", "{d}/t"] + w, 0),
               (["extract", "-i", pb, "-c", "20A", "--pb-direct",
                 "-d", "{d}/a"] + w, 0)],
        same=[("t/used.txt", "a/used.txt"), ("t/t.nh", "a/t.nh"),
              ("t/p.txt", "a/p.txt")])


def case_extract_pb_direct_all_leaves_verbatim(inp, fx):
    sf = _write(os.path.join(inp, "all.txt"), _lines(fx.leaves(fx.mat)))
    return dict(
        steps=[(["extract", "-i", fx.mat, "-s", sf, "-d", "{d}/t"] + W_UT,
                0),
               (["extract", "-i", fx.mat, "-s", sf, "--pb-direct",
                 "-d", "{d}/a"] + W_UT, 0)],
        same=[("t/used.txt", "a/used.txt"), ("t/t.nh", "a/t.nh")])


def case_extract_pb_direct_large_selection(inp, fx):
    rng = np.random.default_rng(2)
    T = Tree()
    T.create_node("root")
    names = ["root"]
    bases = [1, 2, 4, 8]
    for i in range(24000):
        node = T.create_node(f"L{i}", names[int(rng.integers(len(names)))])
        p = 100 + int(rng.integers(500))
        par = bases[int(rng.integers(4))]
        mut = bases[(bases.index(par) + 1) % 4]
        node.add_mutation(Mutation("c", p, par, par, mut))
        names.append(f"L{i}")
    pb = _save(inp, T, "big.pb")
    sf = _write(os.path.join(inp, "names.txt"), _lines(fx.leaves(pb)[:10500]))
    return dict(
        steps=[(["extract", "-i", pb, "-s", sf, "-d", "{d}/t"] + W_UT, 0),
               (["extract", "-i", pb, "-s", sf, "--pb-direct",
                 "-d", "{d}/a"] + W_UT, 0)],
        same=[("t/used.txt", "a/used.txt"), ("t/t.nh", "a/t.nh")])


def case_mask_rename_pb_direct(inp, fx):
    leaves = load_mat_pb(fx.mat).get_leaves_ids()[:4]
    rn = _write(os.path.join(inp, "rename.tsv"),
                "".join(f"{s}\tRENAMED_{k}\n" for k, s in enumerate(leaves))
                + "NOSUCH\tX\n")
    return dict(
        steps=[(["mask", "-i", fx.mat, "-o", "{d}/t.pb", "-r", rn], 0),
               (["mask", "-i", fx.mat, "-o", "{d}/a.pb", "--pb-direct",
                 "-r", rn], 0)],
        same=[("t.pb", "a.pb")])


def case_mask_rename_pb_direct_collision(inp, fx):
    a, b = load_mat_pb(fx.mat).get_leaves_ids()[:2]
    rn = _write(os.path.join(inp, "r.tsv"), f"{a}\t{b}\n")
    return dict(steps=[
        (["mask", "-i", fx.mat, "-o", "{d}/o.pb", "--pb-direct", "-r", rn],
         1),
        (["mask", "-i", fx.mat, "-o", "{d}/o2.pb", "-r", rn], 1)])


def case_annotate_nid_pb_direct(inp, fx):
    T = load_mat_pb(fx.mat)
    internal = [n.identifier for n in T.depth_first_expansion()
                if not n.is_leaf()][1:4]
    cn = _write(os.path.join(inp, "c.tsv"), f"20A\t{internal[0]}\n20B\t{internal[1]}\n"
                f"DUP\t{internal[0]}\n")
    bad = _write(os.path.join(inp, "bad.tsv"), "X\tNOSUCHNODE\n")
    steps, same = [], []
    for clear in ([], ["-l"]):
        t, a = f"t{len(clear)}.pb", f"a{len(clear)}.pb"
        steps += [(["annotate", "-i", fx.mat, "-o", "{d}/" + t,
                    "-C", cn] + clear, 0),
                  (["annotate", "-i", fx.mat, "-o", "{d}/" + a,
                    "--pb-direct", "-C", cn] + clear, 0)]
        same.append((t, a))
    steps.append((["annotate", "-i", fx.mat, "-o", "{d}/x.pb",
                   "--pb-direct", "-C", bad], 1))
    return dict(steps=steps, same=same)


def case_uncertainty_pb_direct(inp, fx):
    sf = _write(os.path.join(inp, "s.txt"),
                _lines(fx.leaves(fx.mat)[3:40:3] + ["NOSUCHSAMPLE"]))
    return dict(
        steps=[(["uncertainty", "-i", fx.mat, "-s", sf,
                 "-e", "{d}/t_epps.tsv", "-o", "{d}/t_locs.tsv"], 0),
               (["uncertainty", "-i", fx.mat, "-s", sf, "--pb-direct",
                 "-e", "{d}/a_epps.tsv", "-o", "{d}/a_locs.tsv"], 0)],
        same=[("t_epps.tsv", "a_epps.tsv"), ("t_locs.tsv", "a_locs.tsv")])


def _pairs(fx, flag_sets, rc=0):
    """Tree and --pb-direct extract runs of each flag set, with -u/-t: the
    two exit with the same code and, where they write, the same files
    (rc None: the JAX test requires only that)."""
    steps, same, rc_pairs = [], [], []
    for k, flags in enumerate(flag_sets):
        steps += [(["extract", "-i", fx.mat, "-d", f"{{d}}/t{k}"] + flags
                   + W_UT, rc),
                  (["extract", "-i", fx.mat, "-d", f"{{d}}/a{k}",
                    "--pb-direct"] + flags + W_UT, rc)]
        same += [(f"t{k}/used.txt", f"a{k}/used.txt"),
                 (f"t{k}/t.nh", f"a{k}/t.nh")]
        rc_pairs.append((2 * k, 2 * k + 1))
    return dict(steps=steps, same=same, rc_pairs=rc_pairs)


def case_extract_pb_direct_filters(inp, fx):
    return _pairs(fx, (["-a", "1"], ["-b", "2"], ["-P", "3"],
                       ["-e", "1", "-a", "2"]), rc=None)


def case_extract_pb_direct_match_descendents_mrca(inp, fx):
    sf = _write(os.path.join(inp, "n.txt"),
                _lines(load_mat_pb(fx.mat).get_leaves_ids()[4:8]))
    return _pairs(fx, (["-H", "Wuhan"], ["-I", _internal(fx.mat)],
                       ["-s", sf, "-U"]))


def case_extract_pb_direct_density_filter(inp, fx):
    return _pairs(fx, (["-H", "Wuhan", "--max-mutation-density", "1.5"],
                       ["-a", "2", "--max-mutation-density", "2.5", "-U"]),
                  rc=None)


def case_extract_pb_direct_nearest_and_random(inp, fx):
    leaves = fx.leaves(fx.mat)
    sf = _write(os.path.join(inp, "n.txt"), _lines(leaves[4:8]))
    return _pairs(fx, (["-k", f"{leaves[10]}:5"], ["-s", sf, "-z", "12"],
                       ["-s", sf, "-W", "6", "-Z"],
                       ["-k", f"{leaves[10]}:4", "-z", "2"]))


def case_extract_pb_direct_select_nearest(inp, fx):
    sf = _write(os.path.join(inp, "n.txt"), _lines(fx.leaves(fx.mat)[6:9]))
    return _pairs(fx, (["-s", sf, "-Y", "3"],))


def case_extract_pb_direct_zshrink_order(inp, fx):
    sf = _write(os.path.join(inp, "n.txt"), _lines(fx.leaves(fx.mat)[4:8]))
    return _pairs(fx, (["-a", "2", "-z", "3"],
                       ["-I", _internal(fx.mat), "-z", "3"],
                       ["-s", sf, "-U", "-z", "3"],
                       ["-m", _first_mutation(fx.mat), "-z", "3"],
                       ["-z", "5"], ["-W", "4", "-s", sf]))


def case_extract_closest_relatives(inp, fx):
    sf = _write(os.path.join(inp, "sel.txt"), _lines(fx.leaves(fx.mat)[5:11]))
    return dict(steps=[
        (["extract", "-i", fx.mat, "-s", sf, "-d", "{d}", "-V", "rel.tsv",
          "-u", "u.txt"], 0),
        (["extract", "-i", fx.mat, "-s", sf, "-d", "{d}", "-V", "rel1.tsv",
          "-q", "-u", "u1.txt"], 0)])


def case_extract_within_distance(inp, fx):
    sf = _write(os.path.join(inp, "sel.txt"), _lines(fx.leaves(fx.mat)[20:24]))
    return dict(steps=[(["extract", "-i", fx.mat, "-s", sf, "-d", "{d}",
                         "--within-distance", "wd.tsv",
                         "--distance-threshold", "6", "-u", "u.txt"], 0)])


def case_extract_whitelist_metadata_dump(inp, fx):
    leaves = fx.leaves(fx.mat)
    sel, wl = leaves[:3], leaves[10:12]
    sf = _write(os.path.join(inp, "sel.txt"), _lines(sel))
    wf = _write(os.path.join(inp, "wl.txt"), _lines(wl) + "no_such_sample\n")
    meta = _write(os.path.join(inp, "meta.tsv"), "strain\tcountry\tlineage\n"
                  f"{sel[0]}\tUK\tB.1\n{wl[0]}\tUS\tB.2\n"
                  f"{leaves[40]}\tDE\tB.3\n")
    return dict(steps=[(["extract", "-i", fx.mat, "-s", sf, "-L", wf,
                         "-d", "{d}", "-M", meta, "-Q", "dump.tsv",
                         "-u", "used.txt"], 0)])


def case_extract_nearest_k_batch(inp, fx):
    bf = _write(os.path.join(inp, "batch.txt"), _lines(fx.leaves(fx.mat)[30:33]))
    return dict(steps=[(["extract", "-i", fx.mat, "-d", "{d}",
                         "-K", f"{bf}:4", "-s", bf, "-u", "u.txt"], 0)])


def case_extract_max_epps(inp, fx):
    """-e through the Tree path's uncertainty scoring (B1) and the arrays
    path (X6/X5), with a sample list and without one."""
    sf = _write(os.path.join(inp, "sel.txt"), _lines(fx.leaves(fx.mat)[::9]))
    return _pairs(fx, (["-s", sf, "-e", "2"], ["-e", "1"]))


def case_merge_max_depth(inp, fx):
    pb1, pb2 = _split_pbs(inp, fx)
    return dict(steps=[(["merge", "-1", pb1, "-2", pb2,
                         "-o", f"{{d}}/merged_{d}.pb", "-d", str(d)], 0)
                       for d in (1, 3)])


def case_whole_mat_vcf_diff_arrays(inp, fx):
    return dict(
        steps=[(["extract", "-i", fx.mat, "-d", "{d}/t", "-v", "a.vcf",
                 "--write-diff", "a.diff"], 0),
               (["extract", "-i", fx.mat, "--pb-direct", "-d", "{d}/a",
                 "-v", "a.vcf", "--write-diff", "a.diff"], 0),
               (["extract", "-i", fx.mat, "-d", "{d}/t", "-v", "b.vcf",
                 "-n"], 0),
               (["extract", "-i", fx.mat, "--pb-direct", "-d", "{d}/a",
                 "-v", "b.vcf", "-n"], 0)],
        same=[("t/a.vcf", "a/a.vcf"), ("t/a.diff", "a/a.diff"),
              ("t/b.vcf", "a/b.vcf")])


def case_whole_mat_json_arrays(inp, fx):
    T = load_mat_pb(fx.mat)
    for i, n in enumerate(T.depth_first_expansion()):
        n.clade_annotations = [f"C{i % 4}" if i % 7 == 0 else ""]
    pb2 = _save(inp, T, "ann.pb")
    meta = _write(os.path.join(inp, "meta.tsv"), "strain\tcountry\n" + "".join(
        f"{s}\tC{i % 3}\n" for i, s in enumerate(fx.leaves(pb2)[:40])))
    w = ["-j", "a.json", "-M", meta, "-B", "ttl"]
    return dict(
        steps=[(["extract", "-i", pb2, "-d", "{d}/t"] + w, 0),
               (["extract", "-i", pb2, "--pb-direct", "-d", "{d}/a"] + w,
                0)],
        same=[("t/a.json", "a/a.json")])


def case_merge_arrays_parity(inp, fx):
    pb1, pb2 = _split_pbs(inp, fx)
    steps, same = [], []
    for d in (20, 2):
        steps += [(["merge", "-1", pb1, "-2", pb2, "-o", f"{{d}}/mt_{d}.pb",
                    "-d", str(d)], 0),
                  (["merge", "-1", pb1, "-2", pb2, "--pb-direct",
                    "-o", f"{{d}}/ma_{d}.pb", "-d", str(d)], 0)]
        same.append((f"mt_{d}.pb", f"ma_{d}.pb"))
    return dict(steps=steps, same=same)


def case_merge_arrays_parity_novel_positions(inp, fx):
    pb1, pb2 = _split_pbs(inp, fx, n_new=12, n_shared=40, novel=True)
    return dict(
        steps=[(["merge", "-1", pb1, "-2", pb2, "-o", "{d}/mt.pb"], 0),
               (["merge", "-1", pb1, "-2", pb2, "--pb-direct",
                 "-o", "{d}/ma.pb"], 0)],
        same=[("mt.pb", "ma.pb")])


def case_introduce_cli_smoke(inp, fx):
    pop = _write(os.path.join(inp, "pop.txt"), _lines(fx.leaves(fx.smoke)[:25]))

    def w(t):
        return ["-o", f"{{d}}/{t}.tsv", "-u", f"{{d}}/{t}_clusters.tsv",
                "-D", f"{{d}}/{t}_dump", "-a"]
    return dict(
        steps=[(["introduce", "-i", fx.smoke, "-s", pop] + w("t"), 0),
               (["introduce", "-i", fx.smoke, "-s", pop, "--pb-direct"]
                + w("a"), 0),
               (["introduce", "-i", fx.smoke, "-s", pop,
                 "-o", "{d}/plain.tsv"], 0)],
        same=[("t.tsv", "a.tsv"), ("t_clusters.tsv", "a_clusters.tsv"),
              ("t_dump/default_assignments.tsv",
               "a_dump/default_assignments.tsv")])


def case_translate_cli_pb_direct(inp, fx):
    fasta = _write(os.path.join(inp, "ref.fa"), ">ref\n" + REF_SEQ + "\n")
    gtf = _write(os.path.join(inp, "genes.gtf"),
                 'ref\ttest\tCDS\t1\t12\t.\t+\t.\tgene_id "GENE1";\n')
    pb = _save(inp, bigger_tree(), "t.pb")
    return dict(
        steps=[(["summary", "-i", pb, "-d", "{d}/a", "-t", "aa.tsv",
                 "-g", gtf, "-f", fasta], 0),
               (["summary", "-i", pb, "-d", "{d}/b", "-t", "aa.tsv",
                 "-g", gtf, "-f", fasta, "--pb-direct"], 0),
               (["extract", "-i", pb, "-d", "{d}/a", "-l", "tax.pb",
                 "-g", gtf, "-f", fasta, "-B", "ttl"], 0),
               (["extract", "-i", pb, "-d", "{d}/b", "-l", "tax.pb",
                 "-g", gtf, "-f", fasta, "-B", "ttl", "--pb-direct"], 0)],
        same=[("a/aa.tsv", "b/aa.tsv"), ("a/tax.pb", "b/tax.pb")])


def case_golden_summary(inp, fx):
    return dict(steps=[(["summary", "-i", fx.smoke, "-A", "-d", "{d}"], 0)],
                golden=("summary", ("samples.tsv", "mutations.tsv",
                                    "clades.tsv")))


def case_golden_extract(inp, fx):
    return dict(steps=[(["extract", "-i", fx.smoke, "-v", "smoke.vcf",
                         "--write-diff", "smoke.diff", "-t", "smoke.nh",
                         "-d", "{d}"], 0)],
                golden=("extract", ("smoke.vcf", "smoke.diff", "smoke.nh")))


def case_help_version_and_errors(inp, fx):
    return dict(steps=[(["bogus"], 1), ([], 1), (["-h"], 0),
                       (["extract", "-i", os.path.join(inp, "missing.pb"),
                         "-d", "{d}"], 1)])


CASES = {name[len("case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


def bigger_tree():
    """tests/test_translate.py's _bigger_tree in the port's classes: a
    condensed, polytomy-rich random tree over REF_SEQ."""
    rng = np.random.default_rng(3)
    nts = [1, 2, 4, 8]
    code = {"A": 1, "C": 2, "G": 4, "T": 8}
    T = Tree()
    root = T.create_node("node_root")
    nodes = [root]
    state = {id(root): {}}
    for i in range(60):
        parent = nodes[int(rng.integers(len(nodes)))]
        n = T.create_node(f"s{i}", parent)
        st = dict(state[id(parent)])
        for _ in range(int(rng.integers(0, 3))):
            p = int(rng.integers(0, len(REF_SEQ)))
            ref_nt = code[REF_SEQ[p]]
            par = st.get(p, ref_nt)
            alts = [x for x in nts if x != par]
            mut = alts[int(rng.integers(3))]
            n.add_mutation(Mutation("ref", p, ref_nt, par, mut))
            st[p] = mut
        state[id(n)] = st
        nodes.append(n)
    T.condense_leaves()
    return T


def run_steps(main, d, steps, stdout):
    """Run a case's steps with ``main`` into directory ``d`` (created):
    returns ([(exit code, stdout with d written {d})], {relative path:
    bytes} of every file under d).  ``stdout()`` returns (and clears) what
    the last step printed."""
    os.makedirs(d)
    got = []
    for argv, _rc in steps:
        rc = main([a.format(d=d) for a in argv])
        got.append((rc, stdout().replace(str(d), "{d}")))
    return got, dir_files(d)


def check_run(spec, got, files):
    """What a case requires of one run of its steps (``run_steps``' two
    results): the exit codes the case gives, equal exit codes for its
    rc_pairs, equal files for its same pairs where either was written,
    and its goldens; raises AssertionError."""
    for (rc, _), (argv, want) in zip(got, spec["steps"]):
        if want is not None and rc != want:
            raise AssertionError(f"{argv}: exit code {rc}, expected {want}")
    for i, j in spec.get("rc_pairs", ()):
        if got[i][0] != got[j][0]:
            raise AssertionError(f"exit codes differ: {spec['steps'][i][0]}"
                                 f" / {spec['steps'][j][0]}")
    for a, b in spec.get("same", ()):
        if (a in files or b in files) and files.get(a) != files.get(b):
            raise AssertionError(f"{a} differs from {b}")
    if "golden" in spec:
        sub, names = spec["golden"]
        for name in names:
            with open(os.path.join(GOLDENS, sub, name), "rb") as f:
                if files.get(name) != f.read():
                    raise AssertionError(f"{name} differs from the golden")


def dir_files(d):
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return dict(sorted(out.items()))
