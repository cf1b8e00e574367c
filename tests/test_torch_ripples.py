"""RIPPLES on the port (usher_tpu_torch/ripples, cli/ripples*_cli.py)
against the JAX package, on the CPU (USHER_TPU_PLATFORM=cpu).

Every case of ``test_ripples_cli_matches_jax`` and
``test_ripples_tools_match_jax`` runs the JAX CLI and the port's CLI on the
same pb and arguments, each in a directory of its own with relative output
paths, and requires equal exit codes, stdout, stderr and every file byte
for byte.  The cases are tests/test_ripples.py's and
tests/test_ripples_filter.py's invocations, the fixture MAT at the
defaults, at ``-n 1 -l 2``, in ``-S/-E`` halves and with ``-s``, random
MATs from a numpy seed with planted recombinants, a tree where tied
parsimonies leave the names to decide the donor and acceptor (with more
than the 1,000 candidates a breakpoint pair tries), and ``-l 0``.  The
filter's statistics are held against the JAX functions and the brute force
of tests/test_ripples_filter.py, X13's device form against its plain
version and the JAX ``_cost_matrix`` (tolerance 0: integer counts), and the
pair loop's exact restructurings against the loop they replace.  The MATs
are built once a module.
"""

import contextlib
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from usher_tpu.cli.ripples_cli import main as jax_ripples
from usher_tpu.cli.ripples_filter_cli import main as jax_filter
from usher_tpu.cli.ripples_init_cli import main as jax_init
from usher_tpu.cli.ripples_utils_cli import main as jax_utils
from usher_tpu.core.tree import Mutation, Tree
from usher_tpu.io.pbio import save_mat_pb
from usher_tpu.ripples import filter as jfilter
from usher_tpu.ripples.detect import _cost_matrix as jax_cost_matrix
from usher_tpu_torch.cli.ripples_cli import main as torch_ripples
from usher_tpu_torch.cli.ripples_filter_cli import main as torch_filter
from usher_tpu_torch.cli.ripples_init_cli import main as torch_init
from usher_tpu_torch.cli.ripples_utils_cli import main as torch_utils
from usher_tpu_torch.core.flat import FlatMAT, collect_positions
from usher_tpu_torch.ops.placement import parent_states
from usher_tpu_torch.ripples import detect as tdetect
from usher_tpu_torch.ripples import filter as tfilter

from conftest import REFERENCE_TEST_DIR, REFERENCE_SCRIPTS_DIR
from test_ripples import build_recombinant_tree, mk
from test_ripples_filter import _brute_pvalue
from test_torch_hostlayers import port_tree

GLOBAL_NH = os.path.join(REFERENCE_TEST_DIR, "global_phylo.nh")
GLOBAL_VCF = os.path.join(REFERENCE_TEST_DIR, "global_samples.vcf")
NIBBLES = np.array([1, 2, 4, 8], dtype=np.uint8)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("USHER_TPU_PLATFORM", "cpu")


# --- the MATs -----------------------------------------------------------------

def clean_tree():
    """tests/test_ripples.py's tree without a recombinant signal."""
    T = Tree()
    root = T.create_node("root")
    b1 = T.create_node("b1", root)
    b1.mutations = [mk(1000, 4), mk(2000, 4), mk(3000, 4)]
    T.create_node("L1", b1).mutations = [mk(30000, 2)]
    T.create_node("L2", b1).mutations = [mk(30001, 2)]
    b2 = T.create_node("b2", root)
    b2.mutations = [mk(15000, 2), mk(16000, 2), mk(17000, 2)]
    T.create_node("L3", b2).mutations = [mk(30002, 2)]
    T.create_node("L4", b2).mutations = [mk(30003, 2)]
    return T


def path_genotype(node):
    """position -> allele of a node's root path where it differs from the
    reference (the nearest mutation a position wins)."""
    out, seen = {}, set()
    cur = node
    while cur is not None:
        for m in cur.mutations:
            if m.position not in seen:
                seen.add(m.position)
                if m.mut_nuc != m.ref_nuc:
                    out[m.position] = (m.ref_nuc, m.mut_nuc)
        cur = cur.parent
    return out


def planted_tree(seed, n_nodes=240, n_sites=300, n_planted=2, min_leaves=4):
    """A random recursive tree (1-3 path-consistent mutations a branch over
    n_sites positions of a 30,000-base genome) with n_planted recombinant
    leaves under the root: each takes a donor clade's path genotype below
    position 15,000 and a disjoint acceptor clade's at or above it."""
    rng = np.random.default_rng(seed)
    sites = np.sort(rng.choice(np.arange(1, 30_001), n_sites, replace=False))
    ref = NIBBLES[rng.integers(0, 4, n_sites)]
    parent = np.zeros(n_nodes, dtype=np.int64)
    parent[1:] = (rng.random(n_nodes - 1) * np.arange(1, n_nodes)).astype(
        np.int64)
    is_leaf = np.ones(n_nodes, bool)
    is_leaf[parent[1:]] = False
    T = Tree()
    state = np.tile(ref, (n_nodes, 1))
    nodes = [T.create_node("node_1")]
    for i in range(1, n_nodes):
        name = f"s{i}" if is_leaf[i] else f"node_{i + 1}"
        nodes.append(T.create_node(name, nodes[parent[i]]))
        state[i] = state[parent[i]]
        for c in sorted(rng.choice(n_sites, rng.integers(1, 4),
                                   replace=False).tolist()):
            par = int(state[i, c])
            mut = int(NIBBLES[(np.log2(par).astype(int)
                               + rng.integers(1, 4)) % 4])
            nodes[i].add_mutation(Mutation("c", int(sites[c]), int(ref[c]),
                                           par, mut))
            state[i, c] = mut
    clades = [n for n in T.depth_first_expansion()[1:]
              if min_leaves <= T.get_num_leaves(n) <= 40]
    planted = []
    for k in range(n_planted):
        d = clades[int(rng.integers(len(clades)))]
        inside = {x.identifier for x in T.depth_first_expansion(d)}
        ok = [a for a in clades if a.identifier not in inside
              and d.identifier not in {x.identifier for x in
                                       T.depth_first_expansion(a)}]
        a = ok[int(rng.integers(len(ok)))]
        gd, ga = path_genotype(d), path_genotype(a)
        r = T.create_node(f"recomb_{k}", T.root)
        for p in sorted(set(gd) | set(ga)):
            src = gd if p < 15_000 else ga
            if p in src:
                rn, mn = src[p]
                r.add_mutation(Mutation("c", p, rn, rn, mn))
        planted.append(r.identifier)
    return T, planted


def tied_tree(n_copies=700):
    """tests/test_ripples.py's recombinant with its donor and acceptor
    clades replaced by n_copies leaves each, all of one clade carrying the
    same mutations, named so that neither creation order nor BFS order is
    name order: every breakpoint pair sees more than 1,000 candidates, and
    names alone pick the donor and the acceptor."""
    rng = np.random.default_rng(3)
    T = Tree()
    root = T.create_node("root")
    names = [f"c{v:05d}" for v in rng.permutation(2 * n_copies)]
    for k in range(n_copies):
        T.create_node(names[2 * k], root).mutations = [
            mk(1100, 4), mk(2200, 4), mk(3300, 4)]
        T.create_node(names[2 * k + 1], root).mutations = [
            mk(15100, 2), mk(15200, 2), mk(15300, 2)]
    T.create_node("R", root).mutations = [
        mk(1100, 4), mk(2200, 4), mk(3300, 4),
        mk(15100, 2), mk(15200, 2), mk(15300, 2)]
    return T


@pytest.fixture(scope="module")
def mats(tmp_path_factory):
    """name -> (pb path, planted or sampled leaf names)."""
    from usher_tpu.cli.usher_cli import main as usher_main
    d = tmp_path_factory.mktemp("ripples_mats")
    out = {}

    def save(name, T, leaves=()):
        pb = str(d / f"{name}.pb")
        save_mat_pb(T, pb)
        out[name] = (pb, list(leaves))
    save("recomb", build_recombinant_tree(), ["R"])
    save("clean", clean_tree())
    save("tied", tied_tree(), ["R"])
    for seed in (0, 1, 2):
        save(f"planted{seed}", *planted_tree(seed))
    fx = str(d / "fixture")
    assert usher_main(["-t", GLOBAL_NH, "-v", GLOBAL_VCF, "-o",
                       os.path.join(fx, "out.pb"), "-d", fx,
                       "--mesh-devices", "0"]) == 0
    from usher_tpu.io.pbio import load_mat_pb
    fxT = load_mat_pb(os.path.join(fx, "out.pb"))
    fxT.uncondense_leaves()
    fx_leaves = fxT.get_leaves_ids()
    out["fixture"] = (os.path.join(fx, "out.pb"),
                      [fx_leaves[i] for i in (0, 97, 301)])
    bl = str(d / "branchlen2")
    assert usher_main(["-t", os.path.join(REFERENCE_SCRIPTS_DIR,
                                          "testBranchLen2.nwk"),
                       "-v", os.path.join(REFERENCE_SCRIPTS_DIR,
                                          "testBranchLen2.vcf"),
                       "-o", os.path.join(bl, "o.pb"), "-d", bl,
                       "--mesh-devices", "0"]) == 0
    out["branchlen2"] = (os.path.join(bl, "o.pb"), [])
    return out


# --- running both sides ---------------------------------------------------------

def run_side(main, workdir, argv, monkeypatch):
    """main(argv) with cwd = workdir; (rc, stdout, stderr, {path: bytes} of
    every file under workdir)."""
    os.makedirs(workdir, exist_ok=True)
    out, err = io.StringIO(), io.StringIO()
    monkeypatch.chdir(workdir)
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    files = {}
    for root, _, names in os.walk(workdir):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                files[os.path.relpath(p, workdir)] = f.read()
    return rc, out.getvalue(), err.getvalue(), files


def same_run(jmain, tmain, tmp_path, argv, monkeypatch, inputs=None):
    """Both CLIs on argv; ``inputs`` {relative name: text} are written into
    each side's directory first.  Returns the port's run."""
    runs = []
    for side, main in (("jax", jmain), ("torch", tmain)):
        wd = str(tmp_path / side)
        os.makedirs(wd, exist_ok=True)
        for name, text in (inputs or {}).items():
            path = os.path.join(wd, name)
            os.makedirs(os.path.dirname(path) or wd, exist_ok=True)
            with open(path, "w") as f:
                f.write(text)
        runs.append(run_side(main, wd, argv, monkeypatch))
    want, got = runs
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert sorted(got[3]) == sorted(want[3])
    for name in want[3]:
        assert got[3][name] == want[3][name], name
    return got


def body(files, name="out/recombination.tsv"):
    return [l for l in files[name].decode().splitlines()[1:] if l]


RIPPLES_CASES = {
    # tests/test_ripples.py
    "recomb": ("recomb", ["-n", "1", "-l", "3", "-p", "3"]),
    "clean": ("clean", ["-n", "1", "-l", "3", "-p", "3"]),
    # the fixture MAT
    "fixture_defaults": ("fixture", []),
    "fixture_n1_l2": ("fixture", ["-n", "1", "-l", "2"]),
    "fixture_l1_p1": ("fixture", ["-n", "1", "-l", "1", "-p", "1"]),
    "fixture_S0_E30": ("fixture", ["-n", "1", "-l", "1", "-p", "1",
                                   "-S", "0", "-E", "30"]),
    "fixture_S30_E60": ("fixture", ["-n", "1", "-l", "1", "-p", "1",
                                    "-S", "30", "-E", "60"]),
    "fixture_samples": ("fixture", ["-n", "2", "-l", "1", "-s", "s.txt"]),
    # random MATs with planted recombinants
    "planted0": ("planted0", ["-n", "1", "-l", "2"]),
    "planted1_samples": ("planted1", ["-n", "3", "-s", "s.txt"]),
    "planted2_ranges": ("planted2", ["-n", "2", "-l", "2", "-r", "100",
                                     "-R", "20000", "-p", "2"]),
    # names decide among tied parsimonies, > 1,000 candidates a pair
    "tied_samples": ("tied", ["-n", "1", "-s", "s.txt"]),
    # -l 0 and a negative -r: pairs with no donor mutation (i == j, and
    # j == 0, which reads prefix column 0) reach the interval arithmetic
    "recomb_l0": ("recomb", ["-n", "1", "-l", "0", "-p", "1",
                             "-r", "-100000"]),
    "missing_sample": ("recomb", ["-n", "1", "-s", "s.txt"]),
}


@pytest.mark.parametrize("case", sorted(RIPPLES_CASES))
def test_ripples_cli_matches_jax(case, mats, tmp_path, monkeypatch):
    name, args = RIPPLES_CASES[case]
    pb, leaves = mats[name]
    if case == "missing_sample":
        leaves = ["R", "no_such_leaf"]
    inputs = {"s.txt": "".join(l + "\n" for l in leaves)}
    rc, _out, err, files = same_run(jax_ripples, torch_ripples, tmp_path,
                                    ["-i", pb, "-d", "out", *args],
                                    monkeypatch, inputs)
    if case == "missing_sample":
        assert rc == 1 and "no_such_leaf not found" in err
        return
    assert rc == 0
    rows = body(files)
    if name in ("recomb", "tied") or name.startswith("planted"):
        # every planted recombinant is reported, with the improvement
        found = {r.split("\t")[0] for r in rows}
        want = set(leaves) if case != "recomb_l0" else {"R"}
        if case != "planted2_ranges":
            assert want <= found, (want, found)
        for r in rows:
            f = r.split("\t")
            assert int(f[11]) + int(args[args.index("-p") + 1]
                                    if "-p" in args else 3) <= int(f[9])
    if case == "clean":
        assert rows == []
    if case == "tied_samples":
        # the smallest names of the two tied clades win
        donors = {r.split("\t")[3] for r in rows}
        assert len(donors) >= 1


def test_ripples_halves_concatenate(mats, tmp_path, monkeypatch):
    """-S 0 -E 30 then -S 30 -E 60 give, row for row, what -S 0 -E 60
    gives (the candidate order is fixed by the seeded shuffle)."""
    pb, _ = mats["fixture"]
    outs = {}
    for s, e in ((0, 30), (30, 60), (0, 60)):
        _rc, _o, _e, files = run_side(
            torch_ripples, str(tmp_path / f"{s}_{e}"),
            ["-i", pb, "-d", "out", "-n", "1", "-l", "1", "-p", "1",
             "-S", str(s), "-E", str(e)], monkeypatch)
        outs[s, e] = files
    for name in ("out/recombination.tsv", "out/descendants.tsv"):
        assert body(outs[0, 30], name) + body(outs[30, 60], name) == \
            body(outs[0, 60], name)
    assert body(outs[0, 30]) and body(outs[30, 60])


TOOL_CASES = {
    # tests/test_ripples.py::test_ripples_init_cli
    "init_recomb": ("init", "recomb", ["-l", "3", "-n", "2"]),
    "init_fixture": ("init", "fixture", []),
    # tests/test_ripples.py::test_ripples_utils_cli
    "utils_recomb": ("utils", "recomb", None),
    # tests/test_ripples_filter.py::test_filter_end_to_end, and the filter
    # over planted and fixture runs
    "filter_branchlen2": ("filter", "branchlen2", ["-l", "3", "-n", "2"]),
    "filter_planted0": ("filter", "planted0", ["-n", "1", "-l", "2"]),
    "filter_fixture": ("filter", "fixture", ["-n", "1", "-l", "1",
                                             "-p", "1", "-S", "0",
                                             "-E", "60"]),
}


@pytest.mark.parametrize("case", sorted(TOOL_CASES))
def test_ripples_tools_match_jax(case, mats, tmp_path, monkeypatch):
    tool, name, args = TOOL_CASES[case]
    pb, _ = mats[name]
    if tool == "init":
        rc, out, _e, files = same_run(jax_init, torch_init, tmp_path,
                                      ["-i", pb, *args], monkeypatch)
        assert rc == 0 and int(out.strip()) >= 1
        lines = files["ripples_to_chron_ids.txt"].decode().split("\n")
        assert lines[0] == "MAT_node_id\tchronumental_node_id"
        return
    if tool == "utils":
        T = build_recombinant_tree()
        leaves = T.get_leaves_ids()
        internal = [n.identifier for n in T.depth_first_expansion()
                    if not n.is_leaf() and n.parent is not None]
        pvals = ("#recomb\ta\tb\tdonor\tdsib\tc\tacceptor\tasib\n"
                 f"{leaves[0]}\tx\tx\t{leaves[1]}\ty\tx\t{internal[0]}\tn\n"
                 f"{leaves[2]}\tx\tx\t{internal[0]}\ty\tx\t{leaves[3]}\ty\n"
                 "short\trow\n")
        rc, _o, _e, files = same_run(
            jax_utils, torch_utils, tmp_path,
            [pb, "--pvals", "pvals.txt", "--data-dir", "data"],
            monkeypatch, {"pvals.txt": pvals})
        assert rc == 0
        names = set(files["data/allRelevantNodeNames.txt"].decode().split())
        assert {leaves[0], leaves[1], internal[0]} <= names
        return
    # the filter reads the JAX run's recombination.tsv on both sides
    _rc, _o, _e, rip = run_side(jax_ripples, str(tmp_path / "rip"),
                                ["-i", pb, "-d", "out", *args], monkeypatch)
    tsv = rip["out/recombination.tsv"].decode()
    rc, _o, _e, files = same_run(
        jax_filter, torch_filter, tmp_path,
        ["-i", pb, "-r", "recombination.tsv", "-o", "filtered.tsv"],
        monkeypatch, {"recombination.tsv": tsv})
    assert rc == 0
    assert files["filtered.tsv"].decode().startswith("#recomb_node_id\t")


def test_ripples_utils_rejects_other_inputs(tmp_path, monkeypatch):
    rc = same_run(jax_utils, torch_utils, tmp_path, ["tree.json"],
                  monkeypatch)[0]
    assert rc == 1


# --- the filter's statistics (tests/test_ripples_filter.py) -------------------

@pytest.mark.parametrize("m,n,k", [
    (1, 2, 1), (1, 2, 2), (2, 2, 1), (2, 2, 2), (3, 3, 2), (3, 3, 3),
    (4, 2, 2), (2, 4, 3), (5, 5, 3), (0, 3, 2), (3, 0, 1),
])
def test_mnk_pvalue_matches_jax_and_bruteforce(m, n, k):
    got = tfilter.mnk_pvalue(m, n, k)
    assert got == jfilter.mnk_pvalue(m, n, k)
    assert got == pytest.approx(_brute_pvalue(m, n, k))


@pytest.mark.parametrize("what", ["max_descent", "pattern_mnk",
                                  "mnk_pvalue_small", "trio_pattern"])
def test_filter_helpers_match_jax(what):
    if what == "max_descent":
        for p in ("AAAA", "AB", "AABB", "ABAB", "BBAA", "AABBBAAA", ""):
            assert tfilter.max_descent(p) == jfilter.max_descent(p)
        assert tfilter.max_descent("AABBBAAA") == 3
    elif what == "pattern_mnk":
        for p in ("AABB", "BBAA", "", "ABBBA", "BAB"):
            assert tfilter.pattern_mnk(p) == jfilter.pattern_mnk(p)
        assert tfilter.pattern_mnk("AABB") == (2, 2, 2)
    elif what == "mnk_pvalue_small":
        for mnk in ((3, 2, 0), (5, 2, 3), (1, 1, 1), (2, 1, 1), (40, 30, 9)):
            assert tfilter.mnk_pvalue(*mnk) == jfilter.mnk_pvalue(*mnk)
        assert tfilter.mnk_pvalue(3, 2, 0) == 1.0
        assert tfilter.mnk_pvalue(5, 2, 3) == 0.0
    else:
        T = Tree()
        T.create_node("root")
        d = T.create_node("donor", "root")
        a = T.create_node("acceptor", "root")
        r = T.create_node("recomb", "root")
        d.add_mutation(Mutation("c", 10, 1, 1, 8))
        d.add_mutation(Mutation("c", 20, 1, 1, 8))
        a.add_mutation(Mutation("c", 10, 1, 1, 4))
        a.add_mutation(Mutation("c", 30, 1, 1, 2))
        r.add_mutation(Mutation("c", 10, 1, 1, 8))
        r.add_mutation(Mutation("c", 20, 1, 1, 8))
        r.add_mutation(Mutation("c", 30, 1, 1, 2))
        P = port_tree(T)
        assert tfilter.trio_pattern(P, "recomb", "donor", "acceptor") == \
            jfilter.trio_pattern(T, "recomb", "donor", "acceptor") == "AAB"


# --- X13 -----------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_cost_matrix_forms_agree(seed, monkeypatch):
    """X13's device form (row blocks, prefix sums gathered at the sample's
    columns), its plain version and the JAX _cost_matrix give the same
    counts on a planted MAT's FlatMAT: every slot row (padding rows, whose
    st is 0 and stp the root's, and the root row included), the gathered
    columns and column 0, and totals over the padding columns too, which
    contribute nothing."""
    T, planted = planted_tree(seed, n_nodes=160, n_sites=200)
    P_tree = port_tree(T)
    positions, ref, chrom = collect_positions(P_tree)
    flat = FlatMAT(P_tree, positions, ref, chrom, device="cpu")
    assert flat.cap > flat.n_slots and flat.P_pad > flat.P
    st, parent = flat.sync()
    stp = parent_states(st, parent, flat.root_slot)
    assert bool((st[flat.n_slots:] == 0).all())
    assert bool((stp[flat.n_slots:] == st[0]).all())
    rng = np.random.default_rng(seed)
    nodes = P_tree.breadth_first_expansion()
    picks = [P_tree.get_node(planted[0]), P_tree.root] + [
        nodes[int(i)] for i in rng.integers(1, len(nodes), 3)]
    # rows small enough for several blocks
    monkeypatch.setattr(tdetect, "BLOCK_ELEMS", 7 * flat.P_pad)
    for node in picks:
        muts = tdetect.pruned_sample_mutations(node)
        if muts and seed % 2:
            muts[0].is_missing = True
        g, E, miss = flat.encode_samples([muts])
        cols = tdetect.gather_columns(
            [flat.pos_index[m.position] for m in muts])
        csum, total, hu = tdetect._cost_matrix(
            st, stp, flat.ref_dev, torch.from_numpy(g[0]),
            torch.from_numpy(E[0]), torch.from_numpy(miss[0]),
            torch.from_numpy(cols))
        pcsum, ptotal, phu = tdetect._cost_matrix_plain(
            st, stp, flat.ref_dev, None, torch.from_numpy(g),
            torch.from_numpy(E), torch.from_numpy(miss))
        jcsum, jtotal, jhu = (np.asarray(x) for x in jax_cost_matrix(
            jnp.asarray(st.numpy()), jnp.asarray(stp.numpy()),
            jnp.asarray(flat.ref), None, jnp.asarray(g), jnp.asarray(E),
            jnp.asarray(miss)))
        assert csum.dtype == pcsum.dtype == torch.int32
        assert total.dtype == torch.int32 and hu.dtype == torch.bool
        np.testing.assert_array_equal(csum.numpy(), pcsum.numpy()[:, cols])
        np.testing.assert_array_equal(csum.numpy(), jcsum[:, cols])
        np.testing.assert_array_equal(total.numpy(), ptotal.numpy())
        np.testing.assert_array_equal(total.numpy(), jtotal)
        np.testing.assert_array_equal(hu.numpy(), phu.numpy())
        np.testing.assert_array_equal(hu.numpy(), jhu)
        # the padding columns add nothing to the totals
        np.testing.assert_array_equal(pcsum.numpy()[:, flat.P - 1],
                                      ptotal.numpy())


# --- the pair loop's exact restructurings ----------------------------------------

def _jax_first(values, names, slots, limit=tdetect.MAX_TRIED):
    return [k for _p, _n, k in sorted(
        (int(values[i]), names[k], k) for i, k in enumerate(slots))][:limit]


@pytest.mark.parametrize("n,levels,limit", [(50, 3, 1000), (2500, 4, 1000),
                                            (400, 2, 7)])
def test_pair_selection_matches_sorted_tuples(n, levels, limit):
    """first_by_parsimony picks the JAX module's sorted (parsimony, name)
    prefix under heavy ties, and first_pair the first qualifying pair of
    its double loop."""
    rng = np.random.default_rng(n)
    slots = rng.permutation(n * 2)[:n]
    names = {int(k): f"n{int(v)}" for k, v in
             zip(slots, rng.permutation(10 * n)[:n])}
    allnames = sorted(names.values())
    rank = np.array([allnames.index(names[int(k)]) for k in slots])
    for _ in range(3):
        p = rng.integers(0, levels, n)
        q = rng.integers(0, levels, n)
        pick = tdetect.first_by_parsimony(p, rank, len(allnames), limit)
        assert [int(slots[i]) for i in pick] == \
            _jax_first(p, names, slots, limit)
        qpick = tdetect.first_by_parsimony(q, rank, len(allnames), limit)
        for bound in range(0, 2 * levels):
            want = None
            for i in pick:
                for j in qpick:
                    if (names[int(slots[i])] != names[int(slots[j])]
                            and int(p[i]) + int(q[j]) <= bound):
                        want = (int(slots[i]), int(slots[j]))
                        break
                if want:
                    break
            hit = tdetect.first_pair(slots[pick], slots[qpick], p[pick],
                                     q[qpick], names, bound)
            got = None if hit is None else (int(slots[pick][hit[0]]),
                                            int(slots[qpick][hit[1]]))
            assert got == want
