"""The port's own host layers against the JAX package's originals.

usher_tpu_torch keeps a copy of every host module it needs (tree, newick,
pb, VCF, host oracle, instrumentation, subtree writers) and imports nothing
of usher_tpu.  Each copy is held against its original here: the same bytes
(newick, pb, VCF) or the same seeded trees and samples go through both, and
what comes out must be equal (files byte for byte).

``port_tree`` and ``port_samples`` rebuild a usher_tpu tree or sample list
from the port's classes; the other port tests use them so that each side
of a parity test works on objects of its own package.
"""

import os

import numpy as np
import pytest

from usher_tpu.core import nuc as jnuc
from usher_tpu.core import tree as jtree
from usher_tpu.io import newick as jnewick
from usher_tpu.io import pbio as jpbio
from usher_tpu.io import proto_wire as jpw
from usher_tpu.io import vcf as jvcf
from usher_tpu.placement import mapper as jmapper
from usher_tpu.tools import subtrees as jsubtrees
from usher_tpu.utils import instrument as jinstrument
from usher_tpu_torch.core import nuc as tnuc
from usher_tpu_torch.core import tree as ttree
from usher_tpu_torch.io import newick as tnewick
from usher_tpu_torch.io import pbio as tpbio
from usher_tpu_torch.io import proto_wire as tpw
from usher_tpu_torch.io import vcf as tvcf
from usher_tpu_torch.placement import mapper as tmapper
from usher_tpu_torch.tools import subtrees as tsubtrees
from usher_tpu_torch.utils import instrument as tinstrument

from conftest import REFERENCE_TEST_DIR
from test_placement import random_mat, random_sample

GLOBAL_NH = os.path.join(REFERENCE_TEST_DIR, "global_phylo.nh")
GLOBAL_VCF = os.path.join(REFERENCE_TEST_DIR, "global_samples.vcf")
NEW_VCF = os.path.join(REFERENCE_TEST_DIR, "new_samples.vcf")


# --- helpers shared with the other port tests --------------------------------

def port_mutation(m):
    return ttree.Mutation(m.chrom, m.position, m.ref_nuc, m.par_nuc,
                          m.mut_nuc, m.is_missing)


def port_samples(samples):
    """Lists of usher_tpu Mutations as lists of the port's Mutations."""
    return [[port_mutation(m) for m in muts] for muts in samples]


def port_tree(T):
    """A usher_tpu Tree rebuilt from the port's Tree, Node and Mutation, in
    the same child order and with the same internal-node counter."""
    t = ttree.Tree()
    t.curr_internal_node = T.curr_internal_node
    t.condensed_nodes = {k: list(v) for k, v in T.condensed_nodes.items()}
    t.condensed_leaves = set(T.condensed_leaves)
    if T.root is None:
        return t
    stack = [(T.root, None)]
    while stack:
        cur, new_parent = stack.pop()
        node = ttree.Node(cur.identifier, new_parent, cur.branch_length)
        node.mutations = [port_mutation(m) for m in cur.mutations]
        node.clade_annotations = list(cur.clade_annotations)
        t._all_nodes[node.identifier] = node
        if new_parent is None:
            t.root = node
        else:
            new_parent.children.append(node)
        # children are appended in pop order: push them reversed
        for c in reversed(cur.children):
            stack.append((c, node))
    return t


def tree_signature(T):
    """Everything a tree holds that an output can show, in DFS order."""
    return [(n.identifier, n.parent.identifier if n.parent else None,
             n.level, n.branch_length, list(n.clade_annotations),
             [(m.chrom, m.position, m.ref_nuc, m.par_nuc, m.mut_nuc,
               m.is_missing) for m in n.mutations])
            for n in T.depth_first_expansion()]


def _nwk(mod, T, **kw):
    return mod.write_newick(T, print_internal=True, print_branch_len=True,
                            **kw)


@pytest.fixture(scope="module")
def fixture_pb(tmp_path_factory):
    """The fixture MAT as a pb, built by the JAX CLI."""
    from usher_tpu.cli.usher_cli import main as jax_main
    out = str(tmp_path_factory.mktemp("host_pb"))
    pb = os.path.join(out, "out.pb")
    assert jax_main(["-t", GLOBAL_NH, "-v", GLOBAL_VCF, "-o", pb, "-d", out,
                     "--mesh-devices", "0"]) == 0
    return pb


# --- core/nuc, io/proto_wire ---------------------------------------------------

def test_nuc_tables_match():
    for ch in "ACGTRYSWKMBDHVN-acgtn?":
        assert tnuc.nuc_id_from_char(ch) == jnuc.nuc_id_from_char(ch)
    for i in range(16):
        assert tnuc.char_from_nuc_id(i) == jnuc.char_from_nuc_id(i)
        assert tnuc.nt_list_from_nuc_id(i) == jnuc.nt_list_from_nuc_id(i)
        assert tnuc.nuc_id_from_nt_list(tnuc.nt_list_from_nuc_id(i)) == \
            jnuc.nuc_id_from_nt_list(jnuc.nt_list_from_nuc_id(i))
        if i:
            assert tnuc.lowest_set_bit(i) == jnuc.lowest_set_bit(i)
    for i in (1, 2, 4, 8):
        assert tnuc.nt_from_nuc_id(i) == jnuc.nt_from_nuc_id(i)
    assert tnuc.N == jnuc.N


def test_proto_wire_is_the_same_source():
    """proto_wire has no imports of its own package: the copy is verbatim."""
    with open(jpw.__file__, "rb") as a, open(tpw.__file__, "rb") as b:
        assert a.read() == b.read()


# --- core/tree -------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tree_expansions_and_copy_match(seed):
    rng = np.random.default_rng(seed)
    T, _ = random_mat(rng, n_leaves=40, n_positions=20)
    P = port_tree(T)
    assert tree_signature(P) == tree_signature(T)
    assert [n.identifier for n in P.breadth_first_expansion()] == \
        [n.identifier for n in T.breadth_first_expansion()]
    assert [(n.dfs_idx, n.dfs_end_idx) for n in P.depth_first_expansion()] == \
        [(n.dfs_idx, n.dfs_end_idx) for n in T.depth_first_expansion()]
    assert P.get_leaves_ids() == T.get_leaves_ids()
    assert P.get_parsimony_score() == T.get_parsimony_score()
    assert P.get_max_level() == T.get_max_level()
    assert P.num_nodes() == T.num_nodes()
    leaf = T.get_leaves_ids()[3]
    assert [n.identifier for n in P.rsearch(leaf, True)] == \
        [n.identifier for n in T.rsearch(leaf, True)]
    C = P.copy()
    assert isinstance(C, ttree.Tree) and C is not P
    assert tree_signature(C) == tree_signature(T.copy())


@pytest.mark.parametrize("seed", [3, 4])
def test_tree_surgery_matches(seed):
    """create/move/remove, collapse, condense and uncondense change both
    trees alike."""
    rng = np.random.default_rng(seed)
    T, _ = random_mat(rng, n_leaves=30, n_positions=12, mut_rate=0.15)
    P = port_tree(T)
    for tree, mod in ((T, jtree), (P, ttree)):
        leaves = tree.get_leaves_ids()
        nid = tree.new_internal_node_id()
        target = tree.get_node(leaves[2])
        tree.create_node(nid, target.parent)
        tree.move_node(leaves[2], nid)
        tree.create_node("added", nid)
        tree.get_node("added").add_mutation(
            mod.Mutation("c", 105, 1, 1, 4))
        tree.remove_node(leaves[5], True)
    assert tree_signature(P) == tree_signature(T)
    for tree in (T, P):
        tree.collapse_tree()
        tree.condense_leaves()
    assert tree_signature(P) == tree_signature(T)
    assert P.condensed_nodes == T.condensed_nodes
    assert _nwk(tnewick, P) == _nwk(jnewick, T)
    for tree in (T, P):
        tree.uncondense_leaves()
    assert tree_signature(P) == tree_signature(T)


def test_add_mutation_chronology_matches():
    """Same-position updates and reversals of Node.add_mutation."""
    def run(mod):
        t = mod.Tree()
        t.create_node("r")
        n = t.create_node("a", "r")
        for args in (("c", 7, 1, 1, 2), ("c", 3, 4, 4, 8), ("c", 7, 1, 2, 4),
                     ("c", 3, 4, 8, 4), ("c", 9, 2, 2, 1)):
            n.add_mutation(mod.Mutation(*args))
        return [(m.position, m.par_nuc, m.mut_nuc) for m in n.mutations]
    assert run(ttree) == run(jtree)


# --- io/newick, io/pbio, io/vcf ----------------------------------------------------

def test_newick_parse_write_bytes():
    Tj = jnewick.parse_newick(GLOBAL_NH)
    Tt = tnewick.parse_newick(GLOBAL_NH)
    assert isinstance(Tt, ttree.Tree)
    assert tree_signature(Tt) == tree_signature(Tj)
    for kw in ({}, {"retain_original_branch_len": True},
               {"uncondense_leaves": True}):
        assert _nwk(tnewick, Tt, **kw) == _nwk(jnewick, Tj, **kw)
    assert tnewick.write_newick(Tt, print_internal=False,
                                print_branch_len=False) == \
        jnewick.write_newick(Tj, print_internal=False,
                             print_branch_len=False)
    s = "((A:1,B:0.5)x:2,(C,D:3e-1)y,E);"
    assert tree_signature(tnewick.parse_newick_string(s)) == \
        tree_signature(jnewick.parse_newick_string(s))


def test_pb_load_save_bytes(fixture_pb, tmp_path):
    Tj = jpbio.load_mat_pb(fixture_pb)
    Tt = tpbio.load_mat_pb(fixture_pb)
    assert isinstance(Tt, ttree.Tree)
    assert tree_signature(Tt) == tree_signature(Tj)
    assert Tt.condensed_nodes == Tj.condensed_nodes
    out_j, out_t = str(tmp_path / "j.pb"), str(tmp_path / "t.pb")
    jpbio.save_mat_pb(Tj, out_j)
    tpbio.save_mat_pb(Tt, out_t)
    with open(out_j, "rb") as a, open(out_t, "rb") as b, \
            open(fixture_pb, "rb") as c:
        saved = b.read()
        assert a.read() == saved
        assert saved == c.read()


def _missing_fields(missing):
    return [(s.name, s.num_ambiguous,
             [(m.chrom, m.position, m.ref_nuc, m.par_nuc, m.mut_nuc,
               m.is_missing) for m in s.mutations]) for s in missing]


def _vcf_fields(vcf):
    return (list(vcf.sample_ids),
            [(s.chrom, s.position, s.ref_nuc, list(s.variants))
             for s in vcf.sites])


def test_read_vcf_fields_build_mode():
    """The port's pure-Python parser gives what the JAX package's reader
    gives (its compiled parser where that is built)."""
    Tj = jnewick.parse_newick(GLOBAL_NH)
    Tt = tnewick.parse_newick(GLOBAL_NH)
    mj, vj = jvcf.read_vcf(Tj, GLOBAL_VCF, create_new_mat=True)
    mt, vt = tvcf.read_vcf(Tt, GLOBAL_VCF, create_new_mat=True)
    assert _vcf_fields(vt) == _vcf_fields(vj)
    assert _missing_fields(mt) == _missing_fields(mj)
    assert _vcf_fields(tvcf.read_vcf_sites(NEW_VCF)) == \
        _vcf_fields(jvcf.read_vcf_sites(NEW_VCF))


def test_read_vcf_fields_placement_mode(fixture_pb):
    Tj = jpbio.load_mat_pb(fixture_pb)
    Tt = tpbio.load_mat_pb(fixture_pb)
    mj, vj = jvcf.read_vcf(Tj, NEW_VCF, create_new_mat=False)
    mt, vt = tvcf.read_vcf(Tt, NEW_VCF, create_new_mat=False)
    assert len(mt) == 5
    assert all(isinstance(m, ttree.Mutation) for s in mt for m in s.mutations)
    assert _missing_fields(mt) == _missing_fields(mj)
    assert _vcf_fields(vt) == _vcf_fields(vj)


def test_read_vcf_gzip_and_bad_rows(tmp_path):
    import gzip
    with open(NEW_VCF, "rb") as f:
        raw = f.read()
    gz = str(tmp_path / "new.vcf.gz")
    with gzip.open(gz, "wb") as f:
        f.write(raw)
    assert _vcf_fields(tvcf.read_vcf_sites(gz)) == \
        _vcf_fields(jvcf.read_vcf_sites(NEW_VCF))
    bad = str(tmp_path / "bad.vcf")
    with open(bad, "w") as f:
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts1\n"
                "c\t5\t.\tA\tG\t.\t.\t.\tGT\n")
    # the compiled scanners of both packages read a short row as calling
    # no sample (both packages' default where the scanner is built) ...
    assert _vcf_fields(tvcf.read_vcf_sites(bad)) == \
        _vcf_fields(jvcf.read_vcf_sites(bad))
    # ... and both pure-Python readers refuse it
    import usher_tpu.native as jnative
    import usher_tpu_torch.native as tnative
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "HAVE_NATIVE", False)
        mp.setattr(tnative, "_loaded", lambda: (None, "not used"))
        for mod in (tvcf, jvcf):
            with pytest.raises(ValueError, match="Incorrect VCF format"):
                mod.read_vcf_sites(bad)


# --- placement/mapper -----------------------------------------------------------

def _score_fields(d):
    key = lambda m: (m.position, m.ref_nuc, m.par_nuc, m.mut_nuc,  # noqa: E731
                     m.is_missing)
    return (d.set_difference, d.node_num_mut, d.num_common, d.has_unique,
            d.is_valid, [key(m) for m in d.excess],
            [key(m) for m in d.imputed])


@pytest.mark.parametrize("seed", [20, 21, 22])
def test_score_placement_matches(seed):
    rng = np.random.default_rng(seed)
    T, ref = random_mat(rng, n_leaves=30, n_positions=15)
    P = port_tree(T)
    samples = [random_sample(rng, ref) for _ in range(5)]
    psamples = port_samples(samples)
    for nj, nt in zip(T.breadth_first_expansion(),
                      P.breadth_first_expansion()):
        for sj, st in zip(samples, psamples):
            for vecs in (True, False):
                assert _score_fields(tmapper.score_placement(
                    nt, st, compute_vecs=vecs)) == _score_fields(
                        jmapper.score_placement(nj, sj, compute_vecs=vecs))


# --- tools/subtrees (with matutils get_subtree, rotate_for_display) ----------------

def _dir_files(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("single", [False, True])
def test_subtree_writers_match(tmp_path, single):
    rng = np.random.default_rng(7)
    T, _ = random_mat(rng, n_leaves=40, n_positions=15)
    P = port_tree(T)
    names = T.get_leaves_ids()[5:9]
    outs = []
    for name, mod, tree in (("j", jsubtrees, T), ("t", tsubtrees, P)):
        out = str(tmp_path / name)
        os.makedirs(out)
        if single:
            mod.write_single_subtree(tree, names, out, 10)
        else:
            mod.write_sample_subtrees(tree, names, out, 6)
        outs.append(_dir_files(out))
    assert outs[0] and outs[1] == outs[0]


# --- utils/instrument -----------------------------------------------------------

def test_instrumentor_trace_matches(tmp_path):
    import json
    shapes = []
    for name, mod in (("j", jinstrument), ("t", tinstrument)):
        path = str(tmp_path / f"{name}.json")
        inst = mod.Instrumentor.get()
        assert not inst.active
        with mod.timeit("ignored"):
            pass
        inst.begin_session(path)
        with mod.timeit("outer"):
            with mod.timeit('in"ner'):
                pass
        inst.end_session()
        with open(path) as f:
            doc = json.load(f)
        shapes.append((sorted(doc), [(e["name"], e["ph"], e["cat"],
                                      sorted(e)) for e in doc["traceEvents"]]))
        assert mod.Timer().stop() >= 0
    assert shapes[0] == shapes[1]
    assert [e[0] for e in shapes[1][1]] == ["in'ner", "outer"]


def test_profile_session_from_env(tmp_path, monkeypatch):
    path = str(tmp_path / "p.json")
    monkeypatch.delenv("USHER_TPU_PROFILE", raising=False)
    assert tinstrument.maybe_begin_session_from_env() is False
    monkeypatch.setenv("USHER_TPU_PROFILE", path)
    assert tinstrument.maybe_begin_session_from_env() is True
    inst = tinstrument.Instrumentor.get()
    assert inst.active
    inst.end_session()
    assert os.path.exists(path)
    assert not hasattr(tinstrument, "apply_platform_env")


# --- io/pb_arrays, placement/list_tree, placement/direct (the --pb-direct
# --- slice): the copies keep their originals' code -----------------------

def _code_by_name(path):
    """Every function and method of a module, by qualified name, as its
    AST without docstrings (so comments, docstrings and layout may
    differ, the code may not)."""
    import ast

    def strip(node):
        body = getattr(node, "body", None)
        if (body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        return node

    with open(path) as f:
        tree = ast.parse(f.read())
    out = {}

    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.ClassDef)):
                name = prefix + child.name
                if isinstance(child, ast.FunctionDef):
                    out[name] = ast.dump(strip(child))
                walk(child, name + ".")
    walk(tree, "")
    return out


@pytest.mark.parametrize("module,changed", [
    # its BigMAT takes a device (the loader, compiled scanners included,
    # is the original's since the port has native/)
    ("io.pb_arrays", {"MatArrays.to_bigmat"}),
    ("placement.list_tree", set()),
    # a parallel.mesh.Mesh instead of a jax Mesh, the BigMAT on its lead
    ("placement.direct", {"DirectPlacer.__init__"})])
def test_direct_slice_copies_keep_the_code(module, changed):
    """Each function of the slice's copies is its original's, apart from
    the named ones (what tests/test_torch_{pb_arrays,list_tree,direct}.py
    hold against the JAX package)."""
    import importlib
    rel = module.replace(".", os.sep) + ".py"
    jmod = importlib.import_module("usher_tpu." + module)
    tmod = importlib.import_module("usher_tpu_torch." + module)
    want = _code_by_name(os.path.join(os.path.dirname(jmod.__file__),
                                      os.path.basename(rel)))
    got = _code_by_name(os.path.join(os.path.dirname(tmod.__file__),
                                     os.path.basename(rel)))
    assert sorted(got) == sorted(want)
    differ = {name for name in want if got[name] != want[name]}
    assert differ == changed


@pytest.mark.parametrize("module,changed,added,removed", [
    # the pure-Python codec only (the JAX package's native one is A6c)
    ("io.transpose", {"encode", "decode"}, set(), set()),
    ("io.diff", set(), set(), set()),
    ("io.patch", set(), set(), set()),
    ("io.detailed", set(), set(), set()),
    # a column slice of one sorted entry list per BFS order, not a Python
    # loop over the leaves per chunk
    ("optimize.leafstore", {"SparseLeafStore.__init__",
                            "SparseLeafStore.materialize"},
     {"SparseLeafStore._leaf_entries"}, set()),
    # the device argument, the mesh of torch devices, two more spans
    ("optimize.driver", {"optimize_tree", "optimize_tree.full_refresh",
                         "optimize_tree.full_refresh_streamed"}, set(),
     set()),
    # X11 on torch, the tree's tensors per device, the source batch split
    # over a mesh by _run_sharded
    ("optimize.spr", {"MoveFinder.__init__", "MoveFinder.find_moves",
                      "_score_moves"},
     {"MoveFinder._chunk_inputs", "MoveFinder.tree_on", "_dest_ok",
      "_source_arrays", "_source_paths", "_spr_scores", "_run_sharded",
      "_run_sharded.one"}, set()),
    # X3 on torch: per-level index tensors and the root-row rule; the
    # mutation extraction in uint8 and over the rows that carry one, once
    # a streamed chunk; the mask deviations as flat arrays grouped by
    # numpy, not a Python step per node
    ("optimize.fitch", {"FitchEngine.__init__", "FitchEngine.run",
                        "FitchEngine.run_rewrite_streamed",
                        "FitchEngine._mutation_arrays",
                        "FitchEngine._mutation_lists", "_fs_chunk",
                        "_fs_chunk.pick", "_min_back_chunk",
                        "_min_back_chunk.pick", "MaskDeviations.__init__",
                        "MaskDeviations.set_chunk",
                        "MaskDeviations.deviations",
                        "MaskDeviations.remap_patch"},
     {"FitchEngine._levels_on", "FitchEngine._ref_nt", "FitchEngine._solve",
      "_Levels.__init__", "_Levels.__init__.t", "_leaf_bits", "_masks_of",
      "_root_row_kept", "MaskDeviations._arrays", "FitchEngine._lists_of"},
     {"_min_back_chunk.contrib_of"}),
    ("optimize.spr_big", {"BigMoveFinder.__init__", "BigMoveFinder._mc_for",
                          "BigMoveFinder.find_moves", "_fetch3"},
     {"BigMoveFinder._find_one", "BigMoveFinder._find_sharded"}, set()),
    ("optimize.epp", {"_tie_matrix", "count_epps"}, {"count_epps.up"},
     set()),
    ("cli.matoptimize_cli", {"build_parser", "main"}, {"_visible_cards"},
     set())])
def test_matoptimize_slice_copies_keep_the_code(module, changed, added,
                                                removed):
    """Each function of the matOptimize slice is its original's, apart from
    the named ones (what tests/test_torch_{fitch,spr,spr_big,epp,detailed,
    matoptimize}.py hold against the JAX package)."""
    import importlib
    rel = module.replace(".", os.sep) + ".py"
    jmod = importlib.import_module("usher_tpu." + module)
    tmod = importlib.import_module("usher_tpu_torch." + module)
    want = _code_by_name(os.path.join(os.path.dirname(jmod.__file__),
                                      os.path.basename(rel)))
    got = _code_by_name(os.path.join(os.path.dirname(tmod.__file__),
                                     os.path.basename(rel)))
    assert set(got) - set(want) == added
    assert set(want) - set(got) == removed
    assert {name for name in want
            if name in got and got[name] != want[name]} == changed


@pytest.mark.parametrize("module,changed", [
    ("io.vcf", set()),
    ("placement.sampled", set()),
    # the device, spans, --mesh-devices -1 over CUDA cards, --distributed
    # refused, and no engine kept across an optimization round
    ("cli.usher_sampled_cli", {"build_parser", "_optimize", "main"}),
    # the version line names the port; the platform helper's home
    ("cli.usher_server_cli", {"build_parser", "run_request", "main"}),
    ("cli.usher_socket_server_cli", {"build_parser", "handle_request",
                                     "main"})])
def test_sampled_slice_copies_keep_the_code(module, changed):
    """Each function of the usher-sampled / servers slice and of the VCF
    reader (whose compiled branch came back with native/) is its
    original's, apart from the named ones (what tests/test_torch_{native,
    sampled,usher_sampled,servers}.py hold against the JAX package)."""
    import importlib
    rel = module.replace(".", os.sep) + ".py"
    jmod = importlib.import_module("usher_tpu." + module)
    tmod = importlib.import_module("usher_tpu_torch." + module)
    want = _code_by_name(os.path.join(os.path.dirname(jmod.__file__),
                                      os.path.basename(rel)))
    got = _code_by_name(os.path.join(os.path.dirname(tmod.__file__),
                                     os.path.basename(rel)))
    assert sorted(got) == sorted(want)
    assert {name for name in want if got[name] != want[name]} == changed


def test_native_source_is_the_original():
    """The compiled scanners' C++ is the JAX package's: the code below the
    header comment is the same line for line, and only comments (`//` to
    the end of a line; the source has no such text in a string) may
    differ."""
    import re
    import usher_tpu.native as jnative
    from usher_tpu_torch.native import _build

    def code(path):
        with open(path) as f:
            src = f.read()
        body = src[src.index("#define PY_SSIZE_T_CLEAN"):]
        return [re.sub(r"\s*//.*$", "", line) for line in body.splitlines()]
    want = code(os.path.join(os.path.dirname(jnative.__file__), "src",
                             "usher_native.cpp"))
    assert len(want) > 900
    assert code(_build.SOURCE) == want


def test_transposed_vcf_codec_matches(tmp_path):
    """The port's pure-Python codec writes the JAX package's bytes and
    reads them back; samples_from_vcf and encode_vcf agree."""
    from usher_tpu.io import transpose as jtr
    from usher_tpu_torch.io import transpose as ttr
    samples = [("s1", [(5, 1), (9, 4), (300, 8)], [(12, 14)]),
               ("s_two", [(7, 2)], []), ("s3", [], [(1, 1), (40, 90)])]
    a, b = tmp_path / "a.tvcf", tmp_path / "b.tvcf"
    jtr._encode_py(samples, str(a))
    ttr.encode(samples, str(b))
    ttr.encode(samples[:1], str(b), append=True)
    jtr._encode_py(samples[:1], str(a), append=True)
    assert a.read_bytes() == b.read_bytes()
    assert ttr.decode(str(b)) == jtr._decode_py(str(a))
    assert ttr.samples_from_vcf(tvcf.read_vcf_sites(GLOBAL_VCF)) == \
        jtr.samples_from_vcf(jvcf.read_vcf_sites(GLOBAL_VCF))
    assert ttr.encode_vcf(GLOBAL_VCF, str(b)) == \
        jtr.encode_vcf(GLOBAL_VCF, str(a))
    assert ttr.decode(str(b)) == jtr.decode(str(a))


def test_diff_and_patch_match(tmp_path):
    """io/diff.py's loaders and io/patch.py's two patchers give the JAX
    package's records and trees."""
    from usher_tpu.io import diff as jdiff, patch as jpatch
    from usher_tpu.io import transpose as jtr
    from usher_tpu_torch.io import diff as tdiff, patch as tpatch
    ref_fa = tmp_path / "ref.fa"
    ref_fa.write_text(">chr\n" + "ACGTN" * 8 + "\n")
    diff = tmp_path / "s.diff"
    diff.write_text(">L1\nc\t5\n>L2\ng\t7\nn\t12\t3\n>L3\n-\t20\n>L4\n")
    jrefs, jchrom = jdiff.load_reference_fasta(str(ref_fa))
    trefs, tchrom = tdiff.load_reference_fasta(str(ref_fa))
    assert (list(trefs), tchrom) == (list(jrefs), jchrom)
    js = jdiff.load_diff(str(diff), jrefs, jchrom)
    ts = tdiff.load_diff(str(diff), trefs, tchrom)
    assert [(s.name, [(m.position, m.ref_nuc, m.mut_nuc) for m in
                      s.mutations]) for s in ts] == \
        [(s.name, [(m.position, m.ref_nuc, m.mut_nuc) for m in s.mutations])
         for s in js]
    nh = tmp_path / "t.nh"
    nh.write_text("((L1,L2),(L3,L4));\n")
    J, P = jnewick.parse_newick(str(nh)), tnewick.parse_newick(str(nh))
    assert tpatch.assign_states_from_diff(P, str(diff), str(ref_fa)) == \
        jpatch.assign_states_from_diff(J, str(diff), str(ref_fa))
    assert tree_signature(P) == tree_signature(J)
    rng = np.random.default_rng(4)
    T, _ = random_mat(rng, n_leaves=30, n_positions=15)
    P = port_tree(T)
    leaves = [n.identifier for n in T.get_leaves()]
    pos = sorted({m.position for n in T.breadth_first_expansion()
                  for m in n.mutations})
    tv = str(tmp_path / "p.tvcf")
    jtr._encode_py([(leaves[0], [(pos[0], 5), (99999, 2)], [(pos[1], pos[3])]),
                    (leaves[5], [(pos[2], 15)], [])], tv)
    assert tpatch.patch_mat_from_transposed_vcf(P, tv) == \
        jpatch.patch_mat_from_transposed_vcf(T, tv)
    assert tree_signature(P) == tree_signature(T)


@pytest.mark.parametrize("module,changed", [
    # the usage line names the port
    ("io.fatovcf", {"main"}),
    ("matutils.describe", set()),
    ("matutils.fix", set()),
    ("matutils.summary", set()),
    ("matutils.convert", set()),
    ("matutils.convert_arrays", set()),
    # whole copies now (rotate_for_display and get_subtree were the only
    # pieces before)
    ("matutils.translate", set()),
    ("matutils.tree_filter", set()),
    ("matutils.translate_arrays", set()),
    ("matutils.extract", set()),
    ("matutils.introduce", set()),
    ("matutils.introduce_arrays", set()),
    ("matutils.select", set()),
    ("matutils.mask", set()),
    ("matutils.uncertainty", set()),
    ("matutils.annotate", set()),
    ("matutils.merge", set()),
    # the host tie and restricted scores index the port's exact-N DFS rows
    # (its dump row is N, where the JAX BigMAT padded to n_pad)
    ("matutils.arrays", {"_host_tie_slots"}),
    ("matutils.merge_arrays", {"_host_restricted_score"}),
    # the help and version lines name the port
    ("cli.matutils_cli", {"main"})])
def test_matutils_slice_copies_keep_the_code(module, changed):
    """Each function of the matUtils slice is its original's, apart from
    the named ones (what tests/test_torch_matutils.py holds against the
    JAX CLI)."""
    import importlib
    rel = module.replace(".", os.sep) + ".py"
    jmod = importlib.import_module("usher_tpu." + module)
    tmod = importlib.import_module("usher_tpu_torch." + module)
    want = _code_by_name(os.path.join(os.path.dirname(jmod.__file__),
                                      os.path.basename(rel)))
    got = _code_by_name(os.path.join(os.path.dirname(tmod.__file__),
                                     os.path.basename(rel)))
    assert sorted(got) == sorted(want)
    assert {name for name in want if got[name] != want[name]} == changed


def test_group_ancestral_batch_is_the_original():
    """X6's host side, BigMAT.group_ancestral_batch and the functions
    nested in it, is the JAX package's code (its device side,
    place_arrays_grouped, is held against the JAX one in
    tests/test_torch_grouped.py)."""
    import usher_tpu.core.bigmat as jbm
    from usher_tpu_torch.core import bigmat as tbm
    want = _code_by_name(jbm.__file__)
    got = _code_by_name(tbm.__file__)
    names = [n for n in want
             if n.startswith("BigMAT.group_ancestral_batch")]
    assert len(names) >= 7
    for name in names:
        assert got[name] == want[name], name


@pytest.mark.parametrize("module,changed,added,removed", [
    ("ripples.filter", set(), set(), set()),
    ("ripples.init", set(), set(), set()),
    ("ripples.utils", set(), set(), set()),
    # X13 as torch ops in row blocks with its prefix sums gathered at the
    # columns the pair loop reads, beside the JAX program's form; the pair
    # loop's exact restructurings (per-run names and DFS indices, the
    # first 1,000 by a name rank, the early stop)
    ("ripples.detect", {"_cost_matrix", "ripples_main"},
     {"_cost_matrix_plain", "gather_columns", "first_by_parsimony",
      "first_pair"}, set()),
    # the usage and version lines name the port; ripples takes the device
    # from USHER_TPU_PLATFORM (utils/device.py) before it reads the pb
    ("cli.ripples_cli", {"build_parser", "main"}, set(), set()),
    ("cli.ripples_filter_cli", {"build_parser", "main"}, set(), set()),
    ("cli.ripples_init_cli", {"main"}, set(), set()),
    ("cli.ripples_utils_cli", {"main"}, set(), set()),
    ("cli.check_samples_cli", set(), set(), set()),
    ("cli.compare_vcf_cli", set(), set(), set()),
    ("cli.transpose_vcf_cli", set(), set(), set()),
    ("__main__", {"main"}, set(), set())])
def test_ripples_slice_copies_keep_the_code(module, changed, added,
                                            removed):
    """Each function of the RIPPLES and tools slice is its original's,
    apart from the named ones (what tests/test_torch_{ripples,tools}.py
    hold against the JAX package)."""
    import importlib
    jmod = importlib.import_module("usher_tpu." + module)
    tmod = importlib.import_module("usher_tpu_torch." + module)
    want = _code_by_name(jmod.__file__)
    got = _code_by_name(tmod.__file__)
    assert set(got) - set(want) == added
    assert set(want) - set(got) == removed
    assert {name for name in want
            if name in got and got[name] != want[name]} == changed
