"""The port's matUtils CLI (usher_tpu_torch/cli/matutils_cli.py) end to
end on the CPU (USHER_TPU_PLATFORM=cpu), against the JAX CLI.

Every invocation of tests/test_matutils.py, tests/test_introduce.py,
tests/test_translate.py and the matUtils goldens of tests/test_golden.py
is a case of ``test_cli_matches_jax``: each side runs the case's
invocations in a directory of its own, and the port's exit codes, stdout
and every file it writes must equal the JAX CLI's byte for byte.  Where a
JAX test requires the Tree path and ``--pb-direct`` to agree, the case
requires it of the port's files too; the goldens are compared with the
port's files.  The functions those tests call directly are held against
the JAX package's in the parametrised tests below it.  The fixture MATs
are built once a module.
"""

import os

import numpy as np
import pytest

import matutils_cases as mc
from usher_tpu.cli.matutils_cli import main as jax_mu
from usher_tpu.core.tree import Mutation, Tree
from usher_tpu.io.pbio import load_mat_pb, save_mat_pb
from usher_tpu_torch.cli.matutils_cli import main as torch_mu

from test_torch_hostlayers import port_tree

CASES = mc.CASES
_lines, _write = mc._lines, mc._write


def _save(d, T, name):
    """A JAX Tree saved by the JAX writer."""
    pb = str(d / name)
    save_mat_pb(T, pb)
    return pb


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("USHER_TPU_PLATFORM", "cpu")


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    return mc.Fixtures(lambda name: str(tmp_path_factory.mktemp(name)),
                       "cpu")


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_matches_jax(case, fx, tmp_path, capsys):
    inp = tmp_path / "in"
    inp.mkdir()
    spec = CASES[case](str(inp), fx)
    steps = spec["steps"]

    def stdout():
        return capsys.readouterr().out
    want, want_files = mc.run_steps(jax_mu, str(tmp_path / "jax"), steps,
                                    stdout)
    got, got_files = mc.run_steps(torch_mu, str(tmp_path / "torch"), steps,
                                  stdout)
    assert got == want
    assert sorted(got_files) == sorted(want_files)
    for name in want_files:
        assert got_files[name] == want_files[name], name
    mc.check_run(spec, got, got_files)


# --- functions the JAX tests call directly ---------------------------------

def test_find_epps_grouped_matches_plain_and_jax(fx, monkeypatch):
    """uncertainty's bulk re-scoring over arrays is the same with X6 under
    it as with X5, and the JAX package's."""
    from usher_tpu.io.pb_arrays import load_mat_arrays as jload
    from usher_tpu.matutils.arrays import find_epps as jfind
    from usher_tpu_torch.core import bigmat as tbm
    from usher_tpu_torch.io.pb_arrays import load_mat_arrays as tload
    from usher_tpu_torch.matutils.arrays import find_epps as tfind
    samples = fx.leaves(fx.mat)[:60]
    calls = []
    orig = tbm.BigMAT.place_arrays_grouped

    def spy(self, *a, **k):
        calls.append(1)
        return orig(self, *a, **k)
    monkeypatch.setattr(tbm.BigMAT, "place_arrays_grouped", spy)
    monkeypatch.setenv("USHER_TPU_GROUPED", "1")
    grp = tfind(tload(fx.mat), samples)
    assert calls
    monkeypatch.setenv("USHER_TPU_GROUPED", "0")
    plain = tfind(tload(fx.mat), samples)
    assert len(calls) == 1
    assert grp == plain == jfind(jload(fx.mat), samples)


def _hand_tree(pkg):
    """test_introduce.py's build_tree in either package's classes."""
    T = pkg.Tree()
    T.create_node("root")
    for name, parent, pos in (("A", "root", 10), ("I1", "root", 20),
                              ("B", "I1", None), ("C", "I1", 30),
                              ("I2", "root", 40), ("D", "I2", 50),
                              ("E", "I2", 60)):
        n = T.create_node(name, parent)
        if pos is not None:
            n.add_mutation(pkg.Mutation("c", pos, 1, 1, 2))
    return T


def _polytomy(pkg):
    T = pkg.Tree()
    T.create_node("root")
    for i in range(1100):
        n = T.create_node(f"L{i}", "root")
        n.add_mutation(pkg.Mutation("c", 10 + (i % 50), 1, 1, 2))
    return T


@pytest.mark.parametrize("what", ["assignments", "association_index",
                                  "find_introductions", "read_two_column",
                                  "overflow_guard"])
def test_introduce_functions_match_jax(what, tmp_path):
    import usher_tpu.core.tree as jtree
    import usher_tpu.matutils.introduce as jin
    import usher_tpu_torch.core.tree as ttree
    import usher_tpu_torch.matutils.introduce as tin

    def run(tree_mod, mod):
        T = _hand_tree(tree_mod)
        if what == "assignments":
            return sorted(mod.get_assignments(T, {"B", "C"}).items())
        if what == "association_index":
            asg = mod.get_assignments(T, {"B", "C"})
            return (mod.get_association_index(T, asg),
                    mod.get_monophyletic_cladesize(T, asg))
        if what == "find_introductions":
            return mod.find_introductions(T, {"default": ["B", "C"]})
        if what == "read_two_column":
            p = tmp_path / "samples.txt"
            p.write_text("s1\ns2\tregionA\ns3\tregionA\n")
            return mod.read_two_column(str(p))
        T = _polytomy(tree_mod)
        asg = mod.get_assignments(T, {f"L{i}" for i in range(0, 1100, 2)})
        return mod.get_association_index(T, asg)
    assert run(ttree, tin) == run(jtree, jin)


@pytest.mark.parametrize("trial", [0, 1, 2, "fixture"])
def test_introduce_main_both_paths_match_jax(trial, fx, tmp_path):
    """test_introduce.py's Tree-vs-arrays runs: the port's introduce_main
    and introduce_main_arrays write the JAX package's files and rows."""
    import usher_tpu.matutils.introduce as jin
    import usher_tpu.matutils.introduce_arrays as jina
    import usher_tpu_torch.matutils.introduce as tin
    import usher_tpu_torch.matutils.introduce_arrays as tina
    from test_introduce import _ann_tree
    if trial == "fixture":
        pb = fx.smoke
        pop = _lines(fx.leaves(pb)[:25])
        kw = dict(additional_info=True)
    else:
        rng = np.random.default_rng(7)
        for _ in range(trial + 1):
            T = _ann_tree(rng)
        pb = _save(tmp_path, T, "t.pb")
        T2 = T.copy()
        T2.uncondense_leaves()
        leaves = T2.get_leaves_ids()
        pop = "".join(s + ("\tR1\n" if i % 2 else "\tR2\n")
                      for i, s in enumerate(leaves[:max(6,
                                                        len(leaves) // 2)]))
        pop += "not_in_tree\tR1\n"
        kw = dict(additional_info=True, evaluate_metadata=True,
                  num_to_look=2, minimum_gap=1, minimum_to_report=0.01,
                  num_to_report=2)
    spath = _write(tmp_path / "pop.txt", pop)
    results = {}
    for tag, fn in (("jt", jin.introduce_main),
                    ("ja", jina.introduce_main_arrays),
                    ("tt", tin.introduce_main),
                    ("ta", tina.introduce_main_arrays)):
        d = tmp_path / tag
        d.mkdir()
        out = fn(pb, spath, full_output=str(d / "out.tsv"),
                 cluster_output=str(d / "clusters.tsv"),
                 dump_assignments=str(d / "dump"),
                 clade_regions=str(d / "clades.tsv"), **kw)
        files = {str(p.relative_to(d)): p.read_bytes()
                 for p in sorted(d.rglob("*")) if p.is_file()}
        results[tag] = (out, files)
    assert results["tt"] == results["jt"]
    assert results["ta"] == results["ja"]
    assert results["tt"] == results["ta"]


def _translate_inputs(tmp_path, strand="+"):
    fasta = _write(tmp_path / "ref.fa", ">ref\n" + mc.REF_SEQ + "\n")
    gtf = _write(tmp_path / "genes.gtf", "ref\ttest\tCDS\t1\t12\t.\t"
                 f'{strand}\t.\tgene_id "GENE1";\n')
    return fasta, gtf


@pytest.mark.parametrize("what", ["translate_tsv", "codon_map_minus",
                                  "taxodium", "node_stats_roho",
                                  "translate_arrays", "taxodium_arrays"])
def test_translate_functions_match_jax(what, tmp_path):
    """test_translate.py's writers: the port's files equal the JAX
    package's (Trees of each package's own classes)."""
    import usher_tpu.matutils.summary as jsum
    import usher_tpu.matutils.translate as jtr
    import usher_tpu.matutils.translate_arrays as jtra
    import usher_tpu_torch.io.pb_arrays as tpa
    import usher_tpu_torch.io.pbio as tpbio
    import usher_tpu_torch.matutils.summary as tsum
    import usher_tpu_torch.matutils.translate as ttr
    import usher_tpu_torch.matutils.translate_arrays as ttra
    from usher_tpu.io.pb_arrays import load_mat_arrays as jload
    from test_translate import _bigger_tree, _mk_tree
    fasta, gtf = _translate_inputs(tmp_path,
                                   "-" if what == "codon_map_minus" else "+")
    meta = _write(tmp_path / "meta.tsv", "strain\tdate\tcountry\n"
                  "L1\t2020-03-01\tUSA\nL2\t2020-04-01\tUK\n")

    def hand_stats_tree():
        T = Tree()
        root = T.create_node("node_root")
        c1 = T.create_node("node_c1", parent=root)
        c1.mutations = [Mutation("ref", 2, 8, 8, 1)]
        c2 = T.create_node("node_c2", parent=root)
        c2.mutations = [Mutation("ref", 3, 4, 4, 2)]
        for i in range(7):
            T.create_node(f"s1_{i}", parent=c1)
        for i in range(8):
            T.create_node(f"s2_{i}", parent=c2)
        return T

    def run(side):
        tr, tra, summ = (jtr, jtra, jsum) if side == "j" else \
            (ttr, ttra, tsum)
        conv = (lambda T: T) if side == "j" else port_tree
        out = tmp_path / side
        out.mkdir()
        if what == "translate_tsv":
            tr.translate_main(conv(_mk_tree()), str(out / "aa.tsv"), gtf,
                              fasta)
        elif what == "codon_map_minus":
            cmap = tr.build_codon_map(gtf, tr.build_reference(fasta))
            return sorted((k, [(c.nucleotides, c.protein, c.start_position)
                               for c in v]) for k, v in cmap.items())
        elif what == "taxodium":
            tr.save_taxodium_tree(conv(_mk_tree()), str(out / "tax.pb"),
                                  [meta], gtf, fasta, title="t",
                                  description="d")
        elif what == "node_stats_roho":
            T = conv(hand_stats_tree())
            summ.write_node_stats(T, str(out / "nodestats.tsv"))
            summ.write_roho_table(T, str(out / "roho.tsv"))
        else:
            pb = str(tmp_path / "t.pb")
            if not os.path.exists(pb):
                save_mat_pb(_bigger_tree(), pb)
            ma = jload(pb) if side == "j" else tpa.load_mat_arrays(pb)
            if what == "translate_arrays":
                tra.translate_arrays(ma, str(out / "arr.tsv"), gtf, fasta)
                T = (load_mat_pb if side == "j" else tpbio.load_mat_pb)(pb)
                tr.translate_main(T, str(out / "tree.tsv"), gtf, fasta)
            else:
                T = (load_mat_pb if side == "j" else tpbio.load_mat_pb)(pb)
                T.uncondense_leaves()
                rows = ["strain\tdate\tcountry\tgenbank_accession"] + [
                    f"{lid}\t2020-0{1 + i % 9}-01\tC{i % 5}\tGB{i}"
                    for i, lid in enumerate(T.get_leaves_ids()[:30])]
                m2 = _write(tmp_path / "meta2.tsv", "\n".join(rows) + "\n")
                tra.save_taxodium_arrays(ma, str(out / "arr.pb"), [m2],
                                         gtf, fasta, title="t",
                                         description="d", include_nt=True)
                tr.save_taxodium_tree(
                    (load_mat_pb if side == "j" else tpbio.load_mat_pb)(pb),
                    str(out / "tree.pb"), [m2], gtf, fasta, title="t",
                    description="d", include_nt=True)
        return {p.name: p.read_bytes() for p in sorted(out.iterdir())}
    got = run("t")
    assert got == run("j")
    if what in ("translate_arrays", "taxodium_arrays"):
        a, b = sorted(got)
        assert got[a] == got[b]


def test_mask_get_closest_samples_matches_jax():
    import usher_tpu.core.tree as jtree
    import usher_tpu.matutils.mask as jmask
    import usher_tpu_torch.core.tree as ttree
    import usher_tpu_torch.matutils.mask as tmask

    def run(tree_mod, mod):
        T = tree_mod.Tree()
        T.create_node("root")
        for name in "abc":
            T.create_node(name, "root")
        T.get_node("b").add_mutation(tree_mod.Mutation("c", 10, 1, 1, 8))
        for m in range(4):
            T.get_node("c").add_mutation(
                tree_mod.Mutation("c", 20 + m, 1, 1, 8))
        return [mod.get_closest_samples(T, "a", k) for k in (1, 4)]
    assert run(ttree, tmask) == run(jtree, jmask) == [["b"], ["b", "c"]]


def test_uncertainty_fisher_test_matches_jax():
    from usher_tpu.matutils.uncertainty import _fisher_test as jf
    from usher_tpu_torch.matutils.uncertainty import _fisher_test as tf
    for args in ((5, 5, 5, 5), (10, 0, 0, 10), (3, 1, 1, 3), (7, 2, 0, 9)):
        assert tf(*args) == jf(*args)
