"""The port's detailed-mutations checkpoint (usher_tpu_torch/io/detailed.py)
against the JAX package's: mirrors of tests/test_detailed.py on the port's
classes, with every checkpoint the port writes byte-equal to the one JAX
writes for the same tree, and a matOptimize resume from it (-a) giving
JAX's output pb."""

import os

import pytest

from usher_tpu.io import detailed as jdet
from usher_tpu.io.pbio import load_mat_pb as jload
from usher_tpu_torch.core.tree import Mutation, Tree
from usher_tpu_torch.io import detailed as tdet
from usher_tpu_torch.io.newick import write_newick
from usher_tpu_torch.io.pbio import load_mat_pb

from conftest import REFERENCE_SCRIPTS_DIR

SCRIPTS = REFERENCE_SCRIPTS_DIR


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("USHER_TPU_PLATFORM", "cpu")


@pytest.fixture(scope="module")
def small_mat(tmp_path_factory):
    from usher_tpu_torch.cli.usher_cli import main as usher_main
    outdir = str(tmp_path_factory.mktemp("torch_detailed_build"))
    pb = os.path.join(outdir, "small.pb")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USHER_TPU_PLATFORM", "cpu")
        assert usher_main(["-t", os.path.join(SCRIPTS, "testBranchLen2.nwk"),
                           "-v", os.path.join(SCRIPTS, "testBranchLen2.vcf"),
                           "-o", pb, "-d", outdir]) == 0
    return pb


def _tree_signature(T):
    return [(n.identifier, n.parent.identifier if n.parent else None,
             tuple((m.chrom, m.position, m.ref_nuc, m.par_nuc, m.mut_nuc)
                   for m in n.mutations),
             tuple(n.clade_annotations))
            for n in T.depth_first_expansion()]


def _same_as_jax(pb, ckpt, tmp_path, changed_ids=None):
    """JAX's checkpoint of the same pb is byte-equal to the port's."""
    jck = str(tmp_path / "jax.detailed")
    jdet.save_detailed_mutations(jload(pb), jck, changed_ids=changed_ids)
    with open(ckpt, "rb") as a, open(jck, "rb") as b:
        assert a.read() == b.read()


def test_roundtrip_lossless(small_mat, tmp_path):
    T = load_mat_pb(small_mat)
    ckpt = str(tmp_path / "ck.detailed")
    tdet.save_detailed_mutations(T, ckpt, changed_ids={"a", "node_3"})
    _same_as_jax(small_mat, ckpt, tmp_path, changed_ids={"a", "node_3"})
    T2, changed = tdet.load_detailed_mutations(ckpt)
    assert changed == {"a", "node_3"}
    assert _tree_signature(T) == _tree_signature(T2)
    assert T.condensed_nodes == T2.condensed_nodes
    assert write_newick(T, print_internal=True, print_branch_len=True) == \
        write_newick(T2, print_internal=True, print_branch_len=True)


def test_parsimony_preserved(small_mat, tmp_path):
    T = load_mat_pb(small_mat)
    ckpt = str(tmp_path / "ck2.detailed")
    tdet.save_detailed_mutations(T, ckpt)
    _same_as_jax(small_mat, ckpt, tmp_path)
    T2, _ = tdet.load_detailed_mutations(ckpt)
    assert T.get_parsimony_score() == T2.get_parsimony_score()
    J2, _ = jdet.load_detailed_mutations(ckpt)
    assert J2.get_parsimony_score() == T2.get_parsimony_score()


def test_sniffer(small_mat, tmp_path):
    T = load_mat_pb(small_mat)
    ckpt = str(tmp_path / "ck3.detailed")
    tdet.save_detailed_mutations(T, ckpt)
    assert tdet.is_detailed_checkpoint(ckpt)
    assert not tdet.is_detailed_checkpoint(small_mat)
    assert not tdet.is_detailed_checkpoint(str(tmp_path / "missing"))


def test_matoptimize_resume_from_detailed(small_mat, tmp_path):
    """-a from a detailed checkpoint (its change flags seed the first
    iteration's sources): the JAX CLI's output pb."""
    from usher_tpu.cli.matoptimize_cli import main as jax_opt
    from usher_tpu_torch.cli.matoptimize_cli import main as opt_main
    T = load_mat_pb(small_mat)
    ckpt = str(tmp_path / "ck4.detailed")
    tdet.save_detailed_mutations(T, ckpt, changed_ids={"a"})
    out, jout = str(tmp_path / "opt.pb"), str(tmp_path / "jopt.pb")
    assert opt_main(["-a", ckpt, "-o", out, "-N", "2", "-r", "2"]) == 0
    assert jax_opt(["-a", ckpt, "-o", jout, "-N", "2", "-r", "2",
                    "--mesh-devices", "0"]) == 0
    T2 = load_mat_pb(out)
    assert T2.get_parsimony_score() <= T.get_parsimony_score()
    with open(out, "rb") as a, open(jout, "rb") as b:
        assert a.read() == b.read()


def test_multiblock_stream(tmp_path, monkeypatch):
    """Force multiple compressed blocks to exercise the parallel loader."""
    monkeypatch.setattr(tdet, "BLOCK_SIZE", 256)
    monkeypatch.setattr(jdet, "BLOCK_SIZE", 256)
    T = Tree()
    root = T.create_node("root", None, 0.0)
    for i in range(200):
        n = T.create_node(f"leaf_{i}", root, 1.0)
        n.mutations.append(Mutation(chrom="c", position=i + 1, ref_nuc=1,
                                    par_nuc=1, mut_nuc=8))
    ckpt = str(tmp_path / "multi.detailed")
    tdet.save_detailed_mutations(T, ckpt)
    T2, _ = tdet.load_detailed_mutations(ckpt)
    assert _tree_signature(T) == _tree_signature(T2)
    J2, _ = jdet.load_detailed_mutations(ckpt)
    jck = str(tmp_path / "multi_jax.detailed")
    jdet.save_detailed_mutations(J2, jck)
    with open(ckpt, "rb") as a, open(jck, "rb") as b:
        assert a.read() == b.read()


def test_roundtrip_with_annotations_and_condensed(small_mat, tmp_path):
    T = load_mat_pb(small_mat)
    J = jload(small_mat)
    for i, (n, m) in enumerate(zip(T.depth_first_expansion(),
                                   J.depth_first_expansion())):
        n.clade_annotations = [f"clade{i % 3}", ""] if i % 2 else []
        m.clade_annotations = list(n.clade_annotations)
    ckpt, jck = str(tmp_path / "ann.detailed"), str(tmp_path / "jann")
    tdet.save_detailed_mutations(T, ckpt)
    jdet.save_detailed_mutations(J, jck)
    with open(ckpt, "rb") as a, open(jck, "rb") as b:
        assert a.read() == b.read()
    T2, _ = tdet.load_detailed_mutations(ckpt)
    assert _tree_signature(T) == _tree_signature(T2)
