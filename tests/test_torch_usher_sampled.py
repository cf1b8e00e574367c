"""The port's usher-sampled CLI (usher_tpu_torch/cli/usher_sampled_cli.py)
end to end on the CPU (USHER_TPU_PLATFORM=cpu), against the JAX CLI.

The seven tests of tests/test_usher_sampled.py, each also holding every
file the port writes byte-equal to the JAX CLI's for the same arguments,
then the rest of the flag surface: sorts, -e/-E, -u, -c, -n, -D clades,
--first_n_samples, --no-ignore-prefix, --mesh-devices 8 (eight shards as
CPU tensors), a final optimization round, and an input whose new samples
outnumber one chunk (batch_size_per_process * 64), so that the interleaved
optimization really runs between two chunks ("Cumulative parsimony
increase" on stderr).  Tolerance: none (byte-equal files).
"""

import os

import pytest

from usher_tpu.cli.usher_cli import main as jax_usher
from usher_tpu.cli.usher_sampled_cli import main as jax_sampled
from usher_tpu.io.newick import parse_newick as jparse, write_newick as jnwk
from usher_tpu.io.pbio import load_mat_pb as jload, save_mat_pb as jsave
from usher_tpu_torch.cli.usher_sampled_cli import main as torch_sampled
from usher_tpu_torch.io.pbio import load_mat_pb
from usher_tpu_torch.io.vcf import read_vcf_sites

from conftest import REFERENCE_TEST_DIR, REFERENCE_SCRIPTS_DIR

GLOBAL_NH = os.path.join(REFERENCE_TEST_DIR, "global_phylo.nh")
GLOBAL_VCF = os.path.join(REFERENCE_TEST_DIR, "global_samples.vcf")
NEW_VCF = os.path.join(REFERENCE_TEST_DIR, "new_samples.vcf")
REF_FA = os.path.join(REFERENCE_TEST_DIR, "NC_045512v2.fa")
SMALL_NWK = os.path.join(REFERENCE_SCRIPTS_DIR, "testBranchLen2.nwk")
SMALL_VCF = os.path.join(REFERENCE_SCRIPTS_DIR, "testBranchLen2.vcf")
TWO_SAMPLE_VCF = (
    "##fileformat=VCFv4.2\n"
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tGT\tz1\tz2\n"
    "x\t1\t.\tA\tT\t.\t.\t.\t.\t1\t0\n"
    "x\t6\t.\tA\tT\t.\t.\t.\t.\t1\t1\n")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("USHER_TPU_PLATFORM", "cpu")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The fixture MAT as a pb (JAX usher CLI), and a copy with clade
    annotations on a few internal nodes."""
    outdir = str(tmp_path_factory.mktemp("sampled_build"))
    pb = os.path.join(outdir, "out.pb")
    assert jax_usher(["-t", GLOBAL_NH, "-v", GLOBAL_VCF, "-o", pb, "-d",
                      outdir, "--mesh-devices", "0"]) == 0
    T = jload(pb)
    for i, nd in enumerate(T.breadth_first_expansion()):
        named = not nd.is_leaf() and i % 7 == 1
        nd.clade_annotations = ([f"A.{i}", f"B.{i % 3}"] if named
                                else ["", ""])
    annotated = os.path.join(outdir, "annotated.pb")
    jsave(T, annotated)
    return pb, annotated


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """testBranchLen2 as a pb, and a two-sample VCF for it."""
    build = str(tmp_path_factory.mktemp("sampled_small"))
    pb = os.path.join(build, "o.pb")
    assert jax_usher(["-t", SMALL_NWK, "-v", SMALL_VCF, "-o", pb, "-d",
                      build, "--mesh-devices", "0"]) == 0
    vcf = os.path.join(build, "new.vcf")
    with open(vcf, "w") as f:
        f.write(TWO_SAMPLE_VCF)
    return pb, vcf


@pytest.fixture(scope="module")
def pruned_nh(tmp_path_factory):
    """The fixture newick with every fifth leaf pruned (85 of 422): built
    with global_samples.vcf, those samples are new and outnumber a chunk of
    64 (--batch_size_per_process 1)."""
    T = jparse(GLOBAL_NH)
    for leaf in T.get_leaves()[::5]:
        T.remove_node(leaf.identifier, True)
    T.remove_single_child_nodes()
    path = str(tmp_path_factory.mktemp("sampled_pruned") / "pruned.nh")
    with open(path, "w") as f:
        f.write(jnwk(T, print_branch_len=True) + "\n")
    return path


def _files(d):
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


def _both(tmp_path, args, capfd=None):
    """Run the JAX CLI and the port's with ``args`` (``{d}`` is each run's
    own output directory) and return each side's files by name, and with
    `capfd` each side's stderr."""
    got, err = {}, {}
    for side, main in (("jax", jax_sampled), ("torch", torch_sampled)):
        d = tmp_path / side
        d.mkdir()
        assert main([a.format(d=d) for a in args]) == 0, side
        got[side] = _files(d)
        if capfd is not None:
            err[side] = capfd.readouterr().err
    assert got["torch"] and got["torch"] == got["jax"]
    return got["torch"], err


def reconstruct_leaf_states(T):
    out = {}
    stack = [(T.root, {})]
    while stack:
        node, state = stack.pop()
        if node.mutations:
            state = dict(state)
            for m in node.mutations:
                state[m.position] = m.mut_nuc
        if node.is_leaf():
            out[node.identifier] = state
        for ch in node.children:
            stack.append((ch, state))
    return out


# --- the seven tests of tests/test_usher_sampled.py ---------------------------

def test_sampled_vcf_placement(built, tmp_path):
    files, _ = _both(tmp_path, ["-i", built[0], "-v", NEW_VCF, "-o",
                                "{d}/out2.pb", "-d", "{d}/out", "-B"])
    assert len(files["out/placement_stats.tsv"].decode().strip()
               .splitlines()) == 5
    T = load_mat_pb(str(tmp_path / "torch" / "out2.pb"))
    T.uncondense_leaves()
    recon = reconstruct_leaf_states(T)
    vcf = read_vcf_sites(NEW_VCF)
    for site in vcf.sites:
        variant_by_col = {j: n for j, n in site.variants}
        for j, name in enumerate(vcf.sample_ids):
            assert name in recon
            mask = variant_by_col.get(j, site.ref_nuc)
            got = recon[name].get(site.position, site.ref_nuc)
            assert got & mask


def test_sampled_diff_placement(built, tmp_path):
    vcf = read_vcf_sites(NEW_VCF)
    from usher_tpu_torch.core.nuc import char_from_nuc_id
    lines = []
    for j, name in enumerate(vcf.sample_ids):
        lines.append(f">{name}")
        for site in vcf.sites:
            v = dict(site.variants).get(j)
            if v is not None and v != site.ref_nuc:
                if v == 0xF:
                    lines.append(f"n\t{site.position}")
                else:
                    lines.append(f"{char_from_nuc_id(v)}\t{site.position}")
    diff_path = tmp_path / "new.diff"
    diff_path.write_text("\n".join(lines) + "\n")
    _both(tmp_path, ["-i", built[0], "--diff", str(diff_path), "--ref",
                     REF_FA, "-o", "{d}/outd.pb", "-d", "{d}/outd"])
    T = load_mat_pb(str(tmp_path / "torch" / "outd.pb"))
    T.uncondense_leaves()
    for name in vcf.sample_ids:
        assert T.get_node(name) is not None


def test_sampled_interleaved_optimization(built, tmp_path):
    """The JAX test's arguments (its 5 samples fit one chunk, so the
    threshold is never tested with samples pending; the pruned input below
    reaches the optimization)."""
    _both(tmp_path, ["-i", built[0], "-v", NEW_VCF, "-o", "{d}/o.pb", "-d",
                     "{d}/out", "--parsimony_threshold", "1",
                     "--batch_size_per_process", "1",
                     "--optimization_radius", "2",
                     "--optimization_minutes", "1"])
    T = load_mat_pb(str(tmp_path / "torch" / "o.pb"))
    T.uncondense_leaves()
    for name in read_vcf_sites(NEW_VCF).sample_ids:
        assert T.get_node(name) is not None


def test_min_back_reduces_back_mutations():
    """min_back FS (the port's FitchEngine) does not increase parsimony, adds
    no back mutation against plain FS, and gives the JAX package's scores
    and counts."""
    from usher_tpu.core.flat import collect_positions as jcollect
    from usher_tpu.ops.sankoff import assign_states_from_vcf
    from usher_tpu.optimize import fitch as jfitch
    from usher_tpu_torch.core.flat import collect_positions
    from usher_tpu_torch.optimize.fitch import (FitchEngine,
                                                leaf_masks_from_tree)
    from usher_tpu.io.vcf import read_vcf_sites as jread
    from test_torch_hostlayers import port_tree

    J = jparse(GLOBAL_NH)
    assign_states_from_vcf(J, jread(GLOBAL_VCF))
    T = port_tree(J)

    def back_count(tree):
        return sum(m.mut_nuc == m.ref_nuc
                   for node in tree.depth_first_expansion()
                   for m in node.mutations)

    def run(tree, engine_cls, masks, positions, chrom, **kw):
        fe = engine_cls(tree, positions, **kw)
        lm, ref_row = masks(tree, positions, fe.bfs)
        plain = fe.rewrite_mutations(fe.run(lm, ref_row)[0], lm, ref_row,
                                     chrom)
        plain_back = back_count(tree)
        mb = fe.rewrite_mutations(fe.run(lm, ref_row, min_back=True)[0], lm,
                                  ref_row, chrom)
        return plain, plain_back, mb, back_count(tree)

    positions, _, chrom = collect_positions(T)
    got = run(T, FitchEngine, leaf_masks_from_tree, positions, chrom,
              device="cpu")
    jpositions, _, jchrom = jcollect(J)
    want = run(J, jfitch.FitchEngine, jfitch.leaf_masks_from_tree,
               jpositions, jchrom)
    assert got == want
    plain, plain_back, mb, mb_back = got
    assert mb == plain
    assert mb_back <= plain_back


def test_sampled_subtrees_and_sort3(small, tmp_path):
    """-A sort, -K single subtree on the sampled CLI."""
    files, _ = _both(tmp_path, ["-i", small[0], "-v", small[1], "-d",
                                "{d}/o", "-A", "-K", "4"])
    assert "o/single-subtree.nh" in files
    assert "o/placement_stats.tsv" in files


def test_sampled_multiple_placements(small, tmp_path):
    """-M > 1 routes through the multi-tree placer (per-tree outputs)."""
    vcf = tmp_path / "tie.vcf"
    vcf.write_text(
        "##fileformat=VCFv4.2\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tGT\tz1\n"
        "x\t1\t.\tA\tT\t.\t.\t.\t.\t1\n"
        "x\t2\t.\tA\tT\t.\t.\t.\t.\t1\n")
    files, _ = _both(tmp_path, ["-i", small[0], "-v", str(vcf), "-d",
                                "{d}/o", "-M", "4"])
    assert any(f.startswith("o/final-tree") for f in files)


def test_sampled_bigmat_engine(small, tmp_path):
    """usher-sampled --bigmat places through the CSR engine, as the dense
    engine does and as the JAX CLI does."""
    runs = {}
    for mode, extra in (("dense", []), ("big", ["--bigmat"])):
        (tmp_path / mode).mkdir()
        runs[mode], _ = _both(tmp_path / mode, ["-i", small[0], "-v",
                                                small[1], "-d", "{d}"] + extra)
    for name in ("placement_stats.tsv", "final-tree.nh"):
        assert runs["dense"][name] == runs["big"][name]


# --- the rest of the flag surface ---------------------------------------------

@pytest.mark.parametrize("flags", [
    ["-s", "-r"], ["-S"], ["-e", "1", "-E", "3"], ["-u", "-k", "10"],
    ["-c"], ["-n"], ["--first_n_samples", "3", "-l"],
    ["--no-ignore-prefix", "dup_"], ["-M", "2"], ["--bigmat", "-B"],
    ["--mesh-devices", "8", "-s"], ["--bigmat", "--mesh-devices", "8"]],
    ids=["sort1_reverse", "sort2", "uncertainty_limits", "uncondensed_k",
         "collapse", "no_add", "first_n", "dup_prefix", "multi2",
         "bigmat_min_back", "mesh8", "bigmat_mesh8"])
def test_flags_match_jax(built, tmp_path, flags):
    vcf = NEW_VCF
    if "--no-ignore-prefix" in flags:
        # three samples already in the tree, forced in under the prefix
        vcf = str(tmp_path / "dups.vcf")
        with open(GLOBAL_VCF) as f, open(vcf, "w") as out:
            for line in f:
                if not line.startswith("##"):
                    line = "\t".join(line.rstrip("\n").split("\t")[:12]) + "\n"
                out.write(line)
    _both(tmp_path, ["-i", built[0], "-v", vcf, "-o", "{d}/o.pb", "-d",
                     "{d}/out"] + flags)


def test_clades_match_jax(built, tmp_path):
    files, _ = _both(tmp_path, ["-i", built[1], "-v", NEW_VCF, "-d",
                                "{d}/out", "-D"])
    assert files["out/clades.txt"].count(b"\n") == 5


def test_interleaved_optimization_is_reached(tmp_path, pruned_nh, capfd):
    """85 new samples in chunks of 64: the first chunk's parsimony passes
    the threshold with samples pending, so _optimize runs between the
    chunks, on both sides, and again as the final round; the files stay
    equal."""
    files, err = _both(tmp_path, ["-t", pruned_nh, "-v", GLOBAL_VCF, "-o",
                                  "{d}/o.pb", "-d", "{d}/out",
                                  "--batch_size_per_process", "1",
                                  "--parsimony_threshold", "1",
                                  "--optimization_radius", "2",
                                  "--optimization_minutes", "1",
                                  "--last_optimization_minutes", "1"], capfd)
    for side in ("jax", "torch"):
        assert err[side].count("Cumulative parsimony increase") == 1, side
        assert "Found 85 missing samples." in err[side]
        assert err[side].count("Final parsimony score") == 2, side
    assert files["out/placement_stats.tsv"].count(b"\n") == 85
