"""The port's matOptimize CLI (usher_tpu_torch/cli/matoptimize_cli.py) end
to end on the CPU (USHER_TPU_PLATFORM=cpu), against the JAX CLI.

Every output file the port writes is byte-equal to the JAX CLI's for the
same arguments: on the fixture MAT with the dense, `--spr-backend big`,
`--stream-states` and `--mesh-devices 8` scorers (where parsimony must go
from 500 to at most 494), and on a random MAT under -E (the newick and
`epps_dump`), -S, -b with drift, -z/-y, the blacklist, both check
variables, radius doubling, a checkpoint (-s) and a resume from it, and
for every input mode: -i, -t -v, -a (plain pb), -i -V and -t -D -R.
`--distributed` raises.
"""

import os

import pytest

from usher_tpu.cli.matoptimize_cli import main as jax_opt
from usher_tpu.cli.usher_cli import main as jax_usher
from usher_tpu.io.pbio import save_mat_pb as jsave
from usher_tpu_torch.cli.matoptimize_cli import main as torch_opt
from usher_tpu_torch.io.pbio import load_mat_pb

from conftest import REFERENCE_TEST_DIR
from test_torch_fitch import random_opt_tree

GLOBAL_NH = os.path.join(REFERENCE_TEST_DIR, "global_phylo.nh")
GLOBAL_VCF = os.path.join(REFERENCE_TEST_DIR, "global_samples.vcf")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("USHER_TPU_PLATFORM", "cpu")


@pytest.fixture(scope="module")
def fixture_pb(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("opt_fixture"))
    pb = os.path.join(out, "smoke.pb")
    assert jax_usher(["-t", GLOBAL_NH, "-v", GLOBAL_VCF, "-o", pb,
                      "-d", out]) == 0
    return pb


@pytest.fixture(scope="module")
def random_pb(tmp_path_factory):
    pb = str(tmp_path_factory.mktemp("opt_random") / "random.pb")
    jsave(random_opt_tree(21, n=110, hi=150), pb)
    return pb


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _both(tmp_path, args, jax_extra=("--mesh-devices", "0"), outs=("o.pb",)):
    """Run the JAX CLI and the port's with ``args`` (``{d}`` is each run's
    own directory) and return each side's output files by name."""
    got = {}
    for side, main, extra in (("jax", jax_opt, list(jax_extra)),
                              ("torch", torch_opt, [])):
        d = tmp_path / side
        d.mkdir()
        argv = [a.format(d=d) for a in args] + extra
        assert main(argv) == 0, side
        got[side] = {name: _read(d / name) for name in outs}
    return got["jax"], got["torch"]


@pytest.mark.parametrize("mode", ["dense", "big", "stream", "mesh8"])
def test_fixture_modes_match_jax(fixture_pb, tmp_path, mode):
    extra = {"dense": [], "big": ["--spr-backend", "big"],
             "stream": ["--stream-states"],
             "mesh8": ["--mesh-devices", "8"]}[mode]
    want, got = _both(tmp_path, ["-i", fixture_pb, "-o", "{d}/o.pb", "-N",
                                 "2", "-r", "4"] + extra,
                      jax_extra=() if mode == "mesh8"
                      else ("--mesh-devices", "0"))
    assert got == want
    assert load_mat_pb(fixture_pb).get_parsimony_score() == 500
    assert load_mat_pb(str(tmp_path / "torch" / "o.pb")
                       ).get_parsimony_score() <= 494


@pytest.mark.parametrize("flags,outs,env", [
    (["-r", "3", "-N", "3"], (), {}),
    (["-N", "4"], (), {}),                                # radius doubling
    (["-r", "3", "-S", "{d}/src.log"], ("src.log",), {}),
    (["-r", "3", "-d", "2", "-m", "0.5", "-b", "{d}/drift_"],
     ("drift_1.nwk", "drift_2.nwk"), {}),
    (["-r", "3", "-z", "0.4", "-y", "7"], (), {}),
    (["-r", "3", "--no-reduce-back-mutations"], (), {}),
    (["-r", "3", "--spr-backend", "big"], (), {}),
    (["-r", "3", "--stream-states"], (), {}),
    (["-r", "3"], (), {"USHER_TPU_CHECK_STATE_REASSIGN": "1"}),
    (["-r", "3", "--stream-states"], (),
     {"USHER_TPU_CHECK_STATE_REASSIGN": "1", "USHER_TPU_CHECK_CSR": "1"}),
], ids=["plain", "doubling", "src_log", "drift", "sampling", "no_min_back",
        "big", "stream", "check_reassign", "check_stream_csr"])
def test_random_mat_flags_match_jax(random_pb, tmp_path, monkeypatch, flags,
                                    outs, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want, got = _both(tmp_path, ["-i", random_pb, "-o", "{d}/o.pb"] + flags,
                      outs=("o.pb",) + outs)
    assert got == want


def test_blacklist_matches_jax(random_pb, tmp_path):
    T = load_mat_pb(random_pb)
    black = tmp_path / "black.txt"
    black.write_text("\n".join(n.identifier for n in
                               T.breadth_first_expansion()[1:40:2]) + "\n")
    want, got = _both(tmp_path, ["-i", random_pb, "-o", "{d}/o.pb", "-r",
                                 "3", "--black_list_node_file", str(black)])
    assert got == want


def test_epps_match_jax(random_pb, tmp_path):
    """-E: the EPP newick and the epps_dump beside it."""
    want, got = _both(tmp_path, ["-i", random_pb, "-o", "{d}/x.pb", "-E",
                                 "{d}/epp.nwk", "-r", "4"],
                      outs=("epp.nwk", "epps_dump"))
    assert got == want
    assert got["epps_dump"]


def test_checkpoint_and_resume_match_jax(random_pb, tmp_path):
    """-s writes the detailed checkpoint every iteration here (a tiny
    interval); resuming from it with -a gives JAX's pb."""
    want, got = _both(tmp_path, ["-i", random_pb, "-o", "{d}/o.pb", "-r",
                                 "3", "-N", "2", "-s", "0.000001"],
                      outs=("o.pb", "o.pb.intermediate"))
    assert got == want
    ck = str(tmp_path / "torch" / "o.pb.intermediate")
    (tmp_path / "resume").mkdir()
    want, got = _both(tmp_path / "resume", ["-a", ck, "-o", "{d}/o.pb",
                                            "-r", "3"])
    assert got == want


def test_input_modes_match_jax(random_pb, tmp_path):
    """-t -v (Sankoff on the CPU), -a with a plain pb, and -i -V (ambiguous
    leaf bases restored from a transposed VCF)."""
    from usher_tpu_torch.core.flat import collect_positions
    from usher_tpu_torch.io import transpose
    runs = {"tv": ["-t", GLOBAL_NH, "-v", GLOBAL_VCF, "-N", "1", "-r", "2"],
            "a": ["-a", random_pb, "-r", "3"]}
    T = load_mat_pb(random_pb)
    positions, _, _ = collect_positions(T)
    tv = str(tmp_path / "g.tvcf")
    leaves = T.get_leaves()
    transpose.encode([(leaves[0].identifier, [(int(positions[0]), 0x5)],
                       []),
                      (leaves[3].identifier, [(int(positions[2]), 0xF)],
                       [(int(positions[4]), int(positions[6]))])], tv)
    runs["V"] = ["-i", random_pb, "-V", tv, "-r", "3"]
    for name, args in runs.items():
        (tmp_path / name).mkdir()
        want, got = _both(tmp_path / name, args + ["-o", "{d}/o.pb"])
        assert got == want, name


def test_diff_input_matches_jax(tmp_path):
    """-t -D -R: genotypes from a MAPLE diff (mirror of
    test_matoptimize_diff_input), and the two missing-argument errors."""
    ref_fa = tmp_path / "ref.fa"
    ref_fa.write_text(">chr\n" + "A" * 30 + "\n")
    nh = tmp_path / "t.nh"
    nh.write_text("((L1,L2),(L3,L4));\n")
    diff = tmp_path / "s.diff"
    diff.write_text(">L1\nc\t5\n>L2\nc\t5\n>L3\nt\t9\nn\t12\t3\n>L4\n")
    want, got = _both(tmp_path, ["-t", str(nh), "-D", str(diff), "-R",
                                 str(ref_fa), "-o", "{d}/o.pb", "-r", "4"])
    assert got == want
    assert load_mat_pb(str(tmp_path / "torch" / "o.pb")
                       ).get_parsimony_score() == 2
    out = str(tmp_path / "x.pb")
    assert torch_opt(["-t", str(nh), "-D", str(diff), "-o", out]) == 1
    assert torch_opt(["-D", str(diff), "-R", str(ref_fa), "-o", out]) == 1
    assert torch_opt(["-o", out]) == 1


def test_distributed_raises(random_pb, tmp_path, monkeypatch):
    with pytest.raises(NotImplementedError, match="A11"):
        torch_opt(["-i", random_pb, "-o", str(tmp_path / "o.pb"),
                   "--distributed"])
    monkeypatch.setenv("USHER_TPU_DISTRIBUTED", "1")
    with pytest.raises(NotImplementedError, match="A11"):
        torch_opt(["-i", random_pb, "-o", str(tmp_path / "o.pb")])


def test_optimize_global_tree_matches_jax():
    """Mirror of test_optimize_global_tree_monotone through the library:
    the same final tree and score as JAX, never above the start, and
    every leaf genotype kept."""
    from usher_tpu.io.newick import parse_newick as jparse
    from usher_tpu.io.newick import write_newick as jnwk
    from usher_tpu.io.vcf import read_vcf_sites as jsites
    from usher_tpu.ops.sankoff import assign_states_from_vcf as jassign
    from usher_tpu.optimize import OptimizeOptions as JOpts
    from usher_tpu.optimize import optimize_tree as joptimize
    from usher_tpu_torch.core.flat import collect_positions
    from usher_tpu_torch.io.newick import parse_newick, write_newick
    from usher_tpu_torch.io.vcf import read_vcf_sites
    from usher_tpu_torch.ops.sankoff import assign_states_from_vcf
    from usher_tpu_torch.optimize import OptimizeOptions, optimize_tree
    from test_optimize import leaf_genotypes
    P = parse_newick(GLOBAL_NH)
    assign_states_from_vcf(P, read_vcf_sites(GLOBAL_VCF), "cpu")
    T = jparse(GLOBAL_NH)
    jassign(T, jsites(GLOBAL_VCF))
    positions, _, _ = collect_positions(P)
    before = leaf_genotypes(P, positions)
    score0 = P.get_parsimony_score()
    final = optimize_tree(P, OptimizeOptions(radius=4, max_iterations=3,
                                             source_chunk=256), "cpu")
    assert final == joptimize(T, JOpts(radius=4, max_iterations=3,
                                       source_chunk=256))
    assert final <= score0 and final == P.get_parsimony_score()
    assert write_newick(P, print_internal=True, print_branch_len=True) == \
        jnwk(T, print_internal=True, print_branch_len=True)
    positions2, ref2, _ = collect_positions(P)
    after = leaf_genotypes(P, positions2)
    pos_ref = {int(p): int(r) for p, r in zip(positions2, ref2)}
    assert set(before) == set(after)
    for name, g0 in before.items():
        for p in set(g0) | set(after[name]):
            m0 = g0.get(p, pos_ref.get(p, 0)) or 0xF
            m1 = after[name].get(p, pos_ref.get(p, 0)) or 0xF
            assert m0 & m1, f"{name}@{p}"
