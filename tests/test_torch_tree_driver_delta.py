"""The Tree driver's batch delta (usher_tpu_torch/placement/driver.py::
BatchDelta), on the CPU (USHER_TPU_PLATFORM=cpu).

A batch is scored once; a sample whose snapshot result went stale after
earlier applies in the batch is corrected from the snapshot's rows and the
host scores of the nodes the batch changed, and tie sets are ordered and
resolved on the current tree by (depth, child-index path) keys and a tally
of leaf counts.  The oracle: at every correction and every tie-break
refresh, a whole-tree re-score of the current tree (`score_samples` of the
one sample) gives the same best score, tie count, winner (the same node),
has_unique, and tie set with its has_unique flags in the same order.  On
the Quick Start fixture (batch 5), on a generated tree with the benchmark's
ladder clades (`benchmark/gen`), and on a hand-built tree whose split node
was a sample's unique best (so its best score rises), each with the dense
and the sparse backend of PlacementEngine and with BigPlacementEngine.
The (depth, child-index path) order equals `breadth_first_expansion`'s and
the leaf tally a recount after random child and sibling placements; the
log line's node counts equal the BFS length at each sample and the JAX
package's lines; and a batch is scored once (one score_samples call, one
order_arrays), corrections included.  Tolerance: none.
"""

import os
import re
import sys

import numpy as np
import pytest

from usher_tpu.cli.usher_cli import main as jax_main
from usher_tpu_torch.cli.usher_cli import main as torch_main
from usher_tpu_torch.core.tree import MissingSample, Mutation, Tree
from usher_tpu_torch.placement import driver as drv
from usher_tpu_torch.placement.big_engine import BigPlacementEngine

from conftest import REFERENCE_TEST_DIR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.gen import mat as gmat  # noqa: E402
from benchmark.gen import pbwrite, samples as gsamples  # noqa: E402

GLOBAL_NH = os.path.join(REFERENCE_TEST_DIR, "global_phylo.nh")
GLOBAL_VCF = os.path.join(REFERENCE_TEST_DIR, "global_samples.vcf")
NEW_VCF = os.path.join(REFERENCE_TEST_DIR, "new_samples.vcf")
MIX = {"clade_ladder": [1, 2, 2, 3, 3], "private_substitutions": [1],
       "n_calls": [1]}
ENGINES = ["dense", "sparse", "bigmat"]
SIZE_LINE = re.compile(r"Current tree size \(#nodes\): (\d+)\tSample name: "
                       r"(\S+)\t")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("USHER_TPU_PLATFORM", "cpu")


@pytest.fixture(scope="module")
def fixture_pb(tmp_path_factory):
    """The Quick Start fixture's MAT as a pb (the port's CLI builds it)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USHER_TPU_PLATFORM", "cpu")
        outdir = str(tmp_path_factory.mktemp("delta_build"))
        pb = os.path.join(outdir, "out.pb")
        assert torch_main(["-t", GLOBAL_NH, "-v", GLOBAL_VCF, "-o", pb,
                           "-d", outdir]) == 0
    return pb


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """A generated tree of 2,000 nodes over 1,000 sites and 40 samples in
    clades of 5 on the ladder 1, 2, 2, 3, 3, as a pb and a VCF."""
    d = tmp_path_factory.mktemp("delta_gen")
    rng = np.random.default_rng(np.random.SeedSequence([2207, 1]))
    mat = gmat.generate(rng, 2000, 1000, [190, 151, 79, 32, 14, 4, 2, 1])
    pb = str(d / "tree.pb")
    pbwrite.write_pb(mat, pb)
    job = gsamples.draw_job(np.random.default_rng(
        np.random.SeedSequence([2207, 3])), mat, MIX, 40, "g")
    vcf = str(d / "unit.vcf")
    gsamples.write_vcf(vcf, job, mat)
    return pb, vcf


def _engine_flags(engine, monkeypatch):
    if engine == "sparse":
        monkeypatch.setattr(drv.PlacementEngine, "_resolve_backend",
                            lambda self: "sparse")
    return ["--bigmat"] if engine == "bigmat" else []


class Oracle:
    """Checks every correction and tie-break refresh of BatchDelta against
    a whole-tree re-score of the current tree, and records which cases
    the corrections met."""

    def __init__(self, monkeypatch):
        self.engine = None
        self.batch = {}
        self.scored = {}
        self.corrections = 0
        self.refreshes = 0
        self.cases = set()
        for cls in (drv.PlacementEngine, BigPlacementEngine):
            monkeypatch.setattr(cls, "score_samples",
                                self._spy(cls.score_samples))
        correct, refresh = drv.BatchDelta.correct, \
            drv.BatchDelta.refresh_winner
        oracle = self

        def correct_checked(delta, res, check_nodes, checks):
            out = correct(delta, res, check_nodes, checks)
            truth = oracle._rescore(res)
            oracle._same(out, truth)
            oracle.corrections += 1
            oracle._classify(res, out, check_nodes)
            return out

        def refresh_checked(delta, res):
            refresh(delta, res)
            if res.snapshot is not None:      # not a correction's own call
                oracle._same(res, oracle._rescore(res))
                oracle.refreshes += 1

        monkeypatch.setattr(drv.BatchDelta, "correct", correct_checked)
        monkeypatch.setattr(drv.BatchDelta, "refresh_winner",
                            refresh_checked)

    def _spy(self, score_samples):
        def spied(engine, muts, *a, **k):
            out = score_samples(engine, muts, *a, **k)
            if out and out[0].snapshot is not None:
                self.engine = engine
                key = id(out[0].snapshot)
                self.batch[key] = list(muts)
                self.scored[key] = {
                    id(n) for n in engine.flat.tree.breadth_first_expansion()}
            return out
        return spied

    def _rescore(self, res):
        muts = self.batch[id(res.snapshot)][res.row]
        return self.engine.score_samples([muts])[0]

    @staticmethod
    def _same(got, want):
        assert got.best_score == want.best_score
        assert got.num_best == want.num_best
        assert got.best_node is want.best_node
        assert got.best_has_unique == want.best_has_unique
        assert len(got.tied_nodes) == len(want.tied_nodes)
        assert all(a is b for a, b in zip(got.tied_nodes, want.tied_nodes))
        assert got.tied_has_unique == want.tied_has_unique

    def _classify(self, snap_res, out, check_nodes):
        """best_rises: the snapshot's unique best was changed and the best
        score rose; old_new_tie: the tie set holds a node the batch left
        alone and one it created; changed_node_tied: it holds a node of
        check_nodes."""
        changed = {id(n) for n in check_nodes}
        scored = self.scored[id(snap_res.snapshot)]
        tied = [id(n) for n in out.tied_nodes]
        if (out.best_score > snap_res.best_score and snap_res.num_best == 1
                and id(snap_res.best_node) in changed):
            self.cases.add("best_rises")
        if (any(t in scored and t not in changed for t in tied)
                and any(t not in scored for t in tied)):
            self.cases.add("old_new_tie")
        if any(t in changed for t in tied):
            self.cases.add("changed_node_tied")


def _split_tree():
    """root -> P (1 C) -> {L (2 G, 3 T), Q (4 C)}; root -> R6 (6 T),
    R7 (7 T), R28 (2 G, 8 T).  Sample a (1 C, 2 G, 6 T) has the unique best
    L and splits it; sample b (1 C, 3 T, 7 T) had the unique best L too
    (score 1), which after the split costs 2, tied with P and R7.  Sample c
    (1 C, 2 G, 8 T) tied L with R28 (score 1); after the split it ties the
    new internal node with R28."""
    A, C, G, T_ = 1, 2, 4, 8
    T = Tree()
    root = T.create_node("root")
    for name, parent, muts in (("P", "root", [(1, C)]),
                               ("L", "P", [(2, G), (3, T_)]),
                               ("Q", "P", [(4, C)]),
                               ("R6", "root", [(6, T_)]),
                               ("R7", "root", [(7, T_)]),
                               ("R28", "root", [(2, G), (8, T_)])):
        n = T.create_node(name, parent)
        for pos, nuc in muts:
            n.add_mutation(Mutation("c", pos, A, A, nuc))
    assert root is T.root
    samples = []
    for name, muts in (("a", [(1, C), (2, G), (6, T_)]),
                       ("b", [(1, C), (3, T_), (7, T_)]),
                       ("c", [(1, C), (2, G), (8, T_)])):
        s = MissingSample(name)
        s.mutations = [Mutation("c", pos, A, A, nuc) for pos, nuc in muts]
        samples.append(s)
    return T, samples


def _run(data, engine, tmp_path, monkeypatch, fixture_pb, generated):
    flags = _engine_flags(engine, monkeypatch)
    out = str(tmp_path / "out")
    if data == "split":
        T, samples = _split_tree()
        opts = drv.UsherOptions(outdir=out, batch_size=3, mesh_devices=0,
                                use_bigmat=engine == "bigmat")
        return drv.run_usher(T, samples, opts)
    pb, vcf, batch = ((fixture_pb, NEW_VCF, "5") if data == "fixture"
                      else (*generated, "20"))
    return torch_main(["-i", pb, "-v", vcf, "-d", out, "--batch-size", batch,
                       "--mesh-devices", "0", *flags])


# the cases each data set's corrections must meet
CASES = {"fixture": {"changed_node_tied"},
         "generated": {"changed_node_tied"},
         "split": {"best_rises", "old_new_tie", "changed_node_tied"}}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("data", sorted(CASES))
def test_corrections_equal_a_whole_tree_rescore(data, engine, tmp_path,
                                                monkeypatch, fixture_pb,
                                                generated):
    oracle = Oracle(monkeypatch)
    assert _run(data, engine, tmp_path, monkeypatch, fixture_pb,
                generated) == 0
    assert oracle.corrections > 0
    assert CASES[data] <= oracle.cases, oracle.cases


def _recount(T):
    bfs = T.breadth_first_expansion()
    leaves = {}
    for n in reversed(bfs):
        leaves[id(n)] = (1 if n.is_leaf()
                         else sum(leaves[id(c)] for c in n.children))
    return bfs, leaves


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_bfs_key_and_leaf_tally_follow_placements(seed):
    """Random child and sibling placements on a generated topology: after
    each, refresh_winner orders random node sets as the BFS does and picks
    (max leaves, max BFS rank), and the tally and node count equal a
    recount."""
    rng = np.random.default_rng(seed)
    mat = gmat.generate(rng, 600, 200, [190, 151, 79, 32, 14, 4, 2, 1])
    T = Tree()
    for i, p in enumerate(mat["parent"].tolist()):
        T.create_node(f"n{i}", None if i == 0 else f"n{p}")
    bfs, leaves = _recount(T)
    row = {id(n): r for r, n in enumerate(bfs)}
    snap = drv.ScoreSnapshot(
        score=None, valid=None, has_unique=None, nodes=bfs,
        row_of=lambda n: row.get(id(n), -1),
        num_leaves=np.array([leaves[id(n)] for n in bfs], np.int32),
        num_nodes=len(bfs))
    delta = drv.BatchDelta(snap)
    splits = 0
    for k in range(60):
        nodes = list(T._all_nodes.values())
        target = nodes[int(rng.integers(len(nodes)))]
        if target.parent is not None and (target.is_leaf()
                                          or rng.random() < 0.5):
            nid = T.new_internal_node_id()
            T.create_node(nid, target.parent)
            sample = T.create_node(f"s{k}", nid)
            T.move_node(target.identifier, nid)
            delta.record_apply(sample, target)
            splits += 1
        else:
            sample = T.create_node(f"s{k}", target.identifier)
            delta.record_apply(sample)
        bfs, leaves = _recount(T)
        rank = {id(n): r for r, n in enumerate(bfs)}
        assert delta.num_nodes == len(bfs)
        assert all(delta.leaf_count(n) == leaves[id(n)] for n in bfs)
        pick = rng.choice(len(bfs), size=int(rng.integers(1, 40)),
                          replace=False)
        tied = [bfs[i] for i in pick]
        res = drv.SampleResult(best_score=0, num_best=len(tied),
                               best_node=None, best_has_unique=False,
                               tied_nodes=list(tied),
                               tied_has_unique=[bool(i % 2) for i in pick])
        delta.refresh_winner(res)
        want = sorted(tied, key=lambda n: rank[id(n)])
        assert all(a is b for a, b in zip(res.tied_nodes, want))
        hu = dict(zip(map(id, tied), (bool(i % 2) for i in pick)))
        assert res.tied_has_unique == [hu[id(n)] for n in want]
        assert res.best_node is max(
            want, key=lambda n: (leaves[id(n)], rank[id(n)]))
        assert res.best_has_unique == hu[id(res.best_node)]
    assert splits > 0


def _size_lines(err):
    return [(int(m.group(1)), m.group(2)) for m in SIZE_LINE.finditer(err)]


@pytest.mark.parametrize("engine", ["dense", "bigmat"])
@pytest.mark.parametrize("data", ["fixture", "generated"])
def test_log_line_counts_the_tree(data, engine, tmp_path, monkeypatch,
                                  capsys, fixture_pb, generated):
    """Each sample's `Current tree size (#nodes)` equals the BFS length of
    the tree it is placed on, sibling splits included; on the fixture the
    lines equal the JAX package's."""
    bfs_len = []
    for cls in (drv.PlacementEngine, BigPlacementEngine):
        apply = cls.apply_placement

        def spied(engine_, name, res, excess, _apply=apply):
            bfs_len.append(
                (len(engine_.flat.tree.breadth_first_expansion()), name))
            return _apply(engine_, name, res, excess)
        monkeypatch.setattr(cls, "apply_placement", spied)
    capsys.readouterr()
    assert _run(data, engine, tmp_path, monkeypatch, fixture_pb,
                generated) == 0
    lines = _size_lines(capsys.readouterr().err)
    assert lines == bfs_len and len(lines) > 1
    steps = {b[0] - a[0] for a, b in zip(lines, lines[1:])}
    assert 2 in steps                         # a sibling split among them
    if data == "fixture":
        flags = ["--bigmat"] if engine == "bigmat" else []
        assert jax_main(["-i", fixture_pb, "-v", NEW_VCF, "-d",
                         str(tmp_path / "jax"), "--batch-size", "5",
                         "--mesh-devices", "0", *flags]) == 0
        assert _size_lines(capsys.readouterr().err) == lines


@pytest.mark.parametrize("engine", ["dense", "bigmat"])
def test_one_scoring_pass_a_batch(engine, tmp_path, monkeypatch, fixture_pb):
    """Stale samples are corrected without scoring again: one
    score_samples call (and on the FlatMAT one order_arrays) a batch."""
    from usher_tpu_torch.core.flat import FlatMAT
    calls = {"score_samples": 0, "order_arrays": 0}

    def counted(cls, name):
        orig = getattr(cls, name)

        def spied(*a, **k):
            calls[name] += 1
            return orig(*a, **k)
        monkeypatch.setattr(cls, name, spied)
    counted(FlatMAT, "order_arrays")
    counted(BigPlacementEngine if engine == "bigmat" else drv.PlacementEngine,
            "score_samples")
    rescores = {"n": 0}
    correct = drv.BatchDelta.correct

    def counted_correct(*a):
        rescores["n"] += 1
        return correct(*a)
    monkeypatch.setattr(drv.BatchDelta, "correct", counted_correct)
    flags = ["--bigmat"] if engine == "bigmat" else []
    assert torch_main(["-i", fixture_pb, "-v", NEW_VCF, "-d",
                       str(tmp_path / "out"), "--batch-size", "2",
                       "--mesh-devices", "0", *flags]) == 0
    assert rescores["n"] > 0
    assert calls["score_samples"] == 3                  # 5 samples, batch 2
    assert calls["order_arrays"] == (0 if engine == "bigmat" else 3)
