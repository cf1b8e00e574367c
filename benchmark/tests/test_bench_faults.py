"""The comparison fails what it must: the control (the reference without
its host corrections) and the timed path broken underneath, once for each
fault a placement cell can have.  (The exchange between cards does not
exist in these one-card cells.)"""

import pytest

from benchmark import run as R
from benchmark.gen import inputs as ginputs
from benchmark.gen.mat import node_names
from benchmark.reference import check, placer
from conftest import TINY, cell, tiny_traffic


def test_control_fails(cpu_env):
    """The reference with each batch scored against the tree as the batch
    began (the host corrections left out) disagrees with the reference."""
    t = tiny_traffic("direct_jobs_2048")
    inp = ginputs.prepare(TINY, t, 77, 0.2)
    base = placer.BaseTree(inp["mat"], node_names(inp["mat"]), "cpu")
    unit = inp["units"][1]
    exact = placer.Placer(base).run(unit)
    ctl = placer.Placer(base).run(unit, snapshot=True)
    got = ({ln.split("\t", 1)[0]: ln for ln in ctl[0]},
           {ln.split("\t", 1)[0]: ln for ln in ctl[1]}, ctl[2])
    counts = check.compare(unit["names"], exact, got)
    assert counts["wrong_samples"] > 0 and counts["wrong_trees"] == 1


def test_compare_counts():
    names = ["a", "b", "c"]
    ref = (["a\t1\t1\t\n", "b\t2\t1\t\n", "c\t2\t1\t\n"],
           ["a\tx \n", "b\ty \n", "c\tz \n"], "(a:1,b:2)n:0;")
    got = ({"a": "a\t1\t1\t\n", "b": "b\t2\t2\t\n"},
           {"a": "a\tx \n", "b": "b\ty \n"}, "(a:1,b:2)n:0;")
    assert check.compare(names, ref, got) == {
        "wrong_samples": 1, "missing_samples": 1, "wrong_trees": 0}


def _direct_faults(kind, monkeypatch):
    from usher_tpu_torch.placement import direct
    P = direct.DirectPlacer
    if kind == "state_unchanged":
        monkeypatch.setattr(P, "apply_placement", lambda self, *a, **k: [])
    elif kind == "half_batch":
        orig = P.place_all

        def half(self, opts):
            self.missing = self.missing[::2]
            return orig(self, opts)
        monkeypatch.setattr(P, "place_all", half)
    else:
        orig = P._mutation_path

        def altered(self, name):
            line = orig(self, name)
            return line.replace("\t", "\tnode_1:A1C ", 1)
        monkeypatch.setattr(P, "_mutation_path", altered)


def _server_faults(kind, monkeypatch):
    from usher_tpu_torch.cli import usher_server_cli as srv
    from usher_tpu_torch.placement import driver
    if kind == "state_unchanged":
        monkeypatch.setattr(driver.PlacementEngine, "apply_placement",
                            lambda self, *a, **k: None)
    elif kind == "half_batch":
        orig = srv.run_usher

        def half(T, missing, opts, vcf=None, device=None):
            return orig(T, missing[::2], opts, vcf, device)
        monkeypatch.setattr(srv, "run_usher", half)
    else:
        orig = driver.write_mutation_paths

        def altered(T, samples, filename):
            orig(T, samples, filename)
            with open(filename) as f:
                lines = f.readlines()
            lines[0] = lines[0].replace("\t", "\tnode_1:A1C ", 1)
            with open(filename, "w") as f:
                f.writelines(lines)
        monkeypatch.setattr(driver, "write_mutation_paths", altered)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("mix", ["direct_jobs_2048", "server_requests_64"])
def test_fault_is_not_correct(cpu_env, monkeypatch, mix, fault):
    (_direct_faults if "direct" in mix else _server_faults)(fault,
                                                            monkeypatch)
    t = tiny_traffic(mix)
    _, verdict = R.execute(cell(mix), TINY, t, 31337, 0.3, False,
                           cuda=False, workroot=str(cpu_env))
    assert not verdict["correct"], verdict
    assert verdict["failed"] > 0 or \
        verdict["compared"]["wrong_trees"]["value"] > 0
