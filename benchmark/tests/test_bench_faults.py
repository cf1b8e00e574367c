"""The comparison fails what it must: the control (the reference without
its host corrections) and the timed path broken underneath, once for each
fault a placement cell can have.  (The exchange between cards does not
exist in these one-card cells.)"""

import pytest

from benchmark import control
from benchmark import run as R
from benchmark.gen import inputs as ginputs
from benchmark.gen.mat import node_names
from benchmark.reference import check, placer
from conftest import cell, tiny_config, tiny_traffic


@pytest.mark.parametrize("mix", ["direct_jobs_2048", "socket_requests_64"])
def test_control_fails(cpu_env, mix):
    """The reference with each batch scored against the tree as the batch
    began (the host corrections and the retries left out) disagrees with
    the reference that the configuration names."""
    t = tiny_traffic(mix)
    config = tiny_config(mix)
    inp = ginputs.prepare(config, t, 77, 0.2)
    base = placer.BaseTree(inp["mat"], node_names(inp["mat"]), "cpu")
    counts = control.held_against(config, t, [inp["units"][1]], base)
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


def _socket_faults(kind, monkeypatch):
    from usher_tpu_torch.placement import sampled
    if kind == "half_batch":
        orig = sampled.place_batch

        def half(engine, samples, *a, **k):
            return orig(engine, samples[::2], *a, **k)
        monkeypatch.setattr(sampled, "place_batch", half)
    else:
        _server_faults(kind, monkeypatch)


FAULTS = {"direct": _direct_faults, "server": _server_faults,
          "socket": _socket_faults}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("mix", ["direct_jobs_2048", "server_requests_64",
                                 "socket_requests_64"])
def test_fault_is_not_correct(cpu_env, monkeypatch, mix, fault):
    FAULTS[mix.split("_")[0]](fault, monkeypatch)
    t = tiny_traffic(mix)
    try:
        _, verdict = R.execute(cell(mix), tiny_config(mix), t, 31337, 0.3,
                               False, cuda=False, workroot=str(cpu_env))
    except AttributeError:
        # the Tree driver reads the sample's node back after its apply:
        # with the tree left unchanged it stops, and a run that stops
        # prints no result
        assert (mix, fault) == ("server_requests_64", "state_unchanged")
        return
    assert not verdict["correct"], verdict
    assert verdict["failed"] > 0 or \
        verdict["compared"]["wrong_trees"]["value"] > 0
