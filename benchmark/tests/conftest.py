"""Shared fixtures of the benchmark's own tests (CPU, tiny sizes).

Run with `python -m pytest benchmark/tests -q`.  Tests marked `card` need a
CUDA card and skip without one; the rest run the program on the CPU
(USHER_TPU_PLATFORM=cpu) with its kernels' plain twins."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


TINY = {"name": "tiny", "generator": {
    "nodes": 3000, "sites": 500,
    "branch_mutations": [190, 151, 79, 32, 14, 4, 2, 1]}}
# the same tree, its outputs checked against usher-sampled's batch placement
SAMPLED = dict(TINY, reference="sampled_batch")


def tiny_config(mix: str) -> dict:
    """The tiny configuration whose semantics the mix's program keeps: the
    usher-sampled daemon's batch placement, or UShER's sequential one."""
    return SAMPLED if mix.startswith("socket_") else TINY


def tiny_traffic(mix: str, **over) -> dict:
    """The mix `mix` at a size the CPU holds: small units."""
    with open(os.path.join(ROOT, "benchmark", "traffic",
                           mix + ".json")) as f:
        t = json.load(f)
    t.update(unit_samples=128 if t["unit_samples"] > 64 else 32,
             batch_size=16 if t["unit_samples"] > 64 else 32,
             max_samples_per_s=10_000, check_units=2)
    t.update(over)
    return t


@pytest.fixture
def cpu_env(monkeypatch, tmp_path):
    """The program on the CPU, the inputs cache in a temporary directory."""
    from benchmark.gen import inputs
    monkeypatch.setenv("USHER_TPU_PLATFORM", "cpu")
    monkeypatch.setattr(inputs, "CACHE", str(tmp_path / "cache"))
    return tmp_path


def cell(traffic: str) -> dict:
    return {"name": "tiny_" + traffic, "config": "tiny", "traffic": traffic,
            "chips": 1}
