"""The port imports no jax (directly or through usher_tpu) and no triton.

Checked in a fresh interpreter, counting only modules that importing the
port brings in (so an interpreter that preloads jax at start-up does not
mask an import by the port).
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "usher_tpu_torch",
    "usher_tpu_torch.cli.usher_cli",
    "usher_tpu_torch.core.bigmat",
    "usher_tpu_torch.ops.interval",
    "usher_tpu_torch.ops.placement_sparse",
    "usher_tpu_torch.ops.sankoff",
    "usher_tpu_torch.placement.big_engine",
    "usher_tpu_torch.placement.driver",
]

PROBE = """
import importlib, json, sys
before = set(sys.modules)
for name in %r:
    importlib.import_module(name)
new = sorted(set(sys.modules) - before)
print(json.dumps({"new": new, "all": sorted(sys.modules)}))
""" % (PORT_MODULES,)


def test_port_imports_no_jax_and_no_triton():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    new = mods["new"]
    for banned in ("jax", "jaxlib", "triton", "usher_tpu.parallel"):
        hits = [m for m in new if m == banned or m.startswith(banned + ".")]
        assert not hits, f"importing the port pulled in {hits[:5]}"
    for name in PORT_MODULES[1:]:
        assert name in new, name
    # the host layers the port shares with the JAX package
    assert "usher_tpu.core.tree" in mods["all"]
    assert "usher_tpu.placement.mapper" in mods["all"]
