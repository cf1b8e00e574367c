"""The port imports no jax, no triton and nothing of the JAX package
usher_tpu: it keeps its own copy of the host layers.

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
    "usher_tpu_torch.cli.matoptimize_cli",
    "usher_tpu_torch.cli.matutils_cli",
    "usher_tpu_torch.cli.usher_sampled_cli",
    "usher_tpu_torch.cli.usher_server_cli",
    "usher_tpu_torch.cli.usher_socket_server_cli",
    "usher_tpu_torch.cli.ripples_cli",
    "usher_tpu_torch.cli.ripples_filter_cli",
    "usher_tpu_torch.cli.ripples_init_cli",
    "usher_tpu_torch.cli.ripples_utils_cli",
    "usher_tpu_torch.cli.check_samples_cli",
    "usher_tpu_torch.cli.compare_vcf_cli",
    "usher_tpu_torch.cli.transpose_vcf_cli",
    "usher_tpu_torch.__main__",
    "usher_tpu_torch.ripples",
    "usher_tpu_torch.ripples.detect",
    "usher_tpu_torch.ripples.filter",
    "usher_tpu_torch.ripples.init",
    "usher_tpu_torch.ripples.utils",
    "usher_tpu_torch.core.bigmat",
    "usher_tpu_torch.io.detailed",
    "usher_tpu_torch.io.diff",
    "usher_tpu_torch.io.patch",
    "usher_tpu_torch.io.transpose",
    "usher_tpu_torch.io.pb_arrays",
    "usher_tpu_torch.io.fatovcf",
    "usher_tpu_torch.matutils.annotate",
    "usher_tpu_torch.matutils.arrays",
    "usher_tpu_torch.matutils.convert",
    "usher_tpu_torch.matutils.convert_arrays",
    "usher_tpu_torch.matutils.describe",
    "usher_tpu_torch.matutils.extract",
    "usher_tpu_torch.matutils.fix",
    "usher_tpu_torch.matutils.introduce",
    "usher_tpu_torch.matutils.introduce_arrays",
    "usher_tpu_torch.matutils.mask",
    "usher_tpu_torch.matutils.merge",
    "usher_tpu_torch.matutils.merge_arrays",
    "usher_tpu_torch.matutils.select",
    "usher_tpu_torch.matutils.summary",
    "usher_tpu_torch.matutils.translate",
    "usher_tpu_torch.matutils.translate_arrays",
    "usher_tpu_torch.matutils.tree_filter",
    "usher_tpu_torch.matutils.uncertainty",
    "usher_tpu_torch.native",
    "usher_tpu_torch.native._build",
    "usher_tpu_torch.ops.interval",
    "usher_tpu_torch.ops.placement_sparse",
    "usher_tpu_torch.ops.sankoff",
    "usher_tpu_torch.optimize",
    "usher_tpu_torch.optimize.driver",
    "usher_tpu_torch.optimize.epp",
    "usher_tpu_torch.optimize.fitch",
    "usher_tpu_torch.optimize.leafstore",
    "usher_tpu_torch.optimize.spr",
    "usher_tpu_torch.optimize.spr_big",
    "usher_tpu_torch.parallel.mesh",
    "usher_tpu_torch.parallel.shard",
    "usher_tpu_torch.placement.big_engine",
    "usher_tpu_torch.placement.direct",
    "usher_tpu_torch.placement.driver",
    "usher_tpu_torch.placement.list_tree",
    "usher_tpu_torch.placement.sampled",
    "usher_tpu_torch.tools.subtrees",
    # what chip_smoke.py imports beyond the above
    "usher_tpu_torch.core.flat",
    "usher_tpu_torch.core.tree",
    "usher_tpu_torch.io.newick",
    "usher_tpu_torch.io.pbio",
    "usher_tpu_torch.io.vcf",
    "usher_tpu_torch.ops._build",
    "usher_tpu_torch.ops.placement",
    "usher_tpu_torch.utils.device",
    "usher_tpu_torch.utils.instrument",
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
    for banned in ("jax", "jaxlib", "triton", "usher_tpu"):
        hits = [m for m in new if m == banned or m.startswith(banned + ".")]
        assert not hits, f"importing the port pulled in {hits[:5]}"
    for name in PORT_MODULES[1:]:
        assert name in new, name
    # importing native/ builds and loads nothing: the scanner is built at
    # first use
    assert "_usher_native" not in new
    # the port's own host layers came in instead of the JAX package's
    assert "usher_tpu_torch.core.tree" in mods["all"]
    assert "usher_tpu_torch.placement.mapper" in mods["all"]
    assert not [m for m in mods["all"]
                if m == "usher_tpu" or m.startswith("usher_tpu.")]


def _import_lines(path):
    with open(path) as f:
        return [line.strip() for line in f
                if line.lstrip().startswith(("import ", "from "))]


def test_no_source_line_imports_the_jax_package():
    """No import statement of the port, of chip_smoke.py or of the matUtils
    cases it runs (tests/matutils_cases.py) names usher_tpu,
    jax or triton at module level or inside a function (triton may only be
    imported inside the function that launches a Triton kernel; there is
    none yet)."""
    paths = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tests", "matutils_cases.py")]
    for root, _, names in os.walk(os.path.join(REPO, "usher_tpu_torch")):
        paths += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(paths) > 20
    for path in paths:
        for line in _import_lines(path):
            words = line.replace(",", " ").split()
            mods = [w for w in words[1:] if w not in ("import", "as")]
            root_names = {words[1].split(".")[0]} | (
                {m.split(".")[0] for m in mods} if words[0] == "import"
                else set())
            assert not root_names & {"usher_tpu", "jax", "jaxlib",
                                      "triton"}, \
                f"{os.path.relpath(path, REPO)}: {line}"
