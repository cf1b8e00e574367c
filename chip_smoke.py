#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (usher_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from usher_tpu_torch/csrc, then runs
five phases and fails (non-zero exit) if any of them fails:

  kernel_small     B1 and B2 against their plain PyTorch twins on the card,
                   on random MATs with ambiguous and missing entries,
                   padding slots, inactive slots and forced ties
  kernel_headline  the same on a synthetic 100,000-node x 512-site MAT,
                   1,024 samples of 16 entries, with the median ms of 5 runs
  kernel_genome    the same at genome width: 100,000 nodes x 30,000 sites,
                   1,024 samples of 32 entries
  fixture_e2e      the usher CLI's build and place steps on the vendored
                   fixtures, byte-matching tests/goldens/smoke_*
  realistic_e2e    the CLI places 1,024 samples (VCF, ~34 entries each,
                   some N) onto a synthetic 100,000-node x 30,000-site MAT
                   saved as a pb, with -s so that the sort pre-pass runs
                   the fused B2 step over the whole set

Kernel against plain comparisons are exact (tolerance 0: the arithmetic is
integer).  The launch counters are zeroed right before the two CLI runs
(the main path) and read right after them.  Earlier lines report the
card, the build, each phase and the kernels (one JSON object); the last
line is {"ok": true, "device": {...}}.  Work files go to build/chip_smoke/.
The script imports no jax: the port shares only the JAX-free host layers
of usher_tpu (tree, I/O, host oracle).
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
NIBBLES = np.array([1, 2, 4, 8], dtype=np.uint8)
CHROM = "NC_045512v2"


def log(*a):
    print(*a, flush=True)


def median_ms(fn, runs=5):
    """Median of `runs` synchronized wall times of fn(), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def max_abs_err(got, want) -> int:
    """Largest |kernel - plain| over a tuple of integer outputs; raises
    unless it is 0."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {g.dtype} vs "
                                 f"{w.shape} {w.dtype}")
        err = max(err, int((g.long() - w.long()).abs().max().item())
                  if g.numel() else 0)
    if err:
        raise AssertionError(f"kernel disagrees with plain: max |err| {err}")
    return err


class Kernels:
    """The two kernels of the slice: comparison errors, times and the
    launch counts of the main path."""

    def __init__(self, ps):
        self.ps = ps
        self.err = {"B1": 0, "B2": 0}
        self.ms = {}

    def compare(self, st, stp, ref, node, pos, gval, kmiss):
        """B1 and B2 against their plain twins on one input; node is
        (active, is_leaf, is_root, num_leaves, bfs_rank)."""
        ps = self.ps
        base, nc_base, nnm = ps.row_reductions(st, stp, ref)
        b1 = (st, stp, ref, base, nc_base, pos, gval, kmiss)
        self.err["B1"] = max(self.err["B1"], max_abs_err(
            ps.score_entries_T(*b1), ps.score_entries_T_plain(*b1)))
        torch.cuda.synchronize()
        b2 = (st, stp, ref, base, nc_base, nnm, *node, pos, gval, kmiss)
        self.err["B2"] = max(self.err["B2"], max_abs_err(
            ps.placement_reduce(*b2), ps.placement_reduce_plain(*b2)))
        torch.cuda.synchronize()
        return b1, b2

    def time(self, phase, b1, b2):
        ps = self.ps
        t = {"B1": (median_ms(lambda: ps.score_entries_T(*b1)),
                    median_ms(lambda: ps.score_entries_T_plain(*b1))),
             "B2": (median_ms(lambda: ps.placement_reduce(*b2)),
                    median_ms(lambda: ps.placement_reduce_plain(*b2)))}
        self.ms[phase] = t
        return t

    def reset_counts(self):
        self.ps.score_entries_T.launches = 0
        self.ps.placement_reduce.launches = 0

    def counts(self):
        return {"B1": self.ps.score_entries_T.launches,
                "B2": self.ps.placement_reduce.launches}


# --- random MATs (the tests/test_placement.py recipes) --------------------

def random_mat(rng, n_leaves, n_positions, mut_rate=0.35):
    """Random multifurcating topology with well-formed branch mutations
    (par_nuc is the parent's path state, mut != par), back mutations
    included, sometimes a root mutation."""
    from usher_tpu.core.tree import Mutation
    from usher_tpu.io.newick import parse_newick_string
    bases = NIBBLES.tolist()
    parts = [f"L{i}" for i in range(n_leaves)]
    while len(parts) > 1:
        k = int(rng.integers(2, min(4, len(parts)) + 1))
        group = [parts.pop(int(rng.integers(len(parts)))) for _ in range(k)]
        parts.append("(" + ",".join(group) + ")")
    T = parse_newick_string(parts[0] + ";")
    positions = list(range(100, 100 + n_positions))
    ref = {p: bases[int(rng.integers(4))] for p in positions}
    root_mut = rng.random() < 0.5
    stack = [(T.root, {positions[0]: [b for b in bases
                                      if b != ref[positions[0]]][0]}
              if root_mut else {})]
    if root_mut:
        p = positions[0]
        T.root.add_mutation(Mutation("c", p, ref[p], ref[p],
                                     stack[0][1][p]))
    while stack:
        node, state = stack.pop()
        state = dict(state)
        if node.parent is not None:
            for p in positions:
                if rng.random() < mut_rate / n_positions * 6:
                    par = state.get(p, ref[p])
                    mut = [b for b in bases if b != par][int(rng.integers(3))]
                    node.add_mutation(Mutation("c", p, ref[p], par, mut))
                    state[p] = mut
        for ch in node.children:
            stack.append((ch, state))
    return T, ref


def random_sample(rng, ref, n_entries):
    """Entries at random sites: 15% missing (N), 20% ambiguous masks, the
    rest a non-reference base."""
    from usher_tpu.core.tree import Mutation
    bases = NIBBLES.tolist()
    sites = sorted(rng.choice(list(ref), size=min(n_entries, len(ref)),
                              replace=False).tolist())
    muts = []
    for p in sites:
        r = rng.random()
        m = Mutation("c", p, ref[p], ref[p])
        if r < 0.15:
            m.is_missing = True
            m.mut_nuc = 15
        elif r < 0.35:
            m.mut_nuc = int(rng.integers(3, 15))
        else:
            m.mut_nuc = [b for b in bases if b != ref[p]][int(rng.integers(3))]
        muts.append(m)
    return muts


def phase_kernel_small(kern, device):
    from usher_tpu_torch.core.flat import FlatMAT
    from usher_tpu_torch.ops.placement import parent_states
    ps = kern.ps
    cases = 0
    for seed in range(6):
        rng = np.random.default_rng(seed)
        n_leaves, n_pos = [(20, 15), (60, 40), (200, 300)][seed % 3]
        T, ref = random_mat(rng, n_leaves, n_pos)
        positions = np.array(sorted(ref), dtype=np.int64)
        refarr = np.array([ref[p] for p in positions.tolist()], np.uint8)
        flat = FlatMAT(T, positions, refarr, "c", device=device)
        assert flat.cap > flat.n_slots
        samples = [random_sample(rng, ref, int(rng.integers(1, 12)))
                   for _ in range(13)]
        # forced ties: an empty sample (scores equal base everywhere) and a
        # duplicated sample
        samples += [[], samples[0]]
        st, parent = flat.sync()
        stp = parent_states(st, parent, flat.root_slot)
        meta = flat.order_arrays()
        node = tuple(torch.from_numpy(meta[k]).to(device) for k in (
            "active", "is_leaf", "is_root_mask", "num_leaves", "bfs_rank"))
        for k_slots in (8, 64, 2048):
            pos, gval, kmiss = (torch.from_numpy(x).to(device) for x in
                                ps.sparsify(samples, flat.pos_index,
                                            flat.P_pad, k_slots))
            kern.compare(st, stp, flat.ref_dev, node, pos, gval, kmiss)
            cases += 1
    return {"cases": cases, "max_abs_err": dict(kern.err)}


# --- synthetic flat MATs (bench.py's recipe) -------------------------------

def synth_mat(rng, n_nodes, n_sites, n_mut=3):
    """Parent pointers in topological order and path states derived
    root->leaf with n_mut random branch mutations per node (numpy)."""
    ref = NIBBLES[rng.integers(0, 4, size=n_sites)]
    parent = np.zeros(n_nodes, dtype=np.int32)
    parent[1:] = (rng.random(n_nodes - 1)
                  * np.arange(n_nodes - 1)).astype(np.int32)
    st = np.empty((n_nodes, n_sites), dtype=np.uint8)
    st[0] = ref
    mut_pos = rng.integers(0, n_sites, size=(n_nodes, n_mut))
    mut_allele = NIBBLES[rng.integers(0, 4, size=(n_nodes, n_mut))]
    for i in range(1, n_nodes):
        st[i] = st[parent[i]]
        st[i, mut_pos[i]] = mut_allele[i]
    is_leaf = np.ones(n_nodes, dtype=bool)
    is_leaf[parent[1:]] = False
    is_leaf[0] = False
    num_leaves = is_leaf.astype(np.int32)
    for i in range(n_nodes - 1, 0, -1):
        num_leaves[parent[i]] += num_leaves[i]
    return dict(st=st, parent=parent, ref=ref, mut_pos=mut_pos,
                is_leaf=is_leaf, num_leaves=num_leaves)


def synth_slots(rng, ref, n_samples, n_entries):
    """Samples with n_entries distinct non-reference sites each, as slot
    arrays (pos, gval, kmiss)."""
    P = len(ref)
    pos = np.stack([rng.choice(P, size=n_entries, replace=False)
                    for _ in range(n_samples)]).astype(np.int32)
    shift = rng.integers(1, 4, size=pos.shape)
    idx = (np.log2(ref[pos]).astype(np.int64) + shift) % 4
    gval = NIBBLES[idx]
    kmiss = np.zeros(pos.shape, dtype=bool)
    return pos, gval, kmiss


def phase_kernel_synth(kern, name, mat, n_samples, n_entries, seed, device):
    rng = np.random.default_rng(seed)
    N, P = mat["st"].shape
    st = torch.from_numpy(mat["st"]).to(device)
    parent = torch.from_numpy(mat["parent"]).to(device)
    stp = st[parent.long()]
    ref = torch.from_numpy(mat["ref"]).to(device)
    node = (torch.ones(N, dtype=torch.bool, device=device),
            torch.from_numpy(mat["is_leaf"]).to(device),
            (torch.arange(N, device=device) == 0),
            torch.from_numpy(mat["num_leaves"]).to(device),
            torch.arange(N, dtype=torch.int32, device=device))
    pos, gval, kmiss = (torch.from_numpy(x).to(device) for x in
                        synth_slots(rng, mat["ref"], n_samples, n_entries))
    b1, b2 = kern.compare(st, stp, ref, node, pos, gval, kmiss)
    t = kern.time(name, b1, b2)
    del b1, b2, st, stp
    torch.cuda.empty_cache()
    return {"N": N, "P": P, "B": n_samples, "K": n_entries,
            "max_abs_err": dict(kern.err),
            "B1_ms": t["B1"][0], "B1_plain_ms": t["B1"][1],
            "B2_ms": t["B2"][0], "B2_plain_ms": t["B2"][1]}


# --- end to end through the CLI --------------------------------------------

@contextlib.contextmanager
def sankoff_devices(seen):
    """Record the device of every Sankoff state tensor the CLI computes."""
    from usher_tpu_torch.ops import sankoff
    orig = sankoff._sankoff_states

    def spy(*a, **k):
        out = orig(*a, **k)
        seen.append(out.device.type)
        return out

    sankoff._sankoff_states = spy
    try:
        yield
    finally:
        sankoff._sankoff_states = orig


def run_cli(argv):
    from usher_tpu_torch.cli.usher_cli import main
    rc = main(argv)
    if rc != 0:
        raise AssertionError(f"usher CLI {argv} returned {rc}")


def phase_fixture_e2e(kern):
    fx = os.path.join(REPO, "tests", "fixtures")
    gold = os.path.join(REPO, "tests", "goldens")
    out = os.path.join(WORK, "fixture")
    seen = []
    with sankoff_devices(seen):
        run_cli(["-t", os.path.join(fx, "global_phylo.nh"),
                 "-v", os.path.join(fx, "global_samples.vcf"),
                 "-o", os.path.join(out, "out.pb"), "-d",
                 os.path.join(out, "b"), "--mesh-devices", "0"])
    run_cli(["-i", os.path.join(out, "out.pb"),
             "-v", os.path.join(fx, "new_samples.vcf"),
             "-o", os.path.join(out, "out2.pb"), "-d",
             os.path.join(out, "p"), "--mesh-devices", "0"])
    for fname, gname in [("placement_stats.tsv", "smoke_placement_stats.tsv"),
                         ("final-tree.nh", "smoke_final_tree.nh"),
                         ("mutation-paths.txt", "smoke_mutation_paths.txt")]:
        with open(os.path.join(out, "p", fname), "rb") as a, \
                open(os.path.join(gold, gname), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"{fname} deviates from tests/goldens/"
                                     f"{gname}")
    if seen != ["cuda"]:
        raise AssertionError(f"Sankoff ran on {seen}, expected ['cuda']")
    counts = kern.counts()
    if counts["B1"] < 1:
        raise AssertionError("fixture placement never launched B1")
    return {"goldens": "byte-identical", "sankoff_device": seen[0],
            "launches": counts}


def synth_tree(mat, positions):
    """The synthetic MAT as a Tree (leaves named leaf_<i>)."""
    from usher_tpu.core.tree import Mutation, Tree
    st, parent, ref = mat["st"], mat["parent"], mat["ref"]
    N = len(parent)
    T = Tree()
    nodes = [T.create_node("node_1", None)]
    for i in range(1, N):
        name = f"leaf_{i}" if mat["is_leaf"][i] else f"node_{i + 1}"
        nodes.append(T.create_node(name, nodes[parent[i]]))
    for i in range(1, N):
        for c in sorted(set(mat["mut_pos"][i].tolist())):
            a, pa = int(st[i, c]), int(st[parent[i], c])
            if a != pa:
                nodes[i].add_mutation(Mutation(CHROM, int(positions[c]),
                                               int(ref[c]), pa, a))
    return T


def write_samples_vcf(path, rng, mat, positions, n_samples, n_new=2,
                      n_missing=2):
    """Samples near random nodes: the node's genotype plus n_new new
    mutations and n_missing N calls, written as a VCF of the sites where
    any sample differs from the reference."""
    st, ref = mat["st"], mat["ref"]
    N, P = st.shape
    G = st[rng.integers(0, N, size=n_samples)].copy()        # [B, P]
    rows = np.arange(n_samples)[:, None]
    new = rng.integers(0, P, size=(n_samples, n_new))
    G[rows, new] = NIBBLES[(np.log2(G[rows, new]).astype(np.int64)
                            + rng.integers(1, 4, size=new.shape)) % 4]
    G[rows, rng.integers(0, P, size=(n_samples, n_missing))] = 15
    sites = np.nonzero((G != ref[None, :]).any(0))[0]
    chars = np.array(list("?AC?G???T??????N"))
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                "FILTER\tINFO\tFORMAT\t"
                + "\t".join(f"sample_{b}" for b in range(n_samples)) + "\n")
        for c in sites.tolist():
            col = G[:, c]
            alts = [int(a) for a in NIBBLES
                    if a != ref[c] and (col == a).any()]
            code = np.full(n_samples, "0", dtype=object)
            for j, a in enumerate(alts):
                code[col == a] = str(j + 1)
            code[col == 15] = "."
            f.write(f"{CHROM}\t{positions[c]}\t.\t{chars[ref[c]]}\t"
                    f"{','.join(chars[a] for a in alts) or '.'}\t.\t.\t.\t"
                    "GT\t" + "\t".join(code.tolist()) + "\n")
    entries = (G != ref[None, :]).sum(1)
    return len(sites), float(entries.mean())


def stage_seconds(trace_path):
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        out[e["name"]] = out.get(e["name"], 0.0) + e["dur"] / 1e6
    return out


def realistic_setup(mat, n_samples, seed):
    """Inputs of the realistic run: the synthetic MAT as a Tree and as a
    pb, and a VCF of n_samples new samples."""
    from usher_tpu.io.pbio import save_mat_pb
    rng = np.random.default_rng(seed)
    out = os.path.join(WORK, "realistic")
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    positions = np.arange(1, mat["st"].shape[1] + 1, dtype=np.int64)
    T = synth_tree(mat, positions)
    pb = os.path.join(out, "tree.pb")
    save_mat_pb(T, pb)
    vcf = os.path.join(out, "samples.vcf")
    n_sites, mean_entries = write_samples_vcf(vcf, rng, mat, positions,
                                              n_samples)
    setup_s = time.perf_counter() - t0
    return T, pb, vcf, {"setup_s": setup_s, "vcf_sites": n_sites,
                        "mean_entries": mean_entries,
                        "tree_nodes": T.num_nodes()}


def run_realistic_cli(pb, vcf, batch_size):
    from usher_tpu.utils.instrument import Instrumentor
    out = os.path.join(WORK, "realistic", "out")
    trace = os.path.join(WORK, "realistic", "trace.json")
    inst = Instrumentor.get()
    inst.begin_session(trace)
    t0 = time.perf_counter()
    try:
        run_cli(["-i", pb, "-v", vcf, "-d", out, "-s",
                 "--batch-size", str(batch_size)])
    finally:
        inst.end_session()
    return time.perf_counter() - t0, stage_seconds(trace), out


def check_realistic(kern, T, vcf, out_dir, n_samples, counts, device,
                    batch_size):
    from usher_tpu.io.newick import parse_newick_string
    from usher_tpu.io.vcf import read_vcf
    from usher_tpu_torch.placement.driver import PlacementEngine
    ps = kern.ps
    with open(os.path.join(out_dir, "placement_stats.tsv")) as f:
        rows = [l for l in f.read().split("\n") if l]
    if len(rows) != n_samples:
        raise AssertionError(f"placement_stats.tsv has {len(rows)} rows")
    n_leaves_in = len(T.get_leaves_ids())
    with open(os.path.join(out_dir, "final-tree.nh")) as f:
        n_leaves_out = len(parse_newick_string(f.read()).get_leaves_ids())
    if n_leaves_out != n_leaves_in + n_samples:
        raise AssertionError(f"final tree has {n_leaves_out} leaves, "
                             f"expected {n_leaves_in} + {n_samples}")
    need_b1 = -(-n_samples // batch_size)
    if counts["B1"] < need_b1 or counts["B2"] < 1:
        raise AssertionError(f"launches {counts}: expected B1 >= {need_b1}"
                             " and B2 >= 1")

    # the first batch through the kernel and through its plain twin
    missing, vcf_data = read_vcf(T, vcf, create_new_mat=False)
    eng = PlacementEngine(T, vcf_data, device=device)
    batch = [s.mutations for s in missing[:batch_size]]

    def summary(results):
        return [(r.best_score, r.num_best, r.best_node.identifier,
                 r.best_has_unique, [n.identifier for n in r.tied_nodes],
                 r.tied_has_unique) for r in results]

    got = summary(eng.score_samples(batch))
    kernel_b1 = ps.score_entries_T
    ps.score_entries_T = ps.score_entries_T_plain
    try:
        want = summary(eng.score_samples(batch))
    finally:
        ps.score_entries_T = kernel_b1
    if got != want:
        raise AssertionError("first batch: kernel and plain SampleResults "
                             "differ")
    # the kernels at the main path's own shapes on the engine's FlatMAT:
    # B1 on one batch, B2 on all samples (the -s pre-pass)
    flat = eng.flat
    st, parent = flat.sync()
    stp = st[parent.long()]
    stp[flat.root_slot] = st[flat.root_slot]
    meta = flat.order_arrays()
    node = tuple(torch.from_numpy(meta[k]).to(device) for k in (
        "active", "is_leaf", "is_root_mask", "num_leaves", "bfs_rank"))
    shapes = {}
    for name, samples in (("B1", batch),
                          ("B2", [s.mutations for s in missing])):
        pos, gval, kmiss = (torch.from_numpy(x).to(device) for x in
                            ps.sparsify(samples, flat.pos_index, flat.P_pad))
        b1, b2 = kern.compare(st, stp, flat.ref_dev, node, pos, gval, kmiss)
        fn, plain, args = ((ps.score_entries_T, ps.score_entries_T_plain, b1)
                           if name == "B1" else
                           (ps.placement_reduce, ps.placement_reduce_plain,
                            b2))
        shapes[name] = {"N": int(st.shape[0]), "P": int(st.shape[1]),
                        "B": len(samples), "K": int(pos.shape[1]),
                        "ms": median_ms(lambda: fn(*args)),
                        "plain_ms": median_ms(lambda: plain(*args))}
    return {"stats_rows": len(rows), "leaves_added": n_leaves_out - n_leaves_in,
            "first_batch": f"{len(got)} SampleResults identical",
            "main_shapes": shapes}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from usher_tpu_torch.ops import _build
    from usher_tpu_torch.ops import placement_sparse as ps
    from usher_tpu_torch.utils.device import apply_platform_env

    os.environ["USHER_TPU_PLATFORM"] = "cuda"
    device = apply_platform_env()
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.load_library()
    log(f"build: {time.perf_counter() - t0:.3f} s ({_build.library_path()})")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    kern = Kernels(ps)
    results = {}

    def phase(name, fn, *a):
        t = time.perf_counter()
        res = fn(*a)
        torch.cuda.synchronize()
        res = dict(res, seconds=round(time.perf_counter() - t, 3))
        results[name] = res
        log(f"phase {name}: {json.dumps(res)}")
        return res

    phase("kernel_small", phase_kernel_small, kern, device)
    rng = np.random.default_rng(1)
    head = synth_mat(rng, 100_000, 512)
    phase("kernel_headline", phase_kernel_synth, kern, "kernel_headline",
          head, 1024, 16, 2, device)
    del head
    genome = synth_mat(np.random.default_rng(3), 100_000, 30_000)
    phase("kernel_genome", phase_kernel_synth, kern, "kernel_genome",
          genome, 1024, 32, 4, device)

    # set-up of the realistic run (tree, pb, VCF) before the main path
    T, pb, vcf, setup = realistic_setup(genome, 1024, 5)
    log(f"realistic setup: {json.dumps(setup)}")

    # --- the main path: the counters cover exactly these CLI runs ---------
    kern.reset_counts()
    phase("fixture_e2e", phase_fixture_e2e, kern)
    wall, stages, out_dir = run_realistic_cli(pb, vcf, 64)
    counts = kern.counts()
    # ----------------------------------------------------------------------

    def realistic():
        res = check_realistic(kern, T, vcf, out_dir, 1024, counts, device, 64)
        return dict(res, cli_seconds=wall, launches=counts, setup=setup,
                    stage_seconds={k: round(v, 3) for k, v in stages.items()})

    phase("realistic_e2e", realistic)

    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise AssertionError("jax was imported")
    genome_ms = kern.ms["kernel_genome"]
    src = "usher_tpu_torch/csrc/placement_sparse.cu"
    kernels = [
        {"name": "B1 score_entries_T", "route": "cuda", "source": src,
         "replaces": "usher_tpu/ops/placement_pallas.py:176",
         "launches": counts["B1"], "max_abs_err": kern.err["B1"],
         "ms": genome_ms["B1"][0], "plain_ms": genome_ms["B1"][1]},
        {"name": "B2 placement_reduce", "route": "cuda", "source": src,
         "replaces": "usher_tpu/ops/placement_pallas.py:119",
         "launches": counts["B2"], "max_abs_err": kern.err["B2"],
         "ms": genome_ms["B2"][0], "plain_ms": genome_ms["B2"][1]},
    ]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
