"""usher_tpu_torch.placement.sampled.place_batch against usher_tpu's, and the
three tests of tests/test_sampled.py on the port's side.

Each side builds its own tree, engine and samples from the same inputs
(the port's through `port_tree` / `port_samples`), places the same samples
in batches, and must report the same sequence of placements (sample, best
node, score, tie count, the host oracle's parsimony), the same
`BatchPlacementStats` (placed, retried, ignored, parsimony increase) and
the same final tree.  The seeded random MATs carry duplicated samples, so
that a later sample of a batch finds its proposal stale and is re-scored
(retried > 0).  Dense and BigMAT engines, on CPU tensors.  Tolerance: none.
"""

import os

import numpy as np
import pytest

from usher_tpu.core.tree import MissingSample as JMissing
from usher_tpu.io.newick import parse_newick, write_newick as jnwk
from usher_tpu.io.vcf import read_vcf_sites as jread_sites
from usher_tpu.ops.sankoff import assign_states_from_vcf
from usher_tpu.placement import sampled as jsampled
from usher_tpu.placement.big_engine import BigPlacementEngine as JBig
from usher_tpu.placement.driver import PlacementEngine as JEngine
from usher_tpu_torch.core.tree import MissingSample as TMissing
from usher_tpu_torch.io.diff import (load_diff, load_reference_fasta,
                                     materialize_missing)
from usher_tpu_torch.io.newick import write_newick as tnwk
from usher_tpu_torch.io.vcf import (collect_missing_samples_build,
                                    read_vcf_sites)
from usher_tpu_torch.placement import sampled as tsampled
from usher_tpu_torch.placement.big_engine import BigPlacementEngine as TBig
from usher_tpu_torch.placement.driver import PlacementEngine as TEngine

from conftest import REFERENCE_TEST_DIR
from test_placement import random_mat, random_sample
from test_torch_hostlayers import port_samples, port_tree, tree_signature

GLOBAL_NH = os.path.join(REFERENCE_TEST_DIR, "global_phylo.nh")
GLOBAL_VCF = os.path.join(REFERENCE_TEST_DIR, "global_samples.vcf")
NEW_VCF = os.path.join(REFERENCE_TEST_DIR, "new_samples.vcf")
REF_FA = os.path.join(REFERENCE_TEST_DIR, "NC_045512v2.fa")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("USHER_TPU_PLATFORM", "cpu")


@pytest.fixture(scope="module")
def built_tree():
    """The fixture tree with Sankoff states (JAX), and the port's copy."""
    T = parse_newick(GLOBAL_NH)
    vcf = jread_sites(GLOBAL_VCF)
    assign_states_from_vcf(T, vcf)
    return T, port_tree(T), read_vcf_sites(GLOBAL_VCF)


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


def _record(placed):
    def on_placed(s, res, detail):
        placed.append((s.name, res.best_node.identifier, res.best_score,
                       res.num_best,
                       None if detail is None else detail.set_difference))
    return on_placed


def _stats(st):
    return (st.placed, st.retried, st.ignored, st.parsimony_increase)


# --- the three tests of tests/test_sampled.py --------------------------------

def test_place_batch_matches_serial(built_tree):
    """Batch placement of the 5 new samples reconstructs their genotypes,
    gives each at most its serial score + 2, and equals the JAX
    place_batch on the same tree."""
    T, P, _ = built_tree
    new_vcf = read_vcf_sites(NEW_VCF)
    P1 = P.copy()
    missing = collect_missing_samples_build(new_vcf, set(P1.get_leaves_ids()))
    assert len(missing) == 5
    engine = TEngine(P1, new_vcf, device="cpu")
    serial = [engine.score_samples([s.mutations])[0].best_score
              for s in missing]
    placed = []
    stats = tsampled.place_batch(engine, missing, batch_size=5,
                                 on_placed=_record(placed))
    assert stats.placed == 5
    assert [p[0] for p in placed] == [s.name for s in missing]
    for p, sc in zip(placed, serial):
        assert p[4] <= sc + 2

    # the JAX package on its own objects
    from usher_tpu.io.vcf import collect_missing_samples_build as jcollect
    J1 = T.copy()
    jnew = jread_sites(NEW_VCF)
    jplaced = []
    jstats = jsampled.place_batch(
        JEngine(J1, jnew), jcollect(jnew, set(J1.get_leaves_ids())),
        batch_size=5, on_placed=_record(jplaced))
    assert placed == jplaced and _stats(stats) == _stats(jstats)
    assert tree_signature(P1) == tree_signature(J1)

    P1.uncondense_leaves()
    recon = reconstruct_leaf_states(P1)
    for site in new_vcf.sites:
        variant_by_col = {j: nuc for j, nuc in site.variants}
        for j, name in enumerate(new_vcf.sample_ids):
            assert name in recon
            mask = variant_by_col.get(j, site.ref_nuc)
            got = recon[name].get(site.position, site.ref_nuc)
            assert got & mask


def test_diff_roundtrip(built_tree, tmp_path):
    """Write a small MAPLE diff, load it with the port's loaders, place,
    verify the sample landed."""
    _, P, vcf = built_tree
    refs, chrom = load_reference_fasta(REF_FA)
    assert chrom.startswith("NC_045512")
    assert refs.shape[0] > 29000
    site_a, site_b = vcf.sites[10], vcf.sites[20]
    alt_a = 1 if site_a.ref_nuc != 1 else 2
    alt_b = 4 if site_b.ref_nuc != 4 else 8
    from usher_tpu_torch.core.nuc import char_from_nuc_id
    diff_path = tmp_path / "s.diff"
    diff_path.write_text(
        f">dsample\n"
        f"{char_from_nuc_id(alt_a)}\t{site_a.position}\n"
        f"{char_from_nuc_id(alt_b)}\t{site_b.position}\n"
        f"n\t{vcf.sites[30].position}\t5\n")
    samples = load_diff(str(diff_path), refs, chrom,
                        tree_node_ids=set(P.get_leaves_ids()))
    assert len(samples) == 1
    s = samples[0]
    assert len(s.mutations) == 2
    assert s.n_ranges == [(vcf.sites[30].position, vcf.sites[30].position + 5)]
    P1 = P.copy()
    engine = TEngine(P1, vcf, device="cpu")
    pos_ref = {int(p): int(r) for p, r in
               zip(engine.flat.positions, engine.flat.ref)}
    muts = materialize_missing(s, engine.flat.positions, pos_ref, chrom)
    assert any(m.is_missing for m in muts)
    s.mutations = muts
    stats = tsampled.place_batch(engine, [s])
    assert stats.placed == 1
    assert P1.get_node("dsample") is not None


def test_diff_skips_existing_samples(built_tree, tmp_path):
    _, P, _ = built_tree
    refs, chrom = load_reference_fasta(REF_FA)
    existing = P.get_leaves_ids()[0]
    diff_path = tmp_path / "s.diff"
    diff_path.write_text(f">{existing}\nA\t100\n>fresh\nA\t100\n")
    samples = load_diff(str(diff_path), refs, chrom,
                        tree_node_ids={existing})
    assert [s.name for s in samples] == ["fresh"]


# --- place_batch against the JAX package on seeded random MATs ----------------

def _samples(rng, ref, n, n_dup):
    """n random samples, the last n_dup of them copies (new names) of
    earlier ones, interleaved so that a copy shares a batch with its
    original."""
    muts = [random_sample(rng, ref, n_entries=int(rng.integers(2, 8)))
            for _ in range(n - n_dup)]
    order = []
    for i, m in enumerate(muts):
        order.append((f"new{i}", m))
        if i < n_dup:
            order.append((f"dup{i}", m))
    return order


def _missing(cls, order, port):
    out = []
    for name, muts in order:
        s = cls(name)
        s.mutations = port_samples([muts])[0] if port else list(muts)
        out.append(s)
    return out


@pytest.mark.parametrize("engine", ["dense", "big"])
@pytest.mark.parametrize("seed,batch,max_pars", [
    (0, 8, 1_000_000), (3, 5, 1_000_000), (7, 16, 2), (12, 3, 1_000_000)])
def test_place_batch_matches_jax(engine, seed, batch, max_pars):
    rng = np.random.default_rng(seed)
    T, ref = random_mat(rng, n_leaves=40, n_positions=20)
    order = _samples(rng, ref, 24, 6)
    P = port_tree(T)
    jm, tm = _missing(JMissing, order, False), _missing(TMissing, order, True)
    extra_j = [m for s in jm for m in s.mutations]
    extra_t = [m for s in tm for m in s.mutations]
    if engine == "big":
        je = JBig(T, None, extra_mutations=extra_j)
        te = TBig(P, None, extra_mutations=extra_t, device="cpu")
    else:
        je = JEngine(T, None, extra_mutations=extra_j)
        te = TEngine(P, None, extra_mutations=extra_t, device="cpu")
    jplaced, tplaced = [], []
    js = jsampled.place_batch(je, jm, batch_size=batch,
                              max_parsimony=max_pars,
                              on_placed=_record(jplaced))
    ts = tsampled.place_batch(te, tm, batch_size=batch,
                              max_parsimony=max_pars,
                              on_placed=_record(tplaced))
    assert tplaced == jplaced
    assert _stats(ts) == _stats(js)
    assert ts.retried > 0                       # duplicates went stale
    assert (ts.ignored > 0) == (max_pars < 1_000_000)
    assert tree_signature(P) == tree_signature(T)
    assert tnwk(P, print_internal=True, print_branch_len=True) == \
        jnwk(T, print_internal=True, print_branch_len=True)
