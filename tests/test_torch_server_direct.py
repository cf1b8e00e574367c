"""usher_server's --pb-direct requests on a resident tree
(usher_tpu_torch/cli/usher_server_cli.py::run_direct_request), on the CPU
(USHER_TPU_PLATFORM=cpu).

A tree of 3,000 nodes from the benchmark's generator (`benchmark/gen`), its
pb re-saved with clade annotations, is served by one MatStore.  Requests in
a row: one of two batches, one whose samples carry sites the pb lacks, one
that repeats the names an earlier request placed (with -D, the detailed
clade histograms), one that saves the tree (-o), one whose samples split
leaves of the pb.  Each request's files must
equal, byte for byte, those of a fresh `usher --pb-direct` run of the port
and of the JAX package on the same pb and VCF, and the placements, paths
and final tree those of the benchmark's plain reference
(`benchmark/reference/placer.py`), which places every unit onto its own
copy of the tree.  After each request the resident BigMAT and the placer
hold what a fresh load holds, array for array, and a request of one batch
recomputes no BFS ranks.  Tolerance: none.
"""

import os
import sys

import numpy as np
import pytest
import torch

from usher_tpu.cli.usher_cli import main as jax_main
from usher_tpu_torch.cli import usher_server_cli as srv
from usher_tpu_torch.cli.usher_cli import main as torch_main
from usher_tpu_torch.io import pb_arrays as pa
from usher_tpu_torch.placement.direct import DirectPlacer
from usher_tpu_torch.utils import instrument as I

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.gen import mat as gmat  # noqa: E402
from benchmark.gen import pbwrite, samples as gsamples  # noqa: E402
from benchmark.reference import check, placer as ref_placer  # noqa: E402

MIX = {"clade_ladder": [1, 2, 2, 3, 3], "private_substitutions": [1],
       "n_calls": [1]}
# (name prefix, samples, flags): one request a row; the last one's samples
# split leaves of the pb (`_splitting_unit`)
REQUESTS = [("s1", 20, []), ("s2", 70, []), ("s1", 20, ["-D"]),
            ("s4", 20, ["-o", "{out}/saved.pb"]), ("s5", 70, [])]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("USHER_TPU_PLATFORM", "cpu")
    monkeypatch.delenv("USHER_TPU_DIRECT_SEQ", raising=False)
    monkeypatch.delenv("USHER_TPU_DIRECT_PIPE", raising=False)


def _stream(*salt):
    return np.random.default_rng(np.random.SeedSequence([1918, *salt]))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The generated tree (3,000 nodes over 3,000 sites, so about a third of
    the sites carry no mutation and are not in the pb), its pb with clade
    annotations on a fifth of the internal nodes, a plain pb, and the
    requests' units and VCFs."""
    d = tmp_path_factory.mktemp("server_direct")
    mat = gmat.generate(_stream(1), 3000, 3000,
                        [190, 151, 79, 32, 14, 4, 2, 1])
    plain = str(d / "plain.pb")
    pbwrite.write_pb(mat, plain)
    ma = pa.load_mat_arrays(plain)
    rng = _stream(2)
    internal = np.zeros(ma.n, bool)
    internal[ma.parent[1:]] = True
    parts = [f"clade_{a}_{int(rng.integers(0, 4))}"
             if internal[i] and rng.random() < 0.2 else ""
             for i in range(ma.n) for a in range(2)]
    ma.ann_counts = np.full(ma.n, 2, np.int32)
    ma.ann_blob = ("\0".join(parts) + "\0").encode()
    pb = str(d / "annotated.pb")
    pa.save_arrays_to_pb(ma, pb)
    units = []
    for k, (prefix, size, _) in enumerate(REQUESTS):
        if k == len(REQUESTS) - 1:
            unit = _splitting_unit(mat, size, prefix)
        else:
            unit = gsamples.draw_job(_stream(3, k), mat, MIX, size, prefix)
        unit["vcf"] = str(d / f"unit_{k}.vcf")
        gsamples.write_vcf(unit["vcf"], unit, mat)
        units.append(unit)
    in_pb = np.zeros(len(mat["positions"]), bool)
    in_pb[mat["mut_col"]] = True
    return dict(mat=mat, pb=pb, plain=plain, units=units, in_pb=in_pb,
                dir=d)


def _splitting_unit(mat, size, prefix):
    """Samples that each sit at a leaf of the pb with three or more branch
    mutations, one of them reverted: each is placed by splitting that
    leaf's branch, so the pb's own mutations move to the new node (the
    BigMAT tombstones them, and its second batch finds them dead on the
    device)."""
    leaves = np.nonzero(mat["is_leaf"] & (np.diff(mat["mut_ptr"]) >= 3))[0]
    leaves = leaves[:size]
    assert len(leaves) == size
    ptr, cols, nucs = [0], [], []
    for leaf, state in zip(leaves, gsamples.node_states(mat, leaves)):
        gone = int(mat["mut_col"][mat["mut_ptr"][leaf]])
        par = int(mat["mut_par"][mat["mut_ptr"][leaf]])
        if par == mat["ref"][gone]:
            state.pop(gone, None)
        else:
            state[gone] = par
        for c in sorted(state):
            cols.append(c)
            nucs.append(state[c])
        ptr.append(len(cols))
    return dict(names=[f"{prefix}_{i}" for i in range(len(leaves))],
                ptr=np.array(ptr, np.int64), col=np.array(cols, np.int32),
                nuc=np.array(nucs, np.uint8))


def _files(outdir):
    out = {}
    for root, _, names in os.walk(outdir):
        for name in names:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, outdir)] = f.read()
    return out


def _value(v):
    """An attribute's value, comparable with ==."""
    if isinstance(v, np.ndarray):
        return ("array", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, torch.Tensor):
        return ("tensor", str(v.dtype), tuple(v.shape), str(v.device),
                v.cpu().numpy().tobytes())
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, [_value(x) for x in v])
    if isinstance(v, dict):
        return ("dict", sorted((repr(k), _value(x)) for k, x in v.items()))
    if isinstance(v, set):
        return ("set", sorted(v))
    return ("other", repr(v) if not hasattr(v, "__dict__") else type(v))


def _state(placer):
    """Everything the placer and its BigMAT hold, by attribute."""
    skip = {"big", "_job", "_pristine", "_name_set", "ma"}
    out = {"placer." + k: _value(v) for k, v in vars(placer).items()
           if k not in skip}
    out.update({"big." + k: _value(v) for k, v in vars(placer.big).items()
                if k != "_pristine"})
    keep, dead = placer.big._pristine
    out["big._pristine"] = _value(({k: v for k, v in keep.items()}, dead))
    out["ma"] = _value({k: v for k, v in vars(placer.ma).items()})
    return out


def _fresh(pb):
    placer = DirectPlacer(pb)
    placer.keep_pristine()
    return placer


def _argv(pb, unit, out, flags):
    return ["--pb-direct", "-i", pb, "-v", unit["vcf"], "-d", out,
            *[f.format(out=out) for f in flags]]


def _reference(world, unit):
    base = ref_placer.BaseTree(world["mat"], gmat.node_names(world["mat"]),
                               "cpu")
    return ref_placer.Placer(base).run(unit, batch_size=64)


def test_requests_in_a_row_match_fresh_runs_and_reference(world, tmp_path):
    """Each request on one resident tree writes the files of a fresh run
    of the port's CLI and of the JAX CLI, places as the plain reference
    does, and leaves the tree as a fresh load holds it."""
    pb, units = world["pb"], world["units"]
    listing = tmp_path / "mats.txt"
    listing.write_text(pb + "\n")
    store = srv.MatStore(str(listing))
    want_state = _state(_fresh(pb))
    inst = I.Instrumentor.get()
    inst.begin_session(str(tmp_path / "spans.json"))
    for k, ((_, _, flags), unit) in enumerate(zip(REQUESTS, units)):
        got = str(tmp_path / f"server_{k}")
        assert srv.run_request(_argv(pb, unit, got, flags), store) == 0
        assert list(store.direct) == [pb]
        assert _state(store.direct[pb]) == want_state, k
        files = _files(got)
        assert {"placement_stats.tsv", "mutation-paths.txt",
                "final-tree.nh", "clades.txt"} <= set(files)
        for side, main in (("torch", torch_main), ("jax", jax_main)):
            out = str(tmp_path / f"{side}_{k}")
            assert main(_argv(pb, unit, out, flags)) == 0
            assert _files(out) == files, (k, side)
        counts = check.compare(unit["names"], _reference(world, unit),
                               check.read_program(got))
        assert counts == {"wrong_samples": 0, "missing_samples": 0,
                          "wrong_trees": 0}, k
    inst.end_session()
    spans = inst.spans()
    by_id = {s.id: s for s in spans}

    def outer(s):
        while s.cause in by_id:
            s = by_id[s.cause]
        return s
    # the server's spans (the fresh CLI runs' stand beside them)
    by = {}
    for s in spans:
        if outer(s).name == "server:request":
            by.setdefault(s.name, []).append(s)
    # loaded once, on first use, inside the first request
    assert len(by["server:reload"]) == 1
    assert len(by["direct:load"]) == 1
    attach, restore = by["server:attach"], by["server:restore"]
    requests = by["server:request"]
    assert ([s.args["request"] for s in attach]
            == [s.args["request"] for s in restore]
            == [s.args["request"] for s in requests])
    assert [s.counts["samples"] for s in attach] == [
        n for _, n, _ in REQUESTS]
    new_sites = [len(np.unique(u["col"][~world["in_pb"][u["col"]]]))
                 for u in units]
    assert [s.counts["new_sites"] for s in attach] == new_sites
    assert all(new_sites[:-1])
    for name in ("server:attach", "server:restore", "direct:batch",
                 "direct:write"):
        assert by[name], name
    # the rows a restore drops are those the request's flushes appended
    appended = {}
    for s in by["bigmat:flush"]:
        r = outer(s).args["request"]
        appended[r] = appended.get(r, 0) + s.counts["appended"]
    assert [s.counts["rows"] for s in restore] == [
        appended[s.args["request"]] for s in restore]
    # the last request's splits tombstoned mutations of the pb, whose dead
    # bits the restore cleared on the device
    assert restore[-1].counts["bytes"] > 0
    assert len(by["direct:batch"]) == 7     # 1 + 2 + 1 + 1 + 2 batches


def test_one_batch_requests_recompute_no_ranks(world, tmp_path):
    """A request of one batch starts from the restored tree, whose ranks
    are clean, and reads none after its flush: no `bigmat:ranks` span
    inside its `server:request`, while the load's own sweep stays outside
    them."""
    pb = world["pb"]
    listing = tmp_path / "mats.txt"
    listing.write_text(pb + "\n")
    store = srv.MatStore(str(listing))
    inst = I.Instrumentor.get()
    inst.begin_session(str(tmp_path / "spans.json"))
    store.direct_tree(pb)
    for k in (0, 3):
        _, size, flags = REQUESTS[k]
        assert size <= 64
        out = str(tmp_path / f"r{k}")
        assert srv.run_request(_argv(pb, world["units"][k], out, flags),
                               store) == 0
    inst.end_session()
    spans = inst.spans()
    by_id = {s.id: s for s in spans}

    def outer(s):
        while s.cause in by_id:
            s = by_id[s.cause]
        return s
    inside = {}
    for s in spans:
        inside.setdefault((outer(s).name, s.name), []).append(s)
    assert len(inside[("server:request", "server:request")]) == 2
    assert len(inside[("server:request", "direct:batch")]) == 2
    assert inside[("server:request", "bigmat:flush")]
    assert ("server:request", "bigmat:ranks") not in inside
    assert len(inside[("server:reload", "bigmat:ranks")]) == 1


def test_request_names_repeat_and_new_sites(world, tmp_path):
    """A sample name that an earlier request placed is placed anew (the
    tree has no such leaf again), and a site the pb lacks is served: its
    column is dropped with the request."""
    pb, unit = world["plain"], world["units"][0]
    store = srv.MatStore()
    outs = []
    for k in range(2):
        out = str(tmp_path / f"r{k}")
        assert srv.run_request(_argv(pb, unit, out, []), store) == 0
        outs.append(_files(out))
    assert outs[0] == outs[1]
    placer = store.loaded_direct
    assert store.loaded_direct_name == pb and not store.direct
    new = unit["col"][~world["in_pb"][unit["col"]]]
    assert len(new)
    assert placer.big.P == int(world["in_pb"].sum())
    assert not any(int(world["mat"]["positions"][c]) in placer.big.pos_index
                   for c in new)


def test_reload_and_the_slot_outside_the_list(world, tmp_path):
    """--reload loads the listed resident tree again; a pb outside the list
    takes the one extra slot and is kept there until another pb outside
    the list replaces it, as the Tree path's slot is."""
    pb, plain, unit = world["pb"], world["plain"], world["units"][0]
    listing = tmp_path / "mats.txt"
    listing.write_text(pb + "\n")
    store = srv.MatStore(str(listing))
    assert srv.run_request(_argv(pb, unit, str(tmp_path / "a"), []),
                           store) == 0
    first = store.direct[pb]
    assert srv.run_request(["--reload"], store) == 0
    assert store.direct[pb] is not first
    assert set(store.trees) == {pb}
    assert _state(store.direct[pb]) == _state(_fresh(pb))
    assert srv.run_request(_argv(plain, unit, str(tmp_path / "b"), []),
                           store) == 0
    outside = store.loaded_direct
    assert store.loaded_direct_name == plain and list(store.direct) == [pb]
    assert srv.run_request(_argv(plain, unit, str(tmp_path / "c"), []),
                           store) == 0
    assert store.loaded_direct is outside
    assert _files(str(tmp_path / "b")) == _files(str(tmp_path / "c"))
    other = str(tmp_path / "other.pb")
    with open(plain, "rb") as f, open(other, "wb") as g:
        g.write(f.read())
    assert srv.run_request(_argv(other, unit, str(tmp_path / "d"), []),
                           store) == 0
    assert store.loaded_direct_name == other
    assert store.loaded_direct is not outside


@pytest.mark.parametrize("argv,message", [
    (["--pb-direct", "-v", "x.vcf"], "--pb-direct requires -i MAT.pb"),
    (["--pb-direct", "-i", "{pb}", "-v", "x.vcf", "-k", "1"],
     "print-subtrees-size should be larger than 1"),
    (["--pb-direct", "-i", "{pb}", "-v", "x.vcf", "-n", "-K", "5"],
     "cannot output subtrees when -n/--no-add"),
    (["--pb-direct", "-i", "{pb}", "-v", "x.vcf", "-s", "-S"],
     "Can't use two or more of sort-before-placement"),
    (["--pb-direct", "-i", "{pb}", "-v", "x.vcf", "-r"],
     "Can't use reverse-sort without sorting options")])
def test_request_checks(world, capsys, argv, message):
    """A --pb-direct request fails usher --pb-direct's checks with its
    messages, before any tree is loaded."""
    store = srv.MatStore()
    argv = [a.format(pb=world["plain"]) for a in argv]
    assert srv.run_request(argv, store) == 1
    assert message in capsys.readouterr().err
    assert store.loaded_direct is None and not store.direct
