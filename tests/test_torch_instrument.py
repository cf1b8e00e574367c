"""usher_tpu_torch/utils/instrument.py: the span recorder, and the spans and
counters that the --pb-direct placer, the BigMAT, the Tree driver and
usher_server write with it, on the CPU.

The recorder: spans nest by thread with each span's cause; identifiers and
counts land on the right span; nothing is kept and no profiler range is
opened with no session and no profiler; records stay readable after the
session ends; the file is the reference's Chrome trace; past the record
cap the oldest records go to the file; under torch.profiler each span is a
user_annotation range around the ops run inside it.  The program's spans:
one `direct:load` and `direct:write` a job, one `direct:batch` a batch, the
flushes' `appended` counts summing to the BigMAT's growth, a flush's
`map_pieces` equal to the runs of old rows its row map moved by one offset
(no span when nothing is queued), one `bigmat:ranks` span a read of
ranks that a flush left dirty and none on a clean read, the batches'
`rescores` counts equal to the placer's fallbacks and to its
`direct:rescore` spans, the Tree driver's `placement:rescore` spans equal to
`apply_batch`'s `rescores`, one `server:request` a request; and a session
changes nothing the CLI prints or writes.
"""

import json
import os

import numpy as np
import pytest
import torch

from usher_tpu_torch.cli import usher_server_cli as tserver
from usher_tpu_torch.cli.usher_cli import main as torch_main
from usher_tpu_torch.core.bigmat import BigMAT
from usher_tpu_torch.placement.direct import DirectOptions, DirectPlacer
from usher_tpu_torch.utils import instrument as I

from conftest import REFERENCE_TEST_DIR

GLOBAL_NH = os.path.join(REFERENCE_TEST_DIR, "global_phylo.nh")
GLOBAL_VCF = os.path.join(REFERENCE_TEST_DIR, "global_samples.vcf")
NEW_VCF = os.path.join(REFERENCE_TEST_DIR, "new_samples.vcf")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("USHER_TPU_PLATFORM", "cpu")
    monkeypatch.delenv("USHER_TPU_DIRECT_SEQ", raising=False)
    monkeypatch.delenv("USHER_TPU_DIRECT_PIPE", raising=False)
    monkeypatch.delenv("USHER_TPU_PROFILE", raising=False)
    yield
    I.Instrumentor.get().end_session()


@pytest.fixture
def session(tmp_path):
    """An open session writing to tmp_path/spans.json."""
    inst = I.Instrumentor.get()
    path = str(tmp_path / "spans.json")
    inst.begin_session(path)
    return inst, path


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def _ancestors(span, by_id):
    out = []
    while span.cause in by_id:
        span = by_id[span.cause]
        out.append(span.name)
    return out


# --- the recorder ------------------------------------------------------------

def test_spans_nest_by_thread_with_their_cause(session):
    inst, _ = session
    with I.timeit("a:outer"):
        with I.timeit("a:inner"):
            with I.timeit("a:innermost"):
                pass
        with I.timeit("a:second"):
            pass
    with I.timeit("a:alone"):
        pass
    inst.end_session()
    spans = inst.spans()
    assert [s.name for s in spans] == ["a:innermost", "a:inner", "a:second",
                                       "a:outer", "a:alone"]
    by = {s.name: s for s in spans}
    assert by["a:outer"].cause == 0 and by["a:alone"].cause == 0
    assert by["a:inner"].cause == by["a:outer"].id
    assert by["a:second"].cause == by["a:outer"].id
    assert by["a:innermost"].cause == by["a:inner"].id
    assert len({s.id for s in spans}) == 5
    assert len({s.tid for s in spans}) == 1
    for s in spans:
        assert s.start_ns <= s.end_ns
    assert by["a:outer"].start_ns <= by["a:inner"].start_ns
    assert by["a:inner"].end_ns <= by["a:second"].start_ns
    assert by["a:second"].end_ns <= by["a:outer"].end_ns


def test_spans_of_another_thread_have_their_own_causes(session):
    import threading
    inst, _ = session

    def work():
        with I.timeit("t:worker"):
            I.count("rows", 3)

    with I.timeit("t:main"):
        th = threading.Thread(target=work)
        th.start()
        th.join()
    inst.end_session()
    by = {s.name: s for s in inst.spans()}
    assert by["t:worker"].cause == 0
    assert by["t:worker"].tid != by["t:main"].tid
    assert by["t:worker"].counts == {"rows": 3}
    assert by["t:main"].counts is None


def test_args_and_counts_land_on_their_span(session):
    inst, _ = session
    I.count("nowhere")                      # no span open: dropped
    with I.timeit("c:batch", job=7, batch=2):
        I.count("rescores")
        with I.timeit("c:flush", rows=10):
            I.count("appended", 4)
            I.count("appended", 2)
        I.count("rescores", 3)
    inst.end_session()
    by = {s.name: s for s in inst.spans()}
    assert by["c:batch"].args == {"job": 7, "batch": 2}
    assert by["c:batch"].counts == {"rescores": 4}
    assert by["c:flush"].args == {"rows": 10}
    assert by["c:flush"].counts == {"appended": 6}
    with I.timeit("c:plain"):
        pass
    assert "c:plain" not in {s.name for s in inst.spans()}


def test_no_session_and_no_profiler_keep_nothing(tmp_path, monkeypatch):
    inst = I.Instrumentor.get()
    inst.begin_session(str(tmp_path / "old.json"))
    with I.timeit("n:kept"):
        pass
    inst.end_session()
    assert not inst.active and not torch.autograd._profiler_enabled()
    opened = []

    class Range:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Range)
    ctx = I.timeit("n:ignored", job=1)
    assert ctx is I.timeit("n:other")       # one shared no-op
    with ctx:
        I.count("n:count", 5)
        with I.timeit("n:inner"):
            pass
    assert opened == []
    assert [s.name for s in inst.spans()] == ["n:kept"]
    assert getattr(I._tls, "stack", []) == []


def test_records_stay_readable_until_the_next_session(tmp_path):
    inst = I.Instrumentor.get()
    inst.begin_session(str(tmp_path / "one.json"))
    with I.timeit("r:first", job=1):
        pass
    inst.end_session()
    assert [s.name for s in inst.spans()] == ["r:first"]
    assert [s.name for s in inst.spans()] == ["r:first"]
    inst.begin_session(str(tmp_path / "two.json"))
    assert inst.spans() == []
    with I.timeit("r:second"):
        pass
    assert [s.name for s in inst.spans()] == ["r:second"]
    inst.end_session()


def test_file_is_the_reference_chrome_trace(session):
    inst, path = session
    with I.timeit("f:outer", job=3):
        with I.timeit('f:in"ner'):
            pass
        with I.timeit("f:counted"):
            I.count("splits", 2)
    inst.end_session()
    with open(path) as f:
        doc = json.load(f)
    assert sorted(doc) == ["otherData", "traceEvents"]
    assert doc["otherData"] == {}
    ev = doc["traceEvents"]
    assert [e["name"] for e in ev] == ["f:in'ner", "f:counted", "f:outer"]
    plain = {"cat", "dur", "name", "ph", "pid", "tid", "ts"}
    assert set(ev[0]) == plain
    assert set(ev[1]) == plain | {"args"}
    assert set(ev[2]) == plain | {"args"}
    spans = {s.name: s for s in inst.spans()}
    outer = spans["f:outer"]
    assert ev[2]["args"] == {"job": 3, "id": outer.id, "cause": 0}
    assert ev[1]["args"] == {"splits": 2, "id": spans["f:counted"].id,
                             "cause": outer.id}
    for e in ev:
        assert e["ph"] == "X" and e["cat"] == "function" and e["pid"] == 0
        assert isinstance(e["ts"], int) and isinstance(e["dur"], int)
        assert e["dur"] >= 0
    assert ev[2]["ts"] == outer.start_ns // 1000
    assert ev[2]["ts"] <= ev[0]["ts"]


def test_record_cap_writes_out_the_oldest(session, monkeypatch):
    inst, path = session
    monkeypatch.setattr(I, "SPAN_CAP", 8)
    for k in range(21):
        with I.timeit(f"cap:{k}"):
            pass
    held = [s.name for s in inst.spans()]
    assert 0 < len(held) < 8
    assert held == [f"cap:{k}" for k in range(21 - len(held), 21)]
    inst.end_session()
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    assert [e["name"] for e in ev] == [f"cap:{k}" for k in range(21)]


@pytest.mark.parametrize("with_session", [True, False])
def test_spans_are_profiler_ranges_around_their_ops(tmp_path,
                                                    with_session):
    from torch.profiler import ProfilerActivity, profile
    inst = I.Instrumentor.get()
    if with_session:
        inst.begin_session(str(tmp_path / "spans.json"))
    before = [s.name for s in inst.spans()]
    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with I.timeit("p:outer", batch=1):
            with I.timeit("p:matmul"):
                b = a @ a
            c = b.sum()
    inst.end_session()
    assert float(c) == float(c)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    ranges = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "user_annotation"}
    assert {"p:outer", "p:matmul"} <= set(ranges)

    def within(name, op):
        lo, hi = ranges[name]
        hits = [e for e in events if e.get("cat") == "cpu_op"
                and e["name"] == op]
        return hits and all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi
                            for e in hits)
    assert within("p:matmul", "aten::mm")
    assert within("p:outer", "aten::mm") and within("p:outer", "aten::sum")
    lo, hi = ranges["p:matmul"]
    assert not any(lo <= e["ts"] < hi for e in events
                   if e.get("cat") == "cpu_op" and e["name"] == "aten::sum")
    names = [s.name for s in inst.spans()]
    assert names == (["p:matmul", "p:outer"] if with_session else before)


# --- the program's spans -----------------------------------------------------

@pytest.fixture(scope="module")
def fixture_pb(tmp_path_factory):
    """The Quick Start fixture's MAT as a pb (the port's CLI builds it)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USHER_TPU_PLATFORM", "cpu")
        outdir = str(tmp_path_factory.mktemp("instrument_build"))
        pb = os.path.join(outdir, "out.pb")
        assert torch_main(["-t", GLOBAL_NH, "-v", GLOBAL_VCF, "-o", pb,
                           "-d", outdir]) == 0
    return pb


@pytest.mark.parametrize("seq,batch", [(False, 2), (True, 5)])
def test_direct_jobs_span_tree(fixture_pb, tmp_path, monkeypatch, session,
                               seq, batch):
    """Two jobs on the fixture, batches of 2; and in one batch under
    USHER_TPU_DIRECT_SEQ, the literal per-sample loop, whose samples after
    the first apply are all host re-scores."""
    inst, _ = session
    if seq:
        monkeypatch.setenv("USHER_TPU_DIRECT_SEQ", "1")
    pb, vcf = fixture_pb, NEW_VCF
    placers = []
    for k in range(2):
        placer = DirectPlacer(pb, vcf)
        n0 = placer.big.N
        placer.place_all(DirectOptions(outdir=str(tmp_path / f"job{k}"),
                                       batch_size=batch))
        placers.append((placer, n0))
    inst.end_session()
    spans = inst.spans()
    by = _by_name(spans)
    by_id = {s.id: s for s in spans}
    jobs = [p._job for p, _ in placers]
    assert len(set(jobs)) == 2
    assert sorted(s.args["job"] for s in by["direct:load"]) == sorted(jobs)
    assert sorted(s.args["job"] for s in by["direct:write"]) == sorted(jobs)
    for name in ("io:load_pb", "io:read_vcf", "bigmat:build"):
        assert len(by[name]) == 2
        assert all(_ancestors(s, by_id) == ["direct:load"] for s in by[name])
    assert all(s.args["rows"] == n0 for s, (_, n0)
               in zip(by["bigmat:build"], placers))
    load_ranks = [s for s in by["bigmat:ranks"]
                  if _ancestors(s, by_id)[-1] == "direct:load"]
    assert len(load_ranks) == 2
    for placer, n0 in placers:
        mine = [s for s in by["direct:batch"]
                if s.args["job"] == placer._job]
        n_missing = len(placer.missing)
        assert [s.args["batch"] for s in mine] == list(
            range(-(-n_missing // batch)))
        assert sum(s.args["samples"] for s in mine) == n_missing
        assert len(mine) == placer._total_batches
        ids = {s.id for s in mine} | {
            s.id for s in by["direct:write"] if s.args["job"] == placer._job}

        def of_job(name):
            return [s for s in by.get(name, [])
                    if ids & {a.id for a in _chain(s, by_id)}]
        flushes = of_job("bigmat:flush")
        assert flushes
        assert all(s.counts["map_pieces"] >= 1 for s in flushes)
        assert sum(s.counts["appended"] for s in flushes) == \
            placer.big.N - n0
        assert flushes[-1].args["rows"] == placer.big.N
        rescores = sum((s.counts or {}).get("rescores", 0) for s in mine)
        assert rescores == placer._total_fallbacks
        assert rescores == len(of_job("direct:rescore"))
        reasons = {}
        for s in mine:
            for k, v in (s.counts or {}).items():
                if k.startswith("fallback:"):
                    reasons[k[9:]] = reasons.get(k[9:], 0) + v
        assert reasons == placer._fb_reasons
        assert len(of_job("direct:apply")) == n_missing
        assert len(of_job("bigmat:score_begin")) == len(mine)
        assert len(of_job("bigmat:score_finish")) == len(mine)
    for s in by["direct:resolve"] + by["direct:apply"]:
        assert _ancestors(s, by_id)[0] == "direct:batch"
    assert (sum(p._total_fallbacks for p, _ in placers) > 0) == seq


def _chain(span, by_id):
    out = [span]
    while span.cause in by_id:
        span = by_id[span.cause]
        out.append(span)
    return out


@pytest.mark.parametrize("n_ops", [0, 24])
def test_bigmat_flush_counts_its_map_pieces(session, n_ops):
    """A flush's record carries `appended`, `splits` and `map_pieces`, the
    pieces of its composed row map: the runs of old DFS rows that moved by
    one offset.  A flush with nothing queued opens no span."""
    inst, _ = session
    rng = np.random.default_rng(n_ops)
    N = 200
    parent = np.zeros(N, np.int32)
    parent[1:] = (rng.random(N - 1) * np.arange(1, N)).astype(np.int32)
    big = BigMAT(parent, np.zeros(N + 1, np.int64), np.zeros(0, np.int32),
                 np.zeros(0, np.uint8), np.zeros(0, np.uint8),
                 np.arange(4, dtype=np.int64),
                 np.array([1, 2, 4, 8], np.uint8), device="cpu")
    order0 = big.dfs_order.copy()
    splits = 0
    for k in range(n_ops):
        if k % 3:
            big.queue_sibling_split(int(rng.integers(1, N)), [], [])
            splits += 1
        else:
            big.queue_child_insert(int(rng.integers(0, N)), [])
    big._flush()
    inst.end_session()
    flushes = [s for s in inst.spans() if s.name == "bigmat:flush"]
    if not n_ops:
        assert flushes == []
        return
    (span,) = flushes
    moved = big.dfs_of[order0] - np.arange(N)
    assert span.counts == {"appended": big.N - N, "splits": splits,
                           "map_pieces": 1 + int(np.count_nonzero(
                               moved[1:] != moved[:-1]))}
    assert span.args == {"rows": big.N}


def test_ranks_span_per_read_of_dirty_ranks(session):
    """`bigmat:ranks` opens once for each read of ranks that a flush left
    dirty, with the rows it ranked, and never on a read of clean ranks:
    `bfs_rank` read twice, the scoring metadata after it, a flush with
    nothing queued."""
    inst, _ = session
    rng = np.random.default_rng(11)
    N = 300
    parent = np.zeros(N, np.int32)
    parent[1:] = (rng.random(N - 1) * np.arange(1, N)).astype(np.int32)
    big = BigMAT(parent, np.zeros(N + 1, np.int64), np.zeros(0, np.int32),
                 np.zeros(0, np.uint8), np.zeros(0, np.uint8),
                 np.arange(4, dtype=np.int64),
                 np.array([1, 2, 4, 8], np.uint8), device="cpu")
    reads = []

    def ranks():
        return [s.args["rows"] for s in inst.spans()
                if s.name == "bigmat:ranks"]

    big.bfs_rank
    assert ranks() == []
    for k in range(3):
        big.queue_child_insert(int(rng.integers(0, N)), [])
        big.queue_sibling_split(int(rng.integers(1, N)), [], [])
        big._flush()
        assert big._ranks_dirty
        if k == 1:
            big._dfs_meta(spr=False)     # the scoring call's read
        else:
            big.bfs_rank
        reads.append(big.N)
        big.bfs_rank
        big._dfs_meta(spr=False)
        big._flush()
        big.bfs_rank
        assert ranks() == reads
    inst.end_session()
    assert [s.args["rows"] for s in inst.spans()
            if s.name == "bigmat:ranks"] == [N + 3, N + 6, N + 9]


def test_tree_driver_rescores_are_counted(fixture_pb, tmp_path, session):
    inst, _ = session
    assert torch_main(["-i", fixture_pb, "-v", NEW_VCF, "-d",
                       str(tmp_path / "out"), "--batch-size", "5"]) == 0
    inst.end_session()
    spans = inst.spans()
    by = _by_name(spans)
    by_id = {s.id: s for s in spans}
    applies = by["placement:apply_batch"]
    assert [s.args["batch"] for s in applies] == [0]
    assert [s.args["batch"] for s in by["placement:score_batch"]] == [0]
    assert applies[0].args["samples"] == 5
    rescores = sum((s.counts or {}).get("rescores", 0) for s in applies)
    assert rescores == len(by.get("placement:rescore", []))
    assert rescores > 0
    for name in ("placement:rescore", "placement:tree_size",
                 "placement:surgery"):
        assert all(_ancestors(s, by_id)[0] == "placement:apply_batch"
                   for s in by[name])
    assert len(by["placement:tree_size"]) == 5
    assert len(by["placement:surgery"]) == 5


def test_server_requests_carry_their_ids(fixture_pb, tmp_path, session):
    inst, _ = session
    listing = tmp_path / "mats.txt"
    listing.write_text(fixture_pb + "\n")
    store = tserver.MatStore(str(listing))
    assert store.load_list()
    for k in range(2):
        store.refresh_consumed()
        assert tserver.run_request(["-i", fixture_pb, "-v", NEW_VCF, "-d",
                                    str(tmp_path / f"req{k}")], store) == 0
    inst.end_session()
    spans = inst.spans()
    by = _by_name(spans)
    by_id = {s.id: s for s in spans}
    reqs = by["server:request"]
    assert len(reqs) == 2 and len({s.args["request"] for s in reqs}) == 2
    assert len(by["server:reload"]) == 2      # the list's load and one
    assert all(s.cause == 0 for s in by["server:reload"])
    for name in ("placement:flat_build", "placement:score_batch",
                 "placement:apply_batch", "placement:write_outputs"):
        assert len(by[name]) == 2
        assert all(_ancestors(s, by_id)[-1] == "server:request"
                   for s in by[name])


def test_a_session_changes_no_output(fixture_pb, tmp_path, capsys):
    """The CLI's --pb-direct and Tree runs print and write the same with a
    session as without one."""
    def run(tag, direct):
        out = tmp_path / tag
        argv = ["-i", fixture_pb, "-v", NEW_VCF, "-d", str(out),
                "--batch-size", "2"] + (["--pb-direct"] if direct else [])
        assert torch_main(argv) == 0
        printed = capsys.readouterr()
        files = {f: (out / f).read_bytes() for f in sorted(os.listdir(out))}
        err = _strip_times(printed.err).replace(str(out), "<out>")
        return printed.out, err, files

    inst = I.Instrumentor.get()
    for direct in (True, False):
        plain = run(f"plain{direct}", direct)
        inst.begin_session(str(tmp_path / f"s{direct}.json"))
        traced = run(f"traced{direct}", direct)
        inst.end_session()
        assert inst.spans()
        assert traced == plain


def _strip_times(err):
    """stderr without its wall-clock lines ('Completed in N msec')."""
    return "\n".join(line for line in err.splitlines()
                     if not line.startswith("Completed in"))
