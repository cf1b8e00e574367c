"""What every cell's run shares: the record of a window, the spies that time
the program's calls from outside, and the reduction of a profiler trace.

A spy replaces a function or method of the program, for the length of a
run, by one that records (key, start, end) on the host clock; a call inside
another call of the same key counts once.  A spy's target is named by a
string, `package.module:Owner.attribute`; one that the program no longer
has is left out, and the readers of its key find nothing to read.  With
the trace on, the spy also opens a `bench:<key>` range of torch.profiler,
so that the device's work and idle time can be told apart by what the host
was doing.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import time
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Record:
    """What a run's window did."""
    t_start: float = 0.0
    t_end: float = 0.0
    units: list = field(default_factory=list)       # (unit, samples, t_done)
    spans: dict = field(default_factory=dict)       # key -> [(t0, t1)]
    latency_s: list = field(default_factory=list)   # per sample
    calls: dict = field(default_factory=dict)       # key -> [info]
    program_spans: dict = field(default_factory=dict)  # name -> [seconds]
    trace: "Trace | None" = None
    setup_spans: dict = field(default_factory=dict)
    unspied: list = field(default_factory=list)     # targets not found
    live: bool = False                              # inside the window

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start

    @property
    def samples(self) -> int:
        return sum(n for _, n, _ in self.units)

    def seconds(self, key: str) -> float:
        return sum(b - a for a, b in self.spans.get(key, []))

    def count(self, key: str) -> int:
        return len(self.spans.get(key, []))


def resolve(spec: str):
    """(owner, attribute) that `module:Owner.attribute` or
    `module:function` names, or None where the program lacks it."""
    mod, _, path = spec.partition(":")
    try:
        owner = importlib.import_module(mod)
    except ImportError:
        return None
    *chain, attr = path.split(".")
    for part in chain:
        owner = getattr(owner, part, None)
        if owner is None:
            return None
    if isinstance(owner, type):
        return (owner, attr) if attr in owner.__dict__ else None
    return (owner, attr) if callable(getattr(owner, attr, None)) else None


@contextlib.contextmanager
def spying(targets, rec: Record, trace: bool, hooks=None, keys=None):
    """Time each (spec, key) of `targets` into `rec.spans` (into
    `rec.setup_spans` outside the window), only those whose key is in
    `keys` where it is given.  `hooks[key]` is called as hook(phase, t,
    args, kwargs, result) with phase "enter" or "exit".  Targets the
    program lacks go to `rec.unspied`."""
    import torch
    hooks = hooks or {}
    found = []
    for spec, key in targets:
        if keys is not None and key not in keys:
            continue
        r = resolve(spec)
        if r is None:
            rec.unspied.append(spec)
        else:
            found.append((*r, key))
    targets = found
    saved = [(o, a, o.__dict__[a] if isinstance(o, type) else getattr(o, a))
             for o, a, _ in targets]
    depth: dict = {}

    def wrap(fn, key):
        hook = hooks.get(key)

        def run(*args, **kwargs):
            depth[key] = depth.get(key, 0) + 1
            t0 = time.perf_counter()
            if hook:
                hook("enter", t0, args, kwargs, None)
            ctx = (torch.profiler.record_function(f"bench:{key}")
                   if trace and rec.live else contextlib.nullcontext())
            out = None
            try:
                with ctx:
                    out = fn(*args, **kwargs)
                return out
            finally:
                depth[key] -= 1
                t1 = time.perf_counter()
                if not depth[key]:
                    book = rec.spans if rec.live else rec.setup_spans
                    book.setdefault(key, []).append((t0, t1))
                if hook:
                    hook("exit", t1, args, kwargs, out)
        return run

    for (o, a, key), (_, _, fn) in zip(targets, saved):
        setattr(o, a, wrap(fn, key))
    try:
        yield
    finally:
        for o, a, fn in saved:
            setattr(o, a, fn)


def instrumentor():
    """The program's span recorder (utils/instrument.py), or None where it
    has none."""
    try:
        from usher_tpu_torch.utils.instrument import Instrumentor
        return Instrumentor.get()
    except (ImportError, AttributeError):
        return None


def read_instrumentor(path: str) -> dict:
    """The program's own spans (utils/instrument.py's chrome trace):
    name -> [seconds]."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out: dict = {}
    for e in events:
        out.setdefault(e["name"], []).append(e["dur"] / 1e6)
    return out


@dataclass
class Trace:
    """A torch.profiler chrome trace of the window, reduced."""
    device: list            # (name, ts_us, dur_us, correlation)
    launches: dict          # correlation -> launch ts_us
    ranges: dict            # bench key -> [(ts_us, te_us)]
    t0_us: float
    t1_us: float

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        device, launches, ranges = [], {}, {}
        lo, hi = float("inf"), float("-inf")
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                device.append((e["name"], ts, dur, corr))
            elif cat in LAUNCH_CATS and corr is not None:
                launches[corr] = ts
            elif cat == "user_annotation" and e["name"].startswith("bench:"):
                ranges.setdefault(e["name"][6:], []).append((ts, ts + dur))
            if cat not in ("gpu_user_annotation",):
                lo, hi = min(lo, ts), max(hi, ts + dur)
        return cls(device, launches, ranges, lo, hi)

    def busy_intervals(self) -> list:
        iv = sorted((ts, ts + dur) for _, ts, dur, _ in self.device)
        out = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def launched_in(self, key: str, name_part: str = "") -> list:
        """Device operations launched while a `bench:<key>` range was open
        on the host (and whose name holds `name_part`)."""
        rs = sorted(self.ranges.get(key, []))
        if not rs:
            return []
        import bisect
        starts = [a for a, _ in rs]
        out = []
        for op in self.device:
            if name_part and name_part not in op[0]:
                continue
            t = self.launches.get(op[3])
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= rs[i][1]:
                out.append(op)
        return out

    def top_ops(self, k: int = 10) -> list:
        tot: dict = {}
        for name, _, dur, _ in self.device:
            tot[name] = tot.get(name, 0.0) + dur / 1e6
        return sorted(tot.items(), key=lambda p: -p[1])[:k]

    def idle_by_span(self, t0_us: float, t1_us: float, k: int = 10) -> list:
        """Idle device time inside [t0, t1] by what the host was doing: each
        stretch of a gap goes to the innermost `bench:` range open on the
        host then (the spied calls of one thread nest, so a sweep with a
        stack finds it), or to "outside the spied calls"."""
        events = [(t0_us, 0, None), (t1_us, 3, None)]
        for a, b in self.busy_intervals():
            events.append((a, 2, None))         # the device gets busy
            events.append((b, 1, None))         # and idle again
        for key, rs in self.ranges.items():
            for a, b in rs:
                events.append((a, 4, key))
                events.append((b, 5, key))
        events.sort(key=lambda e: e[0])
        stack: list = []
        busy = 0
        tot: dict = {}
        prev = t0_us
        for t, kind, key in events:
            t = min(max(t, t0_us), t1_us)
            if busy == 0 and t > prev:
                label = stack[-1] if stack else "outside the spied calls"
                tot[label] = tot.get(label, 0.0) + (t - prev) / 1e6
            prev = max(prev, t)
            if kind == 2:
                busy += 1
            elif kind == 1:
                busy -= 1
            elif kind == 4:
                stack.append(key)
            elif kind == 5 and key in stack:
                del stack[len(stack) - 1 - stack[::-1].index(key)]
        return sorted(tot.items(), key=lambda p: -p[1])[:k]
