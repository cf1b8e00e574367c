"""Tracing / profiling: Chrome-trace scopes + stage timers.

Parity with the reference's Instrumentor (src/Instrumentor.h:37-139, enabled
by -DSAVE_PROFILE and the TIMEIT() macro) and the coarse `Timer` that prints
"Completed in N msec" after each stage (src/usher_graph.hpp:15-31).

  - `Instrumentor.begin_session(path)` / `end_session()` write the same
    chrome://tracing JSON the reference emits ({"otherData": {},
    "traceEvents": [...]} with "ph": "X" duration events in microseconds).
  - `timeit(name)` is the TIMEIT() macro: a context manager recording a
    trace scope (no-op when no session is active).
  - `Timer` mirrors the reference Timer: Start()/Stop() in milliseconds.
  - Sessions can be armed externally with USHER_TPU_PROFILE=<path> — the
    CLIs call `maybe_begin_session_from_env()` at startup.

  - `device_trace(logdir)` records a device-level trace through
    torch.profiler (the JAX package's wraps jax.profiler) and writes it
    into logdir as a Chrome trace.

Device selection lives in utils/device.py.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time


class Instrumentor:
    _instance = None

    def __init__(self):
        self._f = None
        self._count = 0
        self._lock = threading.Lock()

    @classmethod
    def get(cls) -> "Instrumentor":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    @property
    def active(self) -> bool:
        return self._f is not None

    def begin_session(self, filepath: str = "profile.json") -> None:
        self._f = open(filepath, "w")
        self._f.write('{"otherData": {},"traceEvents":[')
        self._f.flush()
        self._count = 0

    def end_session(self) -> None:
        if self._f is None:
            return
        self._f.write("]}")
        self._f.close()
        self._f = None

    def write_profile(self, name: str, start_us: int, end_us: int) -> None:
        if self._f is None:
            return
        with self._lock:
            if self._count > 0:
                self._f.write(",")
            self._count += 1
            self._f.write(json.dumps({
                "cat": "function",
                "dur": end_us - start_us,
                "name": name.replace('"', "'"),
                "ph": "X",
                "pid": 0,
                "tid": threading.get_ident() & 0xFFFFFFFF,
                "ts": start_us,
            }))
            self._f.flush()


@contextlib.contextmanager
def timeit(name: str):
    """The TIMEIT() macro: records a duration event when a session is
    active; near-zero cost otherwise."""
    inst = Instrumentor.get()
    if not inst.active:
        yield
        return
    start = time.time_ns() // 1000
    try:
        yield
    finally:
        inst.write_profile(name, start, time.time_ns() // 1000)


class Timer:
    """Reference src/usher_graph.hpp:15-31: Start(); ...; Stop() -> msec."""

    def __init__(self):
        self._t0 = time.time()

    def start(self) -> None:
        self._t0 = time.time()

    def stop(self) -> int:
        return int((time.time() - self._t0) * 1000)

    def report(self, stream=None) -> int:
        """Print the reference's stage line: 'Completed in N msec'."""
        ms = self.stop()
        print(f"Completed in {ms} msec \n", file=stream or sys.stderr)
        return ms


def maybe_begin_session_from_env() -> bool:
    """Arm chrome-trace profiling when USHER_TPU_PROFILE=<path> is set;
    registers end_session at exit."""
    path = os.environ.get("USHER_TPU_PROFILE", "")
    if not path:
        return False
    inst = Instrumentor.get()
    if not inst.active:
        inst.begin_session(path)
        import atexit
        atexit.register(inst.end_session)
    return True


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the enclosed block with torch.profiler and export a Chrome
    trace to ``logdir/trace.<pid>.json``: CPU and CUDA activity when the
    port runs on a card (USHER_TPU_PLATFORM, utils/device.py), CPU activity
    alone on the CPU.  Yields the profiler, whose ``key_averages()`` sums
    the time by op after the block."""
    from torch.profiler import ProfilerActivity, profile
    from .device import apply_platform_env
    activities = [ProfilerActivity.CPU]
    if apply_platform_env().type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir,
                                          f"trace.{os.getpid()}.json"))
