"""Build and load the port's hand-written CUDA kernels.

The sources under ``usher_tpu_torch/csrc/*.cu`` are compiled at first use
with ``nvcc`` for ``sm_90a`` into one shared library with a plain C
interface, which is loaded with ``ctypes``.  The library lands in
``build/usher_tpu_torch/`` beside the package, named by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  Nothing here runs at import time: the CPU tests import the
kernel modules on machines without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "usher_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# name -> argtypes of every C entry point in csrc/ (each returns cudaError_t)
_IP = ctypes.POINTER(ctypes.c_int)
# the launch plan of the scoring kernels: rows, stages, vec, lanes, grid
_PLAN = [_I, _I, _I, _I, _I]
SIGNATURES = {
    "usher_launch_limits": [_I, _IP, _IP, _IP, _IP],
    "usher_score_entries_T":
        [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, *_PLAN, _I, _P, _P, _P, _I,
         _P],
    "usher_score_entries_3d":
        [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, *_PLAN, _I, _I, _LL, _P, _P,
         _P, _I, _P],
    "usher_placement_partials":
        [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, *_PLAN, _P, _P, _I, _P],
}


def _sources() -> list[Path]:
    return sorted(list(SRC_DIR.glob("*.cu")) + list(SRC_DIR.glob("*.cuh")))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           f"{cuda_home}/bin): cannot build the CUDA kernels")
    return path


def library_path(defines: tuple = ()) -> Path:
    """Where the library for the current sources, built with the macros
    `defines`, lives (built or not)."""
    h = hashlib.sha256(" ".join([*NVCC_FLAGS, *defines]).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libusher_tpu_torch_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load_library(defines: tuple = ()) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure.
    `defines` are preprocessor macros of a variant build (USHER_PROFILE:
    the phase clocks of tools/kernel_profile.py)."""
    out = library_path(defines)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o",
               str(tmp),
               *[str(s) for s in _sources() if s.suffix == ".cu"]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        out.with_suffix(".log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.usher_error_string.argtypes = [ctypes.c_int]
    lib.usher_error_string.restype = ctypes.c_char_p
    return lib


def build_log() -> str:
    """nvcc's output (ptxas register and shared-memory report) for the
    loaded library, or "" when the library was built by another process."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check(err: int, what: str) -> None:
    """Raise when a C launcher returned a CUDA error."""
    if err != 0:
        msg = load_library().usher_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
