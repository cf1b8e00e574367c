"""Build and load the compiled host scanners (native/src/usher_native.cpp).

The source is compiled at first use with ``g++`` into a CPython extension
in ``build/usher_tpu_torch/`` beside the package, named by a hash of the
source, the flags and the interpreter's extension suffix, so an edited
source is rebuilt and an unchanged one is loaded as it is.  The compiler
writes a temporary file that ``os.replace`` moves into place, so processes
that build at the same moment (test workers) never load a half-written
library.  Nothing here runs at import time.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "native" / "src" / "usher_native.cpp"
BUILD_DIR = PKG_DIR.parent / "build" / "usher_tpu_torch"
# -pthread: parse_vcf_mt starts std::threads
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
MODULE = "_usher_native"   # its PyInit__usher_native


def _flags() -> list[str]:
    return [*CXX_FLAGS, "-I" + sysconfig.get_paths()["include"]]


def library_path(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Where the extension of `source` lives (built or not)."""
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    h = hashlib.sha256(" ".join([*_flags(), suffix]).encode())
    h.update(Path(source).read_bytes())
    return Path(build_dir) / f"{MODULE}_{h.hexdigest()[:16]}{suffix}"


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Compile `source` unless its library exists; return the library's
    path.  Raises RuntimeError with the compiler's output on failure."""
    out = library_path(source, build_dir)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler: g++ not found on PATH")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *_flags(), str(source), "-o", str(tmp), "-lz"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def load(path: Path):
    """Load the extension at `path` as module ``_usher_native``."""
    loader = importlib.machinery.ExtensionFileLoader(MODULE, str(path))
    spec = importlib.util.spec_from_file_location(MODULE, str(path),
                                                  loader=loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    return mod
