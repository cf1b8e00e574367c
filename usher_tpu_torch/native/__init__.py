"""Compiled host scanners (counterpart of usher_tpu/native/): the
transpose-VCF codec, the VCF parsers and the pb / newick scanners of
src/usher_native.cpp, built with g++ at first use (native/_build.py).

As in the JAX package, callers use the compiled scanner where it is built
and the pure-Python one otherwise, through the same two names: ``ext`` (the
extension module, or None) and ``HAVE_NATIVE``.  Here they are resolved at
first use (PEP 562), so importing the package builds nothing.  A failed
build is not quiet: it prints one line on stderr, and ``available()`` /
``build_error()`` say which scanner is in use.
"""

from __future__ import annotations

import functools
import sys


@functools.lru_cache(maxsize=None)
def _loaded():
    """(module, None) once built and loaded, or (None, the error)."""
    from . import _build
    try:
        return _build.load(_build.build()), None
    except (OSError, RuntimeError, ImportError) as e:
        err = str(e)
        first = next((ln for ln in err.splitlines() if "error" in ln),
                     err.splitlines()[0] if err else "")
        print(f"usher_tpu_torch.native: compiled scanner not built, using "
              f"the pure-Python one: {first.strip()}", file=sys.stderr)
        return None, err


def __getattr__(name):
    if name == "ext":
        return _loaded()[0]
    if name == "HAVE_NATIVE":
        return available()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def available() -> bool:
    """Whether the compiled scanner is in use (builds it on the first
    call)."""
    return _loaded()[0] is not None


def build_error() -> str | None:
    """The compiler's (or loader's) error when the build failed, else None."""
    return _loaded()[1]
