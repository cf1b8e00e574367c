"""Device selection for the port (counterpart of
usher_tpu/utils/instrument.py::apply_platform_env).

``USHER_TPU_PLATFORM`` names the device: ``cuda`` (the default) or ``cpu``.
A request for ``cuda`` on a machine without a card raises; the port never
moves to the CPU on its own.
"""

from __future__ import annotations

import os

import torch

PLATFORMS = ("cuda", "cpu")


def apply_platform_env(platform: str | None = None) -> torch.device:
    """Resolve the device from ``platform`` or ``USHER_TPU_PLATFORM`` and
    turn TF32 off for matmul and cuDNN (the port's arithmetic is integer
    parsimony, which TF32 would round)."""
    plat = platform or os.environ.get("USHER_TPU_PLATFORM", "") or "cuda"
    if plat not in PLATFORMS:
        raise ValueError(f"USHER_TPU_PLATFORM={plat!r}: the port runs on "
                         f"one of {PLATFORMS}")
    if plat == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("USHER_TPU_PLATFORM=cuda but torch sees no CUDA "
                           "device (set USHER_TPU_PLATFORM=cpu to run on "
                           "the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device(plat)
