"""usher_tpu_torch: the PyTorch/CUDA port of usher_tpu for NVIDIA Hopper.

The JAX package ``usher_tpu`` stays the reference.  This package re-does its
device layers in PyTorch, with the Pallas kernels written again by hand in
CUDA C++ (``csrc/``), and keeps its own copy of the host layers (tree, I/O,
host oracle).  It imports neither jax nor anything of ``usher_tpu``.

The device is explicit: ``USHER_TPU_PLATFORM`` selects ``cuda`` (default) or
``cpu`` (utils/device.py).
"""

__version__ = "0.1.0"
