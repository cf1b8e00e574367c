"""Batch-axis sharding helpers (counterpart of usher_tpu/parallel/shard.py):
a 1-D mesh over which a sample batch is split while the tree's arrays are
replicated.  The BigMAT engine's batch mesh uses them.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import Mesh, mesh_devices, split_bounds


def batch_mesh(n_devices: int | None = None, axis: str = "batch",
               device=None) -> Mesh:
    """A 1-D mesh of n_devices shards (one per card when None or <= 0)."""
    devs = mesh_devices(n_devices, device)
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr, axis_names=(axis,))


def put_batch(mesh: Mesh, arr, axis_index: int = 0):
    """``arr`` split along dimension ``axis_index`` over the 1-D mesh: a
    list of one tensor per shard, on the shard's device."""
    arr = np.asarray(arr)
    out = []
    for i, (lo, hi) in enumerate(split_bounds(arr.shape[axis_index],
                                              mesh.size)):
        piece = np.take(arr, np.arange(lo, hi), axis=axis_index)
        out.append(torch.from_numpy(np.ascontiguousarray(piece)).to(
            mesh.devices[i], copy=True))
    return out


def put_replicated(mesh: Mesh, arr):
    """``arr`` on every device of the 1-D mesh: a list of one tensor per
    shard; shards on one device share the tensor."""
    arr = np.ascontiguousarray(arr)
    cache = {}
    out = []
    for device in mesh.devices.tolist():
        if device not in cache:
            cache[device] = torch.from_numpy(arr).to(device, copy=True)
        out.append(cache[device])
    return out
