"""Sharded placement over several devices from one process (counterpart of
usher_tpu/parallel/mesh.py).

The flat MAT's node axis is split over the "model" mesh axis and the sample
batch over the "data" axis.  Scoring needs no traffic between shards: shard
(d, m) scores its node rows against its samples, with the parent path
states stp kept beside st so a node shard is self-contained.  The reduction
over the node axis, which XLA inserted as a collective, is an explicit exact
merge of per-shard tie-break partials on the lead device
(ops/placement_sparse.merge_partials, the merge the B2 kernel's node blocks
use): the min score, the count summed over the shards that reach it, the
max leaves among them, then the max BFS rank.

One process drives every shard.  Shard (d, m) lives on visible device
(d * model + m) % device_count of the mesh's platform and works on a stream
of its own; on the CPU every shard is a CPU tensor.  A mesh may hold more
shards than the machine has cards: they then share a card (as virtual host
devices let a JAX mesh run on one CPU), which checks the sharding and the
merge exactly and gains no speed.

A sharded array is a nested list ``x[d][m]`` of the tensor that shard
(d, m) reads or wrote.  A node-sharded array repeats shard m along d, a
batch-sharded one repeats shard d along m; repeats that fall on one device
are one tensor.

Mesh axes:
  data   -- sample batch
  model  -- tree node slots

mesh B1: ``sharded_sparse_score_fn`` runs the B1 CUDA kernel
(ops/placement_sparse.score_entries_T) once per shard, where the JAX
package ran its Pallas kernel under a shard_map; ``sharded_placement_reduce``
does the same with the B2 partials kernel.  ``sharded_sparse_score_plain``
is the plain PyTorch twin.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import placement as dev
from ..ops import placement_sparse as ps
from ..utils.device import apply_platform_env


class Mesh:
    """A grid of devices with named axes (the small part of
    jax.sharding.Mesh that the port uses): ``devices`` is an object array of
    torch.device, ``shape`` maps axis name to size."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-D device array for axes "
                             f"{self.axis_names}")
        self._streams: dict = {}

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def lead(self) -> torch.device:
        """The device that merges the shards' results."""
        return self.devices.flat[0]

    def indices(self):
        return list(np.ndindex(*self.devices.shape))

    def flattened(self, axis: str = "batch") -> "Mesh":
        """The same devices as a 1-D mesh (for batch-only sharding)."""
        return Mesh(self.devices.reshape(-1), (axis,))

    def stream(self, idx):
        """The CUDA stream of shard ``idx`` (made at first use; None on the
        CPU)."""
        device = self.devices[idx]
        if device.type != "cuda":
            return None
        if idx not in self._streams:
            self._streams[idx] = torch.cuda.Stream(device=device)
        return self._streams[idx]

    def __repr__(self):
        return f"Mesh({self.shape}, lead={self.lead})"


def mesh_devices(n_devices, device=None):
    """n_devices torch devices of the platform of ``device`` (default: from
    USHER_TPU_PLATFORM): shard i gets visible card i % device_count, or the
    CPU.  n_devices None or <= 0 means one shard per card."""
    device = torch.device(device) if device is not None else \
        apply_platform_env()
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        n = cards if not n_devices or n_devices <= 0 else n_devices
        if n > cards:
            print(f"{n} mesh shards share {cards} CUDA device(s).",
                  file=sys.stderr)
        return [torch.device("cuda", i % cards) for i in range(n)]
    n = 1 if not n_devices or n_devices <= 0 else n_devices
    return [device] * n


def make_mesh(n_devices: int | None = None, data: int | None = None,
              device=None) -> Mesh:
    """A 2-D (data, model) mesh of n_devices shards."""
    devs = mesh_devices(n_devices, device)
    n_devices = len(devs)
    if data is None:
        # favor the node (model) axis: trees are large, batches modest
        data = 2 if (n_devices % 2 == 0 and n_devices >= 4) else 1
    model = n_devices // data
    dev_array = np.empty((data, model), dtype=object)
    for i in range(data * model):
        dev_array[i // model, i % model] = devs[i]
    return Mesh(dev_array, axis_names=("data", "model"))


def for_each_shard(mesh: Mesh, fn):
    """Run fn(idx) for every shard index of the mesh, on the shard's device
    and stream, and return the results in a dict by index.

    On CUDA each shard's stream first waits for what is queued on its
    device's current stream (the inputs), and afterwards that current stream
    waits on an event of the shard's stream, so later work and host copies
    are ordered after every shard without a device-wide synchronize.
    Shards that share a card overlap on their streams."""
    out = {}
    events = []
    for idx in mesh.indices():
        stream = mesh.stream(idx)
        if stream is None:
            out[idx] = fn(idx)
            continue
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        with torch.cuda.stream(stream):
            out[idx] = fn(idx)
            events.append((stream.device, stream.record_event()))
    for device, event in events:
        torch.cuda.current_stream(device).wait_event(event)
    return out


# --- placing arrays on the mesh ----------------------------------------------

def split_bounds(n: int, parts: int):
    """Even split of n rows over parts shards: [(lo, hi)], the last shards
    shorter (or empty) when parts does not divide n."""
    size = -(-n // parts) if n else 0
    return [(min(i * size, n), min((i + 1) * size, n)) for i in range(parts)]


def _place(mesh: Mesh, piece_of):
    """x[d][m] = the array piece_of(d, m) -> (key, numpy array) as a tensor
    on device (d, m); pieces with one key on one device share a tensor."""
    data, model = mesh.devices.shape
    cache = {}
    out = [[None] * model for _ in range(data)]
    for d in range(data):
        for m in range(model):
            key, arr = piece_of(d, m)
            device = mesh.devices[d, m]
            if (key, device) not in cache:
                cache[key, device] = torch.from_numpy(
                    np.ascontiguousarray(arr)).to(device, copy=True)
            out[d][m] = cache[key, device]
    return out


def put_nodes(mesh: Mesh, arr):
    """Node-sharded: axis 0 split over "model", repeated along "data"."""
    arr = np.asarray(arr)
    bounds = split_bounds(arr.shape[0], mesh.shape["model"])
    return _place(mesh, lambda d, m: (m, arr[bounds[m][0]:bounds[m][1]]))


def put_batch(mesh: Mesh, arr):
    """Batch-sharded: axis 0 split over "data", repeated along "model"."""
    arr = np.asarray(arr)
    bounds = split_bounds(arr.shape[0], mesh.shape["data"])
    return _place(mesh, lambda d, m: (d, arr[bounds[d][0]:bounds[d][1]]))


def put_replicated(mesh: Mesh, arr):
    arr = np.asarray(arr)
    return _place(mesh, lambda d, m: (0, arr))


def shard_flat_inputs(mesh: Mesh, st, stp, ref, active, num_leaves, bfs_rank,
                      is_leaf, is_root_mask, g, E, miss):
    """Place the flat-MAT arrays (numpy) on the mesh: node axis on "model",
    sample batch on "data", reference row replicated.  It takes the very
    arrays the JAX package's shard_flat_inputs takes, so one seed feeds
    both."""
    return (put_nodes(mesh, st), put_nodes(mesh, stp),
            put_replicated(mesh, ref),
            put_nodes(mesh, active), put_nodes(mesh, num_leaves),
            put_nodes(mesh, bfs_rank), put_nodes(mesh, is_leaf),
            put_nodes(mesh, is_root_mask),
            put_batch(mesh, g), put_batch(mesh, E), put_batch(mesh, miss))


def shard_sparse_inputs(mesh: Mesh, st, stp, ref, pos, gval, kmiss):
    """The numpy arguments of the JAX package's sharded_sparse_score_fn as
    the port's per-shard tensors."""
    return (put_nodes(mesh, st), put_nodes(mesh, stp),
            put_replicated(mesh, ref), put_batch(mesh, pos),
            put_batch(mesh, gval), put_batch(mesh, kmiss))


def gather_blocks(blocks, node_axis: int = 0):
    """The whole matrix of x[d][m] blocks (node shard m, batch shard d) as a
    numpy array, nodes along ``node_axis`` and samples along the other."""
    rows = [np.concatenate([b.cpu().numpy() for b in per_d], axis=node_axis)
            for per_d in blocks]
    return np.concatenate(rows, axis=1 - node_axis)


def gather_nodes(shards):
    """The whole [N] vector of node-sharded x[d][m] (read along d = 0)."""
    return np.concatenate([t.cpu().numpy() for t in shards[0]])


# --- the dense step ------------------------------------------------------------

def _zeros(n: int, b: int, device):
    """The [n, b] int32 block of an empty shard."""
    return torch.zeros((n, b), dtype=torch.int32, device=device)


def _placement_step(st, stp, ref, active, num_leaves, bfs_rank, is_leaf,
                    is_root_mask, g, E, miss):
    """Full placement step on one device: score all nodes x all samples,
    then reduce to the per-sample best with the reference tie-break
    (usher_mapper.cpp:452-497).

    Returns (best_score [B], best_rank [B], num_best [B]) where best_rank
    is the BFS rank of the winner; the host resolves the node.
    """
    parts = _dense_partials(st, stp, ref, active, num_leaves, bfs_rank,
                            is_leaf, is_root_mask, g, E, miss)
    return ps.merge_partials(*parts)


def _dense_partials(st, stp, ref, active, num_leaves, bfs_rank, is_leaf,
                    is_root_mask, g, E, miss):
    """Tie-break partials [4, 1, B] of one node shard from the dense
    formula."""
    n, b = st.shape[0], g.shape[0]
    if n == 0 or b == 0:
        z = _zeros(n, b, st.device)
        return ps.partials_plain(z, z, z.new_zeros(n), active, is_leaf,
                                 is_root_mask, num_leaves, bfs_rank)
    score, num_common, node_num_mut = dev.score_with_stp(
        st, stp, ref, active, g, E, miss)
    return ps.partials_plain(score.T, num_common.T, node_num_mut, active,
                             is_leaf, is_root_mask, num_leaves, bfs_rank)


def _merge_over_model(mesh: Mesh, parts):
    """parts[(d, m)] -> [4, n_parts, B_d] partials; merged over the node
    shards on the lead device and concatenated over the batch shards."""
    data, model = mesh.devices.shape
    lead = mesh.lead
    per_d = []
    for d in range(data):
        stacked = torch.cat([parts[d, m].to(lead) for m in range(model)],
                            dim=1)
        per_d.append(ps.merge_partials(*stacked))
    return tuple(torch.cat(col) for col in zip(*per_d))


def sharded_placement_step(mesh: Mesh):
    """The placement step over the mesh: fn(*shard_flat_inputs(...)) ->
    (best_score, best_rank, num_best) [B] on the lead device.  Each shard
    reduces its node rows to tie-break partials; the merge over the node
    axis is exact."""
    def fn(st, stp, ref, active, num_leaves, bfs_rank, is_leaf,
           is_root_mask, g, E, miss):
        parts = for_each_shard(mesh, lambda i: _dense_partials(
            *(x[i[0]][i[1]] for x in (st, stp, ref, active, num_leaves,
                                       bfs_rank, is_leaf, is_root_mask,
                                       g, E, miss))))
        return _merge_over_model(mesh, parts)
    return fn


def sharded_score_fn(mesh: Mesh):
    """The raw dense scorer over the mesh: fn(st, stp, ref, active, g, E,
    miss) on sharded inputs -> (score, num_common) as x[d][m] blocks
    [B_d, N_m] and node_num_mut node-sharded [N_m]."""
    def fn(st, stp, ref, active, g, E, miss):
        data, model = mesh.devices.shape

        def one(idx):
            d, m = idx
            n, b = st[d][m].shape[0], g[d][m].shape[0]
            if n == 0 or b == 0:
                z = _zeros(b, n, st[d][m].device)
                return z, z.clone(), z.new_zeros(n)
            return dev.score_with_stp(st[d][m], stp[d][m], ref[d][m],
                                      active[d][m], g[d][m], E[d][m],
                                      miss[d][m])
        res = for_each_shard(mesh, one)
        return tuple([[res[d, m][k] for m in range(model)]
                      for d in range(data)] for k in range(3))
    return fn


# --- mesh B1 and the sharded B2 -------------------------------------------------

def _node_reductions(mesh: Mesh, st, stp, ref):
    """row_reductions of every node shard, once per distinct shard tensor
    (repeats along "data" on one device share it), on the current streams."""
    cache = {}
    out = {}
    for d, m in mesh.indices():
        key = id(st[d][m])
        if key not in cache:
            cache[key] = ps.row_reductions(st[d][m], stp[d][m], ref[d][m])
        out[d, m] = cache[key]
    return out


def _sparse_blocks(mesh: Mesh, st, stp, ref, pos, gval, kmiss, score_fn):
    data, model = mesh.devices.shape
    red = _node_reductions(mesh, st, stp, ref)

    def one(idx):
        d, m = idx
        s = st[d][m]
        n, b = s.shape[0], pos[d][m].shape[0]
        if n == 0 or b == 0:
            z = _zeros(n, b, s.device)
            return z, z.clone()
        base, nc_base, _ = red[idx]
        return score_fn(s, stp[d][m], ref[d][m], base, nc_base, pos[d][m],
                        gval[d][m], kmiss[d][m])
    res = for_each_shard(mesh, one)
    blocks = tuple([[res[d, m][k] for m in range(model)]
                    for d in range(data)] for k in range(2))
    nnm = [[red[d, m][2] for m in range(model)] for d in range(data)]
    return blocks[0], blocks[1], nnm


def sharded_sparse_score_fn(mesh: Mesh):
    """mesh B1: sparse scoring under the (data, model) mesh.  fn(st, stp,
    ref, pos, gval, kmiss) on sharded inputs (``shard_sparse_inputs``) ->
    (score_T, num_common_T) as x[d][m] blocks [N_m, B_d] int32 and
    node_num_mut node-sharded [N_m]: ops/placement_sparse.score_sparse_stp_T
    per shard, so every shard runs the B1 CUDA kernel on its own device and
    stream (the plain twin on CPU tensors).  Any slot count K runs, so the
    JAX function's k_slots argument is gone.  Its kernel launches are
    counted where they are made, in ``ps.score_entries_T.launches``."""
    def fn(st, stp, ref, pos, gval, kmiss):
        return _sparse_blocks(mesh, st, stp, ref, pos, gval, kmiss,
                              ps.score_entries_T)
    return fn


def sharded_sparse_score_plain(mesh: Mesh, st, stp, ref, pos, gval, kmiss):
    """Plain twin of mesh B1: the per-shard loop over
    ``score_entries_T_plain``; same inputs and outputs as the function that
    ``sharded_sparse_score_fn`` returns."""
    return _sparse_blocks(mesh, st, stp, ref, pos, gval, kmiss,
                          ps.score_entries_T_plain)


def sharded_placement_reduce(mesh: Mesh, st, stp, ref, active, is_leaf,
                             is_root_mask, num_leaves, bfs_rank, pos, gval,
                             kmiss):
    """The fused sparse step over the mesh (B2 per shard): every shard
    reduces its node rows against its samples to tie-break partials
    (ops/placement_sparse.placement_partials, the B2 kernel on CUDA), and
    the partials are merged exactly over the node shards.  bfs_rank holds
    global ranks.  Returns (best_score, best_rank, num_best) [B] int32 on
    the lead device."""
    red = _node_reductions(mesh, st, stp, ref)

    def one(idx):
        d, m = idx
        s = st[d][m]
        n, b = s.shape[0], pos[d][m].shape[0]
        node = tuple(x[d][m] for x in (active, is_leaf, is_root_mask,
                                       num_leaves, bfs_rank))
        if n == 0 or b == 0:
            z = _zeros(n, b, s.device)
            return ps.partials_plain(z, z, red[idx][2], *node)
        base, nc_base, nnm = red[idx]
        return ps.placement_partials(s, stp[d][m], ref[d][m], base, nc_base,
                                     nnm, *node, pos[d][m], gval[d][m],
                                     kmiss[d][m])
    return _merge_over_model(mesh, for_each_shard(mesh, one))
