"""Flattened tensor view of the MAT, resident on the device (counterpart of
usher_tpu/core/flat.py).

  st [cap, P_pad]  path-state nibble per (node slot, segregating position)
  parent [cap]     parent slot per node slot

Slots are stable across tree surgery: a placement appends slots and never
changes an existing node's path state, so the device arrays are patched row
by row (``sync``) instead of rebuilt.  A host mirror (``st_host``,
``parent_slot``) takes the edits first.  Order metadata (BFS rank, leaf
counts) is recomputed on the host per scoring call.

With a device mesh (parallel/mesh.py) the [cap, P_pad] rows are split over
the mesh's "model" shards and the parent path states ``stp`` are kept
beside ``st``, on the host and on the device, so that a node shard scores
without reading another shard's rows.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .nuc import N as NUC_N
from .tree import Node, Tree

_LANE = 128


def _pad_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m if n else m


def collect_positions(T: Tree, vcf=None):
    """Union of tree mutation positions and VCF site positions, sorted.

    Returns (positions int64[P], ref uint8[P], chrom str).
    """
    pos_ref: dict[int, int] = {}
    chrom = ""
    if vcf is not None:
        for site in vcf.sites:
            pos_ref[site.position] = site.ref_nuc
            chrom = chrom or site.chrom
    for node in T.breadth_first_expansion():
        for m in node.mutations:
            if m.position >= 0 and m.position not in pos_ref:
                pos_ref[m.position] = m.ref_nuc
                chrom = chrom or m.chrom
    positions = np.array(sorted(pos_ref), dtype=np.int64)
    ref = np.array([pos_ref[p] for p in positions.tolist()], dtype=np.uint8)
    return positions, ref, chrom


class FlatMAT:
    """The MAT as device tensors ``st`` [cap, P_pad] uint8 and ``parent``
    [cap] int32 on ``device``, with their host mirrors.

    mesh: optional parallel.mesh.Mesh with ("data", "model") axes.  Then
    ``st`` and ``stp`` live node-sharded over "model" (nested lists
    ``x[d][m]`` of [cap / model, P_pad] tensors, see parallel/mesh.py),
    ``stp_host`` mirrors stp, ``device`` is the mesh's lead device, and
    ``cap`` is kept a multiple of the model size."""

    def __init__(self, T: Tree, positions: np.ndarray, ref: np.ndarray,
                 chrom: str = "", device: torch.device | str = "cpu",
                 mesh=None):
        self.tree = T
        self.mesh = mesh
        self.device = torch.device(device) if mesh is None else mesh.lead
        self.positions = positions
        self.pos_index = {int(p): i for i, p in enumerate(positions)}
        self.chrom = chrom
        self.P = len(positions)
        self.P_pad = _pad_to(self.P, _LANE)
        self.ref = np.zeros(self.P_pad, dtype=np.uint8)
        self.ref[: self.P] = ref
        self.ref_dev = torch.from_numpy(self.ref).to(self.device, copy=True)

        nodes = T.depth_first_expansion()
        n = len(nodes)
        # a multiple of the lane width and, under a mesh, of the model size
        # (doubling in _grow keeps both)
        unit = _LANE if mesh is None else math.lcm(_LANE, mesh.shape["model"])
        self.cap = _pad_to(n + max(64, n // 4), unit)
        self.n_slots = 0
        self.st_host = np.zeros((self.cap, self.P_pad), dtype=np.uint8)
        self.parent_slot = np.zeros(self.cap, dtype=np.int32)
        self._slot_node: list[Node | None] = [None] * self.cap

        for node in nodes:
            slot = self.n_slots
            self.n_slots += 1
            node.slot = slot
            self._slot_node[slot] = node
            if node.parent is None:
                row = self.ref.copy()
            else:
                self.parent_slot[slot] = node.parent.slot
                row = self.st_host[node.parent.slot].copy()
            for m in node.mutations:
                if m.position >= 0:
                    row[self.pos_index[m.position]] = m.mut_nuc
            self.st_host[slot] = row

        self.root_slot = T.root.slot
        if mesh is not None:
            self.stp_host = self.st_host[self.parent_slot].copy()
            self.stp_host[self.root_slot] = self.st_host[self.root_slot]
        else:
            self.stp_host = None
        self._put_device()
        self._dirty: list[int] = []

    # --- incremental maintenance -------------------------------------------

    def _put_device(self) -> None:
        # copy=True: on the CPU the device arrays must not alias the host
        # mirror, or host edits would reach them before sync()
        if self.mesh is not None:
            from ..parallel.mesh import put_nodes, put_replicated
            self._st_dev = put_nodes(self.mesh, self.st_host)
            self._stp_dev = put_nodes(self.mesh, self.stp_host)
            self.ref_mesh = put_replicated(self.mesh, self.ref)
        else:
            self._st_dev = torch.from_numpy(self.st_host).to(self.device,
                                                              copy=True)
            self._stp_dev = None
        self._parent_dev = torch.from_numpy(self.parent_slot).to(
            self.device, copy=True)

    def _grow(self, min_cap: int) -> None:
        new_cap = self.cap
        while new_cap < min_cap:
            new_cap *= 2
        st = np.zeros((new_cap, self.P_pad), dtype=np.uint8)
        st[: self.cap] = self.st_host
        self.st_host = st
        par = np.zeros(new_cap, dtype=np.int32)
        par[: self.cap] = self.parent_slot
        self.parent_slot = par
        if self.stp_host is not None:
            stp = np.zeros((new_cap, self.P_pad), dtype=np.uint8)
            stp[: self.cap] = self.stp_host
            self.stp_host = stp
        self._slot_node.extend([None] * (new_cap - self.cap))
        self.cap = new_cap
        self._put_device()
        self._dirty = []

    def add_node(self, node: Node) -> int:
        """Register a newly created tree node; its path state derives from its
        (already registered) parent plus its branch mutations."""
        if self.n_slots + 1 > self.cap:
            self._grow(self.n_slots + 1)
        slot = self.n_slots
        self.n_slots += 1
        node.slot = slot
        self._slot_node[slot] = node
        parent = node.parent
        self.parent_slot[slot] = parent.slot if parent is not None else slot
        parent_row = (self.st_host[parent.slot] if parent is not None
                      else self.ref)
        row = parent_row.copy()
        for m in node.mutations:
            if m.position >= 0:
                row[self.pos_index[m.position]] = m.mut_nuc
        self.st_host[slot] = row
        if self.stp_host is not None:
            self.stp_host[slot] = parent_row
        self._dirty.append(slot)
        return slot

    def reparent(self, node: Node) -> None:
        """Record a parent change (a sibling split re-grafts the best node
        under a new internal node); path states are unchanged, only the
        parent pointer and hence the node's stp row move."""
        self.parent_slot[node.slot] = node.parent.slot
        if self.stp_host is not None:
            self.stp_host[node.slot] = self.st_host[node.parent.slot]
            self._dirty.append(node.slot)
        else:
            self._dirty.append(-1)  # parent array refresh marker

    def _patch_shards(self, slots) -> None:
        """Write the host rows ``slots`` of st and stp into the node shards
        that own them (every distinct tensor of a shard once)."""
        rows_per = self.cap // self.mesh.shape["model"]
        slots = np.asarray(slots, dtype=np.int64)
        owner = slots // rows_per
        for m in np.unique(owner).tolist():
            mine = slots[owner == m]
            local = mine - m * rows_per
            for host, sharded in ((self.st_host, self._st_dev),
                                  (self.stp_host, self._stp_dev)):
                done = set()
                for per_d in sharded:
                    t = per_d[m]
                    if id(t) in done:
                        continue
                    done.add(id(t))
                    idx = torch.from_numpy(local).to(t.device)
                    t[idx] = torch.from_numpy(host[mine]).to(t.device)

    def sync(self):
        """Flush pending host-side edits to the device; returns (st, parent)
        (under a mesh st is the node-sharded nested list).

        Dirty rows are written with one indexed store; the slots are unique
        and sorted, so the store sees no duplicate index."""
        if self._dirty:
            slots = sorted({s for s in self._dirty if s >= 0})
            if slots and self.mesh is not None:
                self._patch_shards(slots)
            elif slots:
                idx = torch.tensor(slots, dtype=torch.long, device=self.device)
                rows = torch.from_numpy(self.st_host[slots]).to(self.device)
                self._st_dev[idx] = rows
            self._parent_dev = torch.from_numpy(self.parent_slot).to(
                self.device, copy=True)
            self._dirty = []
        return self._st_dev, self._parent_dev

    def sync_mesh(self):
        """Mesh-mode flush: returns (st, stp), both node-sharded over the
        "model" axis."""
        if self.mesh is None:
            raise ValueError("sync_mesh needs a FlatMAT built with a mesh")
        self.sync()
        return self._st_dev, self._stp_dev

    # --- per-call metadata --------------------------------------------------

    def order_arrays(self):
        """BFS rank, subtree leaf counts, leaf/active masks per slot (numpy),
        plus the BFS node list (host) for interpreting results."""
        bfs = self.tree.breadth_first_expansion()
        active = np.zeros(self.cap, dtype=bool)
        is_leaf = np.zeros(self.cap, dtype=bool)
        bfs_rank = np.full(self.cap, -1, dtype=np.int32)
        num_leaves = np.zeros(self.cap, dtype=np.int32)
        for rank, node in enumerate(bfs):
            s = node.slot
            active[s] = True
            is_leaf[s] = node.is_leaf()
            bfs_rank[s] = rank
        for node in reversed(bfs):
            s = node.slot
            if node.is_leaf():
                num_leaves[s] = 1
            if node.parent is not None:
                num_leaves[node.parent.slot] += num_leaves[s]
        is_root_mask = np.zeros(self.cap, dtype=bool)
        is_root_mask[self.tree.root.slot] = True
        self.root_slot = self.tree.root.slot
        return {
            "bfs": bfs,
            "active": active,
            "is_leaf": is_leaf,
            "bfs_rank": bfs_rank,
            "num_leaves": num_leaves,
            "is_root_mask": is_root_mask,
        }

    # --- sample encoding ----------------------------------------------------

    def encode_samples(self, samples_mutations):
        """Mutation lists -> (g [B,P_pad] uint8 ref-filled, E bool, miss bool),
        as numpy arrays."""
        B = len(samples_mutations)
        g = np.tile(self.ref, (B, 1))
        E = np.zeros((B, self.P_pad), dtype=bool)
        miss = np.zeros((B, self.P_pad), dtype=bool)
        for b, muts in enumerate(samples_mutations):
            for m in muts:
                idx = self.pos_index.get(m.position)
                if idx is None:
                    raise KeyError(f"sample position {m.position} not in MAT position set")
                E[b, idx] = True
                if m.is_missing:
                    miss[b, idx] = True
                    g[b, idx] = NUC_N
                else:
                    g[b, idx] = m.mut_nuc
        return g, E, miss
