"""Dense placement scoring over [B, N, P] bit masks (counterpart of
usher_tpu/ops/placement.py; see its docstring for the derivation).

  st[n,p]   path state of node n;  stp[n,p] = st[parent(n), p]
  g[s,p]    sample allele mask (ref-filled; 0xF at missing entries)
  E, miss   sample has an entry / the entry is missing (N)

  matched = (g & st) != 0;  A = (bm & ~matched) ? stp : st
  score   = #{p : E & ~miss & (g & A) == 0} + #{p : ~E & A != ref}
  num_common = #{p : bm & matched};  node_num_mut = #{p : bm}

This is the plain path: torch ops only, chunked over the batch so the
[B, N, P] intermediates stay within ``CHUNK_ELEMS`` elements.  On the CPU it
is the engine's default backend.
"""

from __future__ import annotations

import torch

BIG = 1 << 30
CHUNK_ELEMS = 1 << 27  # elements of one [Bc, N, P] intermediate


def parent_states(st: torch.Tensor, parent: torch.Tensor,
                  root_slot: int) -> torch.Tensor:
    """stp = st[parent], with the root's row its own."""
    stp = st[parent.long()]
    stp[root_slot] = st[root_slot]
    return stp


def _chunk(B: int, per_sample: int) -> int:
    return max(1, min(B, CHUNK_ELEMS // max(1, per_sample)))


def score_with_stp(st, stp, ref, active, g, E, miss):
    """Core scoring given the parent path states.

    st/stp [N,P] uint8, ref [P] uint8, active [N] bool, g [B,P] uint8,
    E/miss [B,P] bool.  Returns (score [B,N] int32 with inactive slots at
    1 << 30, num_common [B,N] int32, node_num_mut [N] int32).
    """
    N, P = st.shape
    B = g.shape[0]
    bm = st != stp                                         # [N,P]
    node_num_mut = bm.sum(-1, dtype=torch.int32)
    score = torch.empty((B, N), dtype=torch.int32, device=st.device)
    num_common = torch.empty((B, N), dtype=torch.int32, device=st.device)
    bc = _chunk(B, N * P)
    for b0 in range(0, B, bc):
        sl = slice(b0, b0 + bc)
        gb = g[sl, None, :]
        matched = (gb & st[None]) != 0                     # [Bc,N,P]
        A = torch.where(bm[None] & ~matched, stp[None], st[None])
        Eb = E[sl, None, :]
        term1 = Eb & ~miss[sl, None, :] & ((gb & A) == 0)
        term2 = ~Eb & (A != ref[None, None, :])
        score[sl] = (term1 | term2).sum(-1, dtype=torch.int32)
        num_common[sl] = (bm[None] & matched).sum(-1, dtype=torch.int32)
    score = torch.where(active[None, :], score, BIG)
    return score, num_common, node_num_mut


def score_batch(st, parent, root_slot, ref, active, g, E, miss):
    """Score a batch of samples against all (active) nodes.

    st [N,P] uint8, parent [N] int32 (root -> itself), root_slot int,
    ref [P] uint8, active [N] bool, g [B,P] uint8, E/miss [B,P] bool.
    Returns (score [B,N], num_common [B,N], node_num_mut [N]) int32.
    """
    stp = parent_states(st, parent, root_slot)
    return score_with_stp(st, stp, ref, active, g, E, miss)


def valid_mask(score, num_common, node_num_mut, is_root_mask, is_leaf,
               active):
    """Validity and has_unique masks [B,N] (usher_mapper.cpp:452-455).
    Operators only, so it takes torch tensors and numpy arrays alike."""
    has_unique = num_common < node_num_mut[None, :]
    nc_pos = num_common > 0
    leaf = is_leaf[None, :]
    valid = (is_root_mask[None, :]
             | (leaf & nc_pos)
             | (~leaf & has_unique & nc_pos)
             | (~leaf & ~has_unique))
    return valid & active[None, :], has_unique


# the JAX package names the host-side use of the same math separately
placement_outputs = valid_mask


def reduce_best(score, valid, num_leaves, bfs_rank):
    """Per-sample argmin with the reference tie-break: minimize
    (score, -num_leaves, -bfs_rank) over valid nodes; also count ties.

    score [B,N] int32, valid [B,N] bool, num_leaves/bfs_rank [N] int32.
    Returns (best_score [B], best_slot [B], num_best [B]) int32; the slot is
    the first row holding the winning rank, as jnp.argmax picks it.
    """
    s = torch.where(valid, score, BIG)
    best_score = s.min(1).values
    is_best = valid & (score == best_score[:, None])
    num_best = is_best.sum(1, dtype=torch.int32)
    leaves_masked = torch.where(is_best, num_leaves[None, :], -1)
    best_leaves = leaves_masked.max(1).values
    is_best2 = is_best & (num_leaves[None, :] == best_leaves[:, None])
    rank_masked = torch.where(is_best2, bfs_rank[None, :], -1)
    best_rank = rank_masked.max(1).values
    hit = (bfs_rank[None, :] == best_rank[:, None]) & is_best2
    # torch.argmax returns the first maximal index, like jnp.argmax
    best_slot = torch.argmax(hit.to(torch.uint8), dim=1)
    return best_score, best_slot.to(torch.int32), num_best


def placement_step(st, parent, root_slot, ref, active, is_leaf,
                   is_root_mask, num_leaves, bfs_rank, g, E, miss):
    """Score all nodes x the batch, apply validity, reduce to the per-sample
    winner.  Returns (best_score [B], best_slot [B], num_best [B]) int32."""
    stp = parent_states(st, parent, root_slot)
    N, P = st.shape
    B = g.shape[0]
    outs = []
    bc = _chunk(B, N * P)
    for b0 in range(0, B, bc):
        sl = slice(b0, b0 + bc)
        score, num_common, node_num_mut = score_with_stp(
            st, stp, ref, active, g[sl], E[sl], miss[sl])
        valid, _ = valid_mask(score, num_common, node_num_mut, is_root_mask,
                              is_leaf, active)
        outs.append(reduce_best(score, valid, num_leaves, bfs_rank))
    return tuple(torch.cat(parts) for parts in zip(*outs))
