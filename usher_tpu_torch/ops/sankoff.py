"""Whole-tree per-site Fitch-Sankoff state assignment as torch ops
(counterpart of usher_tpu/ops/sankoff.py; semantics in its docstring).

All sites are solved at once as a [N, S, 4] score tensor, the tree walked
level by level: one scatter-add into the parent rows per level leaf->root,
one gather of the parent states per level root->leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.tree import Mutation, Tree


def _pick_state(scores: torch.Tensor, par_state: torch.Tensor) -> torch.Tensor:
    """scores [..., 4] int32, par_state [...] int64 (0..3) -> state [...]:
    the parent's state when it is tied for the minimum, else the first
    minimal base (torch.argmin returns the first minimum, like jnp.argmin)."""
    min_s = scores.min(-1).values
    first_argmin = scores.argmin(-1)
    par_score = torch.gather(scores, -1, par_state[..., None])[..., 0]
    return torch.where(par_score == min_s, par_state, first_argmin)


def _sankoff_states(leaf_mask, is_leaf, parent, levels_desc, levels_asc,
                    ref_nt, num_nodes: int):
    """leaf_mask [N,S] uint8 nibble, is_leaf [N] bool, parent [N] int64,
    ref_nt [S] int64 (0..3), all on one device.

    levels_desc/levels_asc: sequences of int64 index tensors grouping BFS
    indices by tree level (descending depth for the leaf->root pass,
    ascending for root->leaf; both exclude the root level).
    Returns states [N,S] int64 in 0..3, on the input's device.
    """
    big = torch.tensor(num_nodes, dtype=torch.int32, device=leaf_mask.device)
    k = torch.arange(4, dtype=torch.uint8, device=leaf_mask.device)
    leaf_bits = (leaf_mask[:, :, None] >> k) & 1
    leaf_scores = torch.where(leaf_bits != 0, 0, big)
    scores = torch.where(is_leaf[:, None, None], leaf_scores, 0).to(
        torch.int32)

    for lev in levels_desc:
        ch = scores[lev]                                   # [L,S,4]
        m = ch.min(-1).values
        contrib = torch.minimum(ch, m[..., None] + 1)
        scores.index_add_(0, parent[lev], contrib)

    states = torch.zeros(leaf_mask.shape, dtype=torch.long,
                         device=leaf_mask.device)
    states[0] = _pick_state(scores[0], ref_nt)
    for lev in levels_asc:
        ps = states[parent[lev]]
        states[lev] = _pick_state(scores[lev], ps)
    return states


def assign_states_from_vcf(T: Tree, vcf, device: torch.device | str = "cpu"
                           ) -> None:
    """Build the MAT: run per-site Fitch-Sankoff for every VCF site on
    ``device`` and attach the resulting branch mutations to the tree in
    place."""
    sites = vcf.sites
    if not sites:
        return
    bfs = T.breadth_first_expansion()
    n = len(bfs)
    bfs_idx = {node.identifier: i for i, node in enumerate(bfs)}
    parent = np.zeros(n, dtype=np.int64)
    is_leaf = np.zeros(n, dtype=bool)
    levels = {}
    for i, node in enumerate(bfs):
        parent[i] = bfs_idx[node.parent.identifier] if node.parent is not None else 0
        is_leaf[i] = node.is_leaf()
        levels.setdefault(node.level, []).append(i)
    level_keys = sorted(levels)

    def _lev(k):
        return torch.tensor(levels[k], dtype=torch.long, device=device)

    levels_desc = [_lev(k) for k in reversed(level_keys) if k > level_keys[0]]
    levels_asc = [_lev(k) for k in level_keys if k > level_keys[0]]

    s_count = len(sites)
    leaf_mask = np.zeros((n, s_count), dtype=np.uint8)
    ref_nib = np.array([s.ref_nuc for s in sites], dtype=np.uint8)
    leaf_mask[is_leaf] = ref_nib[None, :]
    col_to_node = np.array(
        [bfs_idx.get(name, -1) for name in vcf.sample_ids], dtype=np.int64)
    for si, site in enumerate(sites):
        for col, nuc in site.variants:
            node_i = col_to_node[col]
            if node_i >= 0:
                leaf_mask[node_i, si] = nuc

    ref_nt = np.log2(ref_nib).astype(np.int64)  # single-bit nibble -> 0..3

    states = _sankoff_states(
        torch.from_numpy(leaf_mask).to(device),
        torch.from_numpy(is_leaf).to(device),
        torch.from_numpy(parent).to(device),
        levels_desc, levels_asc,
        torch.from_numpy(ref_nt).to(device), num_nodes=n).cpu().numpy()

    # attach mutations where a node's state differs from its parent's (the
    # root compares against the reference base)
    par_states = states[parent]
    par_states[0, :] = ref_nt
    mut_nodes, mut_sites = np.nonzero(states != par_states)
    for node_i, si in zip(mut_nodes.tolist(), mut_sites.tolist()):
        site = sites[si]
        m = Mutation(chrom=site.chrom, position=site.position,
                     ref_nuc=site.ref_nuc,
                     par_nuc=1 << int(par_states[node_i, si]),
                     mut_nuc=1 << int(states[node_i, si]))
        bfs[node_i].add_mutation(m)
