"""matOptimize -E: equally-parsimonious-placement counts per branch
(counterpart of usher_tpu/optimize/epp.py).

Reference: the epps_on_branch_len branch of matOptimize main.cpp:438-504 —
for every node, search radius-bounded re-placements that tie the current
branch cost, merge sibling-equivalent placements (remove_sibling,
main.cpp:101-118), write the count into the branch-length field of the
output newick and dump the tied node lists to "epps_dump".

X12 ``_tie_matrix`` takes the tie sets from the same re-placement scorer the
SPR search uses (one device call per source chunk scoring ALL
radius-bounded destinations), instead of the reference's per-node bounded
DFS.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..core.tree import Tree
from .fitch import FitchEngine
from .spr import (MoveFinder, _dest_ok, _source_arrays, _source_paths,
                  _spr_scores, collapse_bonus)


def _tie_matrix(st, stp, ref, active, g, oldcost,
                dfs_idx, level, anc_lo, anc_hi, anc_lvl,
                src_level, src_lo, src_hi, src_parent, radius: int):
    """X12: [B, N] bool, the valid radius-bounded destinations whose
    re-placement cost equals the source's current branch cost."""
    score, valid, _ = _spr_scores(st, stp, ref, active, g)
    valid &= _dest_ok(st.shape[0], dfs_idx, level, anc_lo, anc_hi, anc_lvl,
                      src_level, src_lo, src_hi, src_parent, radius)
    return valid & (score == oldcost[:, None])


def count_epps(T: Tree, radius: int, dump_path: str = "epps_dump",
               device=None) -> None:
    """Set every node's branch_length to its EPP count and write the tied
    node lists.  Mutates T's branch lengths in place.  device: where the
    FS pass and X12 run (default: from USHER_TPU_PLATFORM)."""
    from ..core.flat import collect_positions
    positions, ref, chrom = collect_positions(T)
    engine = FitchEngine(T, positions, device=device)
    from .leafstore import SparseLeafStore
    leaf_store, ref_row = SparseLeafStore.from_tree(T, positions)
    states, masks = engine.run(leaf_store, ref_row)
    finder = MoveFinder(T, states, masks, ref_row, engine.bfs, engine.parent,
                        device=engine.device)
    bfs = finder.bfs
    n = finder.n
    if radius < 0:
        radius = 2 * int(finder.level.max())
    t = finder.tree_on(finder.device)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(finder.device)

    dump_f = open(dump_path, "w")
    for c0 in range(0, n - 1, finder.chunk):
        idxs = list(range(1 + c0, min(1 + c0 + finder.chunk, n)))
        g = finder.masks[np.asarray(idxs, dtype=np.int64)]
        oldcost = np.array([len(bfs[si].mutations) + collapse_bonus(bfs[si])
                            for si in idxs], dtype=np.int32)
        src = _source_arrays(finder, idxs, _source_paths(finder.parent, idxs))
        ties = _tie_matrix(
            t["st"], t["stp"], t["ref"], t["active"], up(g), up(oldcost),
            t["dfs_idx"], t["level"], *(up(a) for a in src),
            radius).cpu().numpy()
        for b, si in enumerate(idxs):
            node = bfs[si]
            tied = [bfs[j] for j in np.nonzero(ties[b])[0]]
            # sibling-equivalence filtering (remove_sibling, main.cpp:101)
            members = [node] + tied
            filtered = {id(x): False for x in members}

            def _remove_sibling(x):
                par = x.parent
                if par is None:
                    return
                if id(par) in filtered:
                    filtered[id(par)] = True
                for ch in par.children:
                    if ch is not x and id(ch) in filtered:
                        filtered[id(ch)] = True

            _remove_sibling(node)
            for x in members:
                if not filtered[id(x)]:
                    _remove_sibling(x)
            kept = [x for x in members if not filtered[id(x)]]
            node.branch_length = float(max(1, len(kept)))
            if len(kept) > 1:
                others = ",".join(x.identifier for x in kept
                                  if x is not node)
                if others:
                    dump_f.write(f"{node.identifier}:{others}\n")
    if bfs:
        bfs[0].branch_length = 1.0
    dump_f.close()
    print(f"EPP counts written to branch lengths; ties dumped to "
          f"{dump_path}", file=sys.stderr)
