"""SPR move search + application (counterpart of usher_tpu/optimize/spr.py;
the derivation is in its docstring).

A move is scored exactly as a re-placement: the pruned subtree's Fitch
major-allele set (from the whole-tree FS backward pass) is the "sample
genotype", scored against every destination at once by the dense scorer of
ops/placement.py:

  new branch cost(s -> d) = #{p : fitch_set(s,p) & path_state(d,p) == 0}
  improvement(s -> d) = len(muts(s)) + collapse_bonus(s) - cost(s, d)

X11 ``_score_moves`` is torch ops on the device of its inputs: the score,
the validity of placement, a radius mask over the L ancestor slots of each
source (hop distance level[src] + level[dst] - 2 level[lca], the lca level
being the deepest source ancestor whose DFS interval holds dst), the
exclusion of the source's subtree and parent, and the (score, -num_leaves,
-bfs_rank) tie-break with the first index winning.  Only three [B] vectors
leave the device.  The host code (merge_count, collapse_bonus, conflict
resolution, apply/revert) is the JAX module's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.tree import Node, Tree
from ..ops.placement import reduce_best, score_with_stp, valid_mask
from ..utils.device import apply_platform_env


_NIBBLES = np.array([1, 2, 4, 8], dtype=np.uint8)


@dataclass
class Move:
    src: Node
    dst: Node
    improvement: int
    sibling_split: bool
    src_interval: tuple[int, int]
    dst_dfs: int


def _dest_ok(N: int, dfs_idx, level, anc_lo, anc_hi, anc_lvl, src_level,
             src_lo, src_hi, src_parent, radius: int):
    """[B, N] bool: destinations within ``radius`` hops of each source,
    outside its subtree and other than its parent.  anc_lo/anc_hi/anc_lvl
    [B, L] hold each source's proper ancestors' DFS intervals and levels
    (level -1 in unused slots, whose empty interval holds nothing)."""
    B = anc_lo.shape[0]
    d = dfs_idx[None, :]
    lca_lvl = torch.full((B, N), -1, dtype=torch.int32, device=d.device)
    for l in range(anc_lo.shape[1]):
        contains = (anc_lo[:, l:l + 1] <= d) & (d < anc_hi[:, l:l + 1])
        lca_lvl = torch.maximum(lca_lvl, torch.where(
            contains, anc_lvl[:, l:l + 1], -1))
    dist = level[None, :] + src_level[:, None] - 2 * lca_lvl
    ok = dist <= radius
    ok &= ~((d >= src_lo[:, None]) & (d < src_hi[:, None]))
    idx = torch.arange(N, dtype=torch.int32, device=d.device)[None, :]
    return ok & (idx != src_parent[:, None])


def _spr_scores(st, stp, ref, active, g):
    """Re-placement scores of the subtree masks g [B, P] against every node
    (E everywhere, nothing missing), with the SPR validity: the root always,
    and dest leaves treated as internal nodes (they get a sibling split via
    has_unique).  Returns (score, valid, has_unique) [B, N]."""
    N = st.shape[0]
    E = torch.ones(g.shape, dtype=torch.bool, device=g.device)
    miss = torch.zeros(g.shape, dtype=torch.bool, device=g.device)
    score, num_common, node_num_mut = score_with_stp(
        st, stp, ref, active, g, E, miss)
    is_root = torch.zeros(N, dtype=torch.bool, device=st.device)
    is_root[0] = True
    valid, has_unique = valid_mask(
        score, num_common, node_num_mut, is_root,
        torch.zeros(N, dtype=torch.bool, device=st.device), active)
    return score, valid, has_unique


def _score_moves(st, stp, ref, active, g, num_leaves, bfs_rank,
                 dfs_idx, level, anc_lo, anc_hi, anc_lvl,
                 src_level, src_lo, src_hi, src_parent, radius: int):
    """X11: score subtree masks g [B,P] against all radius-bounded dests in
    one call; returns per-source (best_cost [B], best_slot [B],
    best_has_unique [B]) on the device."""
    score, valid, has_unique = _spr_scores(st, stp, ref, active, g)
    valid &= _dest_ok(st.shape[0], dfs_idx, level, anc_lo, anc_hi, anc_lvl,
                      src_level, src_lo, src_hi, src_parent, radius)
    best, best_slot, _ = reduce_best(score, valid, num_leaves, bfs_rank)
    hu_best = torch.gather(has_unique, 1, best_slot.long()[:, None])[:, 0]
    return best, best_slot, hu_best


def _source_paths(parent, idxs):
    """Each source's proper ancestors, nearest first (the lca of src and
    any dst outside src's subtree is one of these)."""
    paths = []
    for si in idxs:
        path = []
        p = int(parent[si])
        while True:
            path.append(p)
            if p == 0:
                break
            p = int(parent[p])
        paths.append(path)
    return paths


def _source_arrays(finder, idxs, paths):
    """The per-source int32 arrays of the radius mask: (anc_lo, anc_hi,
    anc_lvl [B, L], src_level, src_lo, src_hi, src_parent [B]) with L the
    longest ancestor path of the batch."""
    B = len(idxs)
    L = max((len(p) for p in paths), default=1)
    anc_lo = np.zeros((B, L), dtype=np.int32)
    anc_hi = np.zeros((B, L), dtype=np.int32)
    anc_lvl = np.full((B, L), -1, dtype=np.int32)
    for b, path in enumerate(paths):
        anc_lo[b, :len(path)] = finder.dfs_idx[path]
        anc_hi[b, :len(path)] = finder.dfs_end[path]
        anc_lvl[b, :len(path)] = finder.level[path]
    idxs = np.asarray(idxs, dtype=np.int64)
    return (anc_lo, anc_hi, anc_lvl, finder.level[idxs],
            finder.dfs_idx[idxs].astype(np.int32),
            finder.dfs_end[idxs].astype(np.int32),
            finder.parent[idxs].astype(np.int32))


def _run_sharded(mesh, device, B: int, fn):
    """fn(device, lo, hi) -> tuple of [hi - lo] tensors, run on the whole
    batch on ``device`` or, with a 1-D mesh, once per shard of the batch
    split over its devices (each on its own stream; shards that share a
    card take turns on it).  Returns the tuple joined along the last axis
    on the host."""
    if mesh is None:
        return tuple(t.cpu() for t in fn(device, 0, B))
    from ..parallel.mesh import for_each_shard, split_bounds
    bounds = split_bounds(B, mesh.size)

    def one(idx):
        lo, hi = bounds[idx[0]]
        return fn(mesh.devices[idx], lo, hi) if hi > lo else None
    res = for_each_shard(mesh, one)
    parts = [res[idx] for idx in mesh.indices() if res[idx] is not None]
    return tuple(torch.cat([p[k].cpu() for p in parts], dim=-1)
                 for k in range(len(parts[0])))


def merge_count(a, b) -> int:
    """Length of add_mutation-merge of two sorted mutation lists (same-position
    entries chain a.par->b.mut, cancelling when equal)."""
    by_pos = {}
    n = 0
    for m in a:
        by_pos[m.position] = (m.par_nuc, m.mut_nuc)
        n += 1
    for m in b:
        prev = by_pos.get(m.position)
        if prev is None:
            by_pos[m.position] = (m.par_nuc, m.mut_nuc)
            n += 1
        else:
            par, mut = prev
            if mut != m.par_nuc and par != m.mut_nuc:
                pass  # inconsistent chain; keep updated allele (count same)
            if par == m.mut_nuc:
                n -= 1  # reversal cancels the entry
                del by_pos[m.position]
            else:
                by_pos[m.position] = (par, m.mut_nuc)
    return n


def collapse_bonus(s: Node) -> int:
    """Mutations freed by the parent-merge when pruning s leaves its parent
    with a single child."""
    p = s.parent
    if p is None or p.parent is None or len(p.children) != 2:
        return 0
    sib = p.children[0] if p.children[1] is s else p.children[1]
    return len(p.mutations) + len(sib.mutations) - merge_count(
        p.mutations, sib.mutations)


class MoveFinder:
    """One search round over a frozen tree snapshot."""

    def __init__(self, T: Tree, states: np.ndarray, masks: np.ndarray,
                 ref_row: np.ndarray, bfs: list[Node], parent: np.ndarray,
                 chunk: int = 128, mesh=None, device=None):
        """mesh: optional 1-D parallel.mesh.Mesh -- shards the source-node
        batch axis of the move scorer over its devices (the analog of the
        reference's MPI SPR work distributor,
        src/matOptimize/optimize_tree.cpp:165-252); the tree's arrays are
        replicated.  device: where the scorer runs without a mesh (default:
        from USHER_TPU_PLATFORM)."""
        self.T = T
        self.bfs = bfs
        self.parent = parent
        self.mesh = mesh
        self.device = (torch.device(device) if device is not None
                       else mesh.lead if mesh is not None
                       else apply_platform_env())
        # with a mesh, each device scores a `chunk`-wide source slice
        self.chunk = chunk * (mesh.size if mesh is not None else 1)
        n = len(bfs)
        self.n = n
        # flat arrays (BFS-indexed); the nibble table spares an int32 copy
        # of the [n, P] states
        st = _NIBBLES[states]
        stp = st[parent]
        stp[0] = st[0]
        self.masks = masks
        self.ref_row = ref_row

        # DFS intervals on BFS indices
        T.depth_first_expansion()
        self.bfs_index = {id(node): i for i, node in enumerate(bfs)}
        self.dfs_idx = np.array([node.dfs_idx for node in bfs], dtype=np.int64)
        self.dfs_end = np.array([node.dfs_end_idx for node in bfs], dtype=np.int64)
        self.level = np.array([node.level for node in bfs], dtype=np.int32)

        num_leaves = np.zeros(n, dtype=np.int32)
        for i in range(n - 1, 0, -1):
            if bfs[i].is_leaf():
                num_leaves[i] += 1
            num_leaves[parent[i]] += num_leaves[i]
        if bfs and bfs[0].is_leaf():
            num_leaves[0] += 1

        # the tree's arrays on every device of the scorer, uploaded once
        host = {"st": st, "stp": stp, "ref": ref_row,
                "active": np.ones(n, dtype=np.bool_),
                "num_leaves": num_leaves,
                "bfs_rank": np.arange(n, dtype=np.int32),
                "dfs_idx": self.dfs_idx.astype(np.int32),
                "level": self.level}
        self._tree = {}
        devices = (mesh.devices.reshape(-1).tolist() if mesh is not None
                   else [self.device])
        for device in devices:
            if device not in self._tree:
                self._tree[device] = {
                    k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
                    for k, a in host.items()}

        # undirected adjacency for radius bounding
        self.adj: list[list[int]] = [[] for _ in range(n)]
        for i in range(1, n):
            self.adj[i].append(int(parent[i]))
            self.adj[parent[i]].append(i)

    def tree_on(self, device) -> dict:
        """The tree's tensors on ``device`` (st, stp, ref, active,
        num_leaves, bfs_rank, dfs_idx, level)."""
        return self._tree[device]

    def _chunk_inputs(self, idxs):
        """Host inputs of one source chunk: the subtree masks g [B, P],
        the current costs, the radius-mask arrays and the ancestor paths."""
        bfs = self.bfs
        g = self.masks[np.asarray(idxs, dtype=np.int64)]
        oldcost = np.array([len(bfs[si].mutations) + collapse_bonus(bfs[si])
                            for si in idxs], dtype=np.int64)
        paths = _source_paths(self.parent, idxs)
        return g, oldcost, _source_arrays(self, idxs, paths)

    def find_moves(self, radius: int, sources=None,
                   log=None) -> list[Move]:
        n = self.n
        bfs = self.bfs
        if sources is None:
            sources = [i for i in range(1, n)]
        moves: list[Move] = []
        max_level = int(self.level.max()) if n else 0
        eff_radius = radius if radius > 0 else 2 * max_level + 2

        for c0 in range(0, len(sources), self.chunk):
            idxs = sources[c0:c0 + self.chunk]
            g, oldcost, src = self._chunk_inputs(idxs)

            def score(device, lo, hi):
                t = self._tree[device]

                def up(a):
                    return torch.from_numpy(np.ascontiguousarray(
                        a[lo:hi])).to(device)
                out = _score_moves(
                    t["st"], t["stp"], t["ref"], t["active"], up(g),
                    t["num_leaves"], t["bfs_rank"], t["dfs_idx"], t["level"],
                    *(up(a) for a in src), eff_radius)
                # one host copy for the three [B] results
                return (torch.stack([o.to(torch.int32) for o in out]),)
            packed, = _run_sharded(self.mesh, self.device, len(idxs), score)
            cost, slot, hu = packed.numpy()
            for b, si in enumerate(idxs):
                imp = int(oldcost[b]) - int(cost[b])
                if imp > 0 and cost[b] < (1 << 29):
                    d = int(slot[b])
                    moves.append(Move(
                        src=bfs[si], dst=bfs[d], improvement=imp,
                        sibling_split=bool(hu[b]) or bfs[d].is_leaf(),
                        src_interval=(int(self.dfs_idx[si]), int(self.dfs_end[si])),
                        dst_dfs=int(self.dfs_idx[d])))
        return moves


def resolve_conflicts(moves: list[Move]) -> list[Move]:
    """Greedy by improvement; a move is deferred if its source subtree or
    destination touches an already-accepted move's region (the reference
    defers path-crossing moves, priority_conflict_resolver.cpp:17-29)."""
    accepted: list[Move] = []
    hot_nodes: set[int] = set()
    intervals: list[tuple[int, int]] = []
    dst_points: list[int] = []

    def covered(x: int) -> bool:
        return any(lo <= x < hi for lo, hi in intervals)

    for mv in sorted(moves, key=lambda m: (-m.improvement, m.src_interval[0])):
        lo, hi = mv.src_interval
        if any(not (hi <= l2 or h2 <= lo) for l2, h2 in intervals):
            continue
        if covered(mv.dst_dfs):
            continue
        if any(lo <= x < hi for x in dst_points):
            continue
        pid = id(mv.src.parent)
        did = id(mv.dst)
        dpid = id(mv.dst.parent) if mv.dst.parent is not None else 0
        if {id(mv.src), pid, did, dpid} & hot_nodes:
            continue
        accepted.append(mv)
        intervals.append((lo, hi))
        dst_points.append(mv.dst_dfs)
        hot_nodes.update({id(mv.src), pid, did, dpid})
    return accepted


def apply_move(T: Tree, mv: Move) -> list:
    """Topological SPR: prune src (merging a single-child parent away), then
    graft at dst (sibling split or child).  Branch mutations are left stale;
    the caller re-runs whole-tree FS to rewrite them.

    Returns an undo log for revert_moves() — O(move) records instead of the
    O(tree) snapshot a full copy would cost (the reference patches locally
    for the same reason, apply_move/)."""
    undo: list = []
    s, d = mv.src, mv.dst
    p = s.parent
    src_idx = p.children.index(s)
    p.children.remove(s)
    undo.append(("reattach_src", s, p, src_idx))
    if len(p.children) == 1 and p.parent is not None:
        c = p.children[0]
        # merge p away: c absorbs p's branch (mutations rewritten later)
        gp = p.parent
        i = gp.children.index(p)
        # snapshot BOTH lists: add_mutation's same-position merge rule
        # mutates Mutation objects in place, so shared references would
        # corrupt the undo state
        undo.append(("unmerge", p, gp, i, c, list(c.mutations),
                     list(p.mutations)))
        gp.children[i] = c
        c.parent = gp
        # keep merged mutation list roughly consistent for oldcost accounting
        merged = [m.copy() for m in p.mutations]
        tmp = [m.copy() for m in c.mutations]
        c.mutations = []
        for m in merged:
            c.add_mutation(m)
        for m in tmp:
            c.add_mutation(m)
        del T._all_nodes[p.identifier]
        T._update_levels(c)
    elif len(p.children) == 0:
        # pruning the last child: p becomes empty; remove upward, merging
        # single-child survivors like Tree.remove_node(move_level=True)
        node = p
        while node.parent is not None and not node.children:
            par = node.parent
            idx = par.children.index(node)
            par.children.remove(node)
            del T._all_nodes[node.identifier]
            undo.append(("undelete", node, par, idx))
            node = par
        if node.parent is not None and len(node.children) == 1:
            child = node.children[0]
            gp = node.parent
            i = gp.children.index(node)
            undo.append(("unmerge_full", node, gp, i, child,
                         list(child.mutations), child.branch_length,
                         list(child.clade_annotations),
                         list(node.mutations)))
            for k in range(len(node.clade_annotations)):
                if k < len(child.clade_annotations) \
                        and child.clade_annotations[k] == "":
                    child.clade_annotations[k] = node.clade_annotations[k]
            child.parent = gp
            child.branch_length += node.branch_length
            tmp = [m.copy() for m in child.mutations]
            child.mutations = []
            for m in node.mutations:
                child.add_mutation(m.copy())
            for m in tmp:
                child.add_mutation(m)
            gp.children[i] = child
            del T._all_nodes[node.identifier]
            T._update_levels(child)

    if mv.sibling_split and d.parent is not None:
        ni = Node(T.new_internal_node_id(), d.parent, -1.0)
        ni.clade_annotations = [""] * T.get_num_annotations()
        gp = d.parent
        i = gp.children.index(d)
        undo.append(("ungraft_split", ni, gp, i, d, s))
        gp.children[i] = ni
        T._all_nodes[ni.identifier] = ni
        d.parent = ni
        ni.children = [d, s]
        s.parent = ni
        T._update_levels(ni)
    else:
        undo.append(("ungraft_child", d, s))
        d.children.append(s)
        s.parent = d
        T._update_levels(s)
    return undo


def revert_moves(T: Tree, undo_logs: list) -> None:
    """Revert a sequence of apply_move undo logs (most recent first is
    handled internally: pass logs in application order)."""
    for undo in reversed(undo_logs):
        for op in reversed(undo):
            kind = op[0]
            if kind == "ungraft_child":
                _, d, s = op
                d.children.remove(s)
                s.parent = None
            elif kind == "ungraft_split":
                _, ni, gp, i, d, s = op
                gp.children[i] = d
                d.parent = gp
                s.parent = None
                del T._all_nodes[ni.identifier]
                T._update_levels(d)
            elif kind == "unmerge":
                _, p, gp, i, c, c_old_mut, p_old_mut = op
                gp.children[i] = p
                c.parent = p
                c.mutations = c_old_mut
                p.mutations = p_old_mut
                T._all_nodes[p.identifier] = p
                T._update_levels(p)
            elif kind == "unmerge_full":
                (_, node, gp, i, child, old_mut, old_bl, old_ann,
                 node_old_mut) = op
                gp.children[i] = node
                child.parent = node
                child.mutations = old_mut
                child.branch_length = old_bl
                child.clade_annotations = old_ann
                node.mutations = node_old_mut
                T._all_nodes[node.identifier] = node
                T._update_levels(node)
            elif kind == "undelete":
                _, node, par, idx = op
                par.children.insert(idx, node)
                T._all_nodes[node.identifier] = node
            elif kind == "reattach_src":
                _, s, p, idx = op
                p.children.insert(idx, s)
                s.parent = p
                T._update_levels(s)
            else:  # pragma: no cover
                raise AssertionError(f"unknown undo op {kind}")
