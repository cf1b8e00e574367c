"""Plain sequential placement of a job's samples onto the generated MAT.

The semantics are UShER's (`usher_mapper.cpp` and `usher_common.cpp`, as the
port transcribes them in `placement/mapper.py::score_placement` and
`placement/driver.py` at commit f18dcaca4b2a; nothing of the port is
imported):

- a sample's score at node Y is the number of sites where it differs from
  Y's parent state with those of Y's branch mutations applied that the
  sample carries (or has an N at, or that revert to the reference where the
  sample has no entry); N calls never count;
- Y is a valid placement if it is the root, or an internal node whose branch
  the sample shares wholly or in part, or a leaf whose branch it shares in
  part;
- the tie set is every valid node at the least score; the winner has the
  most leaves below it, then the latest breadth-first rank;
- a leaf winner, or one whose branch the sample does not share wholly, has
  its branch split: a new internal node `node_<k>` takes the shared
  mutations and is appended to the parent's children, with the sample and
  the old node (keeping the rest) as its children; otherwise the sample is
  appended to the winner's children.

The scores of the generated tree's nodes are worked out for every node at
once (torch, on the device given) from the nodes' alleles at the sample's
sites; the nodes that placements add or change are scored one by one.
Every placement changes the tree the next sample is scored against, as in
the program.  With `snapshot=True` the samples of a batch are all scored
against the tree as the batch began and then applied in order: the host
corrections left out, the control that the check must fail.
"""

from __future__ import annotations

import numpy as np
import torch

CHARS = np.array(list("?AC?G???T??????N"))
N_CALL = 15
BIG = 1 << 30


class BaseTree:
    """The generated MAT, with what scoring every node needs, on `device`."""

    def __init__(self, mat: dict, names: list[str], device):
        self.device = torch.device(device)
        parent = mat["parent"].astype(np.int64)
        self.N = N = len(parent)
        self.parent = parent
        self.names = names
        self.ref = mat["ref"]
        self.positions = mat["positions"]
        self.is_leaf = mat["is_leaf"]
        self.num_leaves = mat["num_leaves"]
        self.depth = mat["depth"]
        self.mut_ptr = mat["mut_ptr"]
        self.mut_col = mat["mut_col"].astype(np.int64)
        self.mut_par = mat["mut_par"]
        self.mut_mut = mat["mut_mut"]
        self.n_internal = int((~self.is_leaf).sum())
        kids = np.argsort(parent[1:], kind="stable") + 1
        self.kids = kids
        self.kid_ptr = np.zeros(N + 1, np.int64)
        self.kid_ptr[1:] = np.cumsum(np.bincount(parent[1:], minlength=N))
        self.child_idx = np.zeros(N, np.int64)
        self.child_idx[kids] = np.arange(N - 1) - self.kid_ptr[parent[kids]]
        nmut = np.diff(self.mut_ptr)
        mut_node = np.repeat(np.arange(N), nmut)
        refm = self.ref[self.mut_col]
        delta = (np.bincount(mut_node, weights=(self.mut_mut != refm),
                             minlength=N)
                 - np.bincount(mut_node, weights=(self.mut_par != refm),
                               minlength=N)).astype(np.int64)
        order = np.argsort(self.depth, kind="stable")
        bounds = np.searchsorted(self.depth[order],
                                 np.arange(self.depth.max() + 2))
        self.levels = [order[bounds[d]:bounds[d + 1]]
                       for d in range(1, len(bounds) - 1)]
        pdiff = np.zeros(N, np.int64)
        for idx in self.levels:
            pdiff[idx] = pdiff[parent[idx]] + delta[idx]
        rb = np.bincount(mut_node, weights=(self.mut_mut == refm),
                         minlength=N).astype(np.int64)
        t = lambda a, dt=torch.int32: torch.as_tensor(a).to(self.device, dt)
        self.t_parent = t(parent, torch.int64)
        self.t_pdiff = t(pdiff)
        self.t_pdiff_par = t(pdiff[parent])
        self.t_rb = t(rb)
        self.t_nmut = t(nmut)
        self.t_leaf = t(self.is_leaf, torch.bool)
        root = np.zeros(N, bool)
        root[0] = True
        self.t_root = t(root, torch.bool)
        self.t_levels = [t(idx, torch.int64) for idx in self.levels]
        # mutations in the order of their node's depth, for painting
        m_order = np.argsort(self.depth[mut_node], kind="stable")
        self.m_depth = self.depth[mut_node][m_order]
        self.t_m_node = t(mut_node[m_order], torch.int64)
        self.t_m_col = t(self.mut_col[m_order], torch.int64)
        self.t_m_mut = t(self.mut_mut[m_order], torch.uint8)
        self.t_ref = t(self.ref, torch.uint8)
        self._state = {}

    def paint(self, cols: np.ndarray) -> torch.Tensor:
        """Alleles of every node at the sorted columns `cols`: [N, C]."""
        cmap = torch.full((len(self.ref),), -1, dtype=torch.int64,
                          device=self.device)
        tc = torch.as_tensor(cols, dtype=torch.int64).to(self.device)
        cmap[tc] = torch.arange(len(cols), device=self.device)
        S = torch.empty((self.N, len(cols)), dtype=torch.uint8,
                        device=self.device)
        S[0] = self.t_ref[tc]
        u = cmap[self.t_m_col]
        keep = torch.nonzero(u >= 0).squeeze(1)
        m_node, m_u, m_mut = self.t_m_node[keep], u[keep], self.t_m_mut[keep]
        dep = self.m_depth[keep.cpu().numpy()]
        mb = np.searchsorted(dep, np.arange(len(self.levels) + 2))
        for d, idx in enumerate(self.t_levels, start=1):
            S[idx] = S[self.t_parent[idx]]
            lo, hi = int(mb[d]), int(mb[d + 1])
            if hi > lo:
                S[m_node[lo:hi], m_u[lo:hi]] = m_mut[lo:hi]
        return S

    def scores(self, S: torch.Tensor, uidx, x: np.ndarray, cols):
        """Score, validity and full-genotype distance of one sample at every
        node, from the painted alleles S at its sites (columns uidx of S)."""
        dev = self.device
        own = S[:, torch.as_tensor(uidx, device=dev)].int()   # [N, k]
        ps = own[self.t_parent]
        xs = torch.as_tensor(x.astype(np.int32), device=dev)[None, :]
        refk = self.t_ref[torch.as_tensor(cols, device=dev)].int()[None, :]
        xn = xs == N_CALL
        hasmut = own != ps
        found = hasmut & (xn | ((own & xs) != 0))
        anc = torch.where(found, own, ps)
        diff = ~xn & ((anc & xs) == 0)
        mutref = (hasmut & (own == refk)).sum(1, dtype=torch.int32)
        rb_out = self.t_rb - mutref
        score = (self.t_pdiff_par - (ps != refk).sum(1, dtype=torch.int32)
                 - rb_out + diff.sum(1, dtype=torch.int32))
        common = found.sum(1, dtype=torch.int32) + rb_out
        valid = (self.t_root
                 | (~self.t_leaf & ((common == self.t_nmut) | (common > 0)))
                 | (self.t_leaf & (common > 0)))
        full = (self.t_pdiff - (own != refk).sum(1, dtype=torch.int32)
                + (~xn & ((own & xs) == 0)).sum(1, dtype=torch.int32))
        return score, valid, full

    def branch(self, v: int) -> list:
        lo, hi = int(self.mut_ptr[v]), int(self.mut_ptr[v + 1])
        return list(zip(self.mut_col[lo:hi].tolist(),
                        self.mut_par[lo:hi].tolist(),
                        self.mut_mut[lo:hi].tolist()))

    def state(self, v: int) -> dict:
        """Genotype of base node v: {column: allele} where it differs from
        the reference."""
        got = self._state.get(v)
        if got is not None:
            return got
        seen: dict = {}
        u = v
        while u != 0:
            for c, _, m in self.branch(u):
                seen.setdefault(c, m)
            u = int(self.parent[u])
        got = {c: m for c, m in seen.items() if m != self.ref[c]}
        self._state[v] = got
        return got


def mut_str(base: BaseTree, m) -> str:
    c, par, mut = m
    return f"{CHARS[par]}{base.positions[c]}{CHARS[mut]}"


def explicit_score(base: BaseTree, sample: dict, pstate: dict, branch: list,
                   is_leaf: bool):
    """`score_placement` of one node from its parent's genotype and its
    branch: (score, valid, has_unique, the branch mutations the sample
    carries, the sample's own mutations).  A branch mutation at a site
    where the sample has an N counts as shared but is not carried: a split
    leaves it on the old node."""
    ref = base.ref
    anc = dict(pstate)
    shared = []
    common = 0
    for c, par, mut in branch:
        x = sample.get(c)
        if x == N_CALL:
            common += 1         # shared, but neither moved nor applied
        elif (x is not None and x & mut) or (x is None and mut == ref[c]):
            common += 1
            shared.append((c, par, mut))
            if mut == ref[c]:
                anc.pop(c, None)
            else:
                anc[c] = mut
    has_unique = common < len(branch)
    own = []
    for c, x in sorted(sample.items()):
        if x == N_CALL:
            continue
        a = anc.get(c, int(ref[c]))
        if not x & a:
            own.append((c, a, x))
    for c in sorted(anc):
        if c not in sample:
            own.append((c, anc[c], int(ref[c])))
    own.sort()
    valid = ((not is_leaf and (not has_unique or common > 0))
             or (is_leaf and common > 0))
    return len(own), valid, has_unique, shared, own


def apply_muts(base: BaseTree, state: dict, muts) -> dict:
    out = dict(state)
    for c, _, m in muts:
        if m == base.ref[c]:
            out.pop(c, None)
        else:
            out[c] = m
    return out


class Placer:
    """A job's sequential placement onto a fresh copy of the base tree."""

    def __init__(self, base: BaseTree):
        self.base = base
        self.parent_of: dict = {}
        self.branch_of: dict = {}
        self.name_of: dict = {}
        self.leaf_new: dict = {}
        self.state_new: dict = {}
        self.children: dict = {}
        self.leaves_new: dict = {}
        self.extra: dict = {}
        self.counter = base.n_internal
        self.modified = torch.zeros(base.N, dtype=torch.bool,
                                    device=base.device)
        self.ov_ids: list = []
        self.ov_anchor: list = []
        self.ov_off: list = []
        self._ov_t = None
        self.radius: dict = {}
        self.anchor: dict = {}
        self.next_id = base.N

    # --- the current tree -------------------------------------------------

    def cur_parent(self, v: int) -> int:
        p = self.parent_of.get(v)
        return int(self.base.parent[v]) if p is None else p

    def branch(self, v: int) -> list:
        b = self.branch_of.get(v)
        return self.base.branch(v) if b is None else b

    def is_leaf(self, v: int) -> bool:
        if v < self.base.N:
            return bool(self.base.is_leaf[v])
        return self.leaf_new[v]

    def state(self, v: int) -> dict:
        return self.base.state(v) if v < self.base.N else self.state_new[v]

    def name(self, v: int) -> str:
        return self.base.names[v] if v < self.base.N else self.name_of[v]

    def kids(self, v: int) -> list:
        k = self.children.get(v)
        if k is not None:
            return k
        if v >= self.base.N:
            return []
        b = self.base
        return b.kids[b.kid_ptr[v]:b.kid_ptr[v + 1]].tolist()

    def leaves(self, v: int) -> int:
        own = (int(self.base.num_leaves[v]) if v < self.base.N
               else self.leaves_new[v])
        return own + self.extra.get(v, 0)

    def bfs_key(self, v: int):
        """Breadth-first order as (depth, child-index path from the root)."""
        path = []
        while v != 0:
            p = self.cur_parent(v)
            k = self.children.get(p)
            path.append(k.index(v) if k is not None
                        else int(self.base.child_idx[v]))
            v = p
        return (len(path), path[::-1])

    def _grow(self, v: int) -> None:
        while True:
            self.extra[v] = self.extra.get(v, 0) + 1
            if v == 0:
                return
            v = self.cur_parent(v)

    def _new(self, name, parent, branch, leaf, state, anchor, radius):
        v = self.next_id
        self.next_id += 1
        self.name_of[v] = name
        self.parent_of[v] = parent
        self.branch_of[v] = sorted(branch)
        self.leaf_new[v] = leaf
        self.state_new[v] = state
        self._candidate(v, anchor, radius)
        return v

    def _candidate(self, v, anchor, radius):
        """v's score is at least the full-genotype distance of `anchor`
        less `radius` (how far v's genotype lies from the anchor's) less
        v's branch length."""
        self.anchor[v] = anchor
        self.radius[v] = radius
        self.ov_ids.append(v)
        self.ov_anchor.append(anchor)
        self.ov_off.append(radius + len(self.branch(v)))
        self._ov_t = None

    # --- one sample -------------------------------------------------------

    def score(self, sample: dict, uidx, cols, x, S):
        """(best score, number of best placements, winner, the winner's
        `explicit_score`) against the current tree."""
        b = self.base
        score, valid, full = b.scores(S, uidx, x, cols)
        ok = valid & ~self.modified
        masked = torch.where(ok, score, torch.full_like(score, BIG))
        best_base = int(masked.min())
        cands = []
        if self.ov_ids:
            if self._ov_t is None:
                self._ov_t = (torch.as_tensor(self.ov_anchor,
                                              device=b.device),
                              torch.as_tensor(self.ov_off,
                                              device=b.device))
            anc_t, off_t = self._ov_t
            near = (full[anc_t] - off_t) <= best_base
            for i in torch.nonzero(near).squeeze(1).tolist():
                v = self.ov_ids[i]
                r = explicit_score(b, sample, self.state(self.cur_parent(v)),
                                   self.branch(v), self.is_leaf(v))
                if r[1]:
                    cands.append((r[0], v, r))
        best = min([best_base] + [c[0] for c in cands])
        tied = [(v, r) for s, v, r in cands if s == best]
        n_base = 0
        if best_base == best:
            hit = masked == best
            n_base = int(hit.sum())
            tied_base = torch.nonzero(hit).squeeze(1).tolist()
        else:
            tied_base = []
        num_best = n_base + len(tied)
        pool = [(v, None) for v in tied_base] + tied
        if len(pool) == 1:
            win, r = pool[0]
        else:
            win, r = max(pool, key=lambda p: (self.leaves(p[0]),
                                              self.bfs_key(p[0])))
        if r is None:
            r = explicit_score(b, sample, b.state(int(b.parent[win])),
                               b.branch(win), bool(b.is_leaf[win]))
            if r[0] != best:
                raise AssertionError(f"reference scores disagree at node "
                                     f"{win}: {r[0]} vs {best}")
        return best, num_best, win, r

    def apply(self, name: str, win: int, r) -> None:
        _, _, has_unique, shared, own = r
        anchor = self.anchor.get(win, win)
        rad = self.radius.get(win, 0)
        if self.is_leaf(win) or has_unique:
            p = self.cur_parent(win)
            keys = {(c, m) for c, _, m in shared}
            rest = [m for m in self.branch(win) if (m[0], m[2]) not in keys]
            self.counter += 1
            i_state = apply_muts(self.base, self.state(p), shared)
            i = self._new(f"node_{self.counter}", p, shared, False, i_state,
                          anchor, rad + len(rest))
            s = self._new(name, i, own, True,
                          apply_muts(self.base, i_state, own), anchor,
                          rad + len(rest) + len(own))
            kids = [k for k in self.kids(p) if k != win] + [i]
            self.children[p] = kids
            self.children[i] = [s, win]
            was_base = win < self.base.N and win not in self.branch_of
            self.parent_of[win] = i
            self.branch_of[win] = sorted(rest)
            self.leaves_new[i] = self.leaves(win) + 1
            self.leaves_new[s] = 1
            if was_base:
                self.modified[win] = True
                self._candidate(win, win, 0)
            self._grow(p)
        else:
            s = self._new(name, win, own, True,
                          apply_muts(self.base, self.state(win), own),
                          anchor, rad + len(own))
            self.children[win] = self.kids(win) + [s]
            self.leaves_new[s] = 1
            self._grow(win)
        self.placed[name] = s

    # --- a job ------------------------------------------------------------

    def run(self, job: dict, batch_size: int = 64, snapshot: bool = False,
            chunk: int = 64):
        """Place the job's samples in order: (placement_stats.tsv lines,
        mutation-paths.txt lines, final-tree.nh text)."""
        self.placed = {}
        names, ptr = job["names"], job["ptr"]
        col, nuc = job["col"], job["nuc"]
        B = len(names)
        stats = []
        step = batch_size if snapshot else chunk
        for b0 in range(0, B, step):
            rows = range(b0, min(B, b0 + step))
            lo, hi = int(ptr[b0]), int(ptr[rows[-1] + 1])
            ucols = np.unique(col[lo:hi])
            S = self.base.paint(ucols)
            pending = []
            for i in rows:
                c = col[ptr[i]:ptr[i + 1]].astype(np.int64)
                x = nuc[ptr[i]:ptr[i + 1]]
                sample = dict(zip(c.tolist(), x.tolist()))
                uidx = np.searchsorted(ucols, c)
                best, nb, win, r = self.score(sample, uidx, c, x, S)
                stats.append(f"{names[i]}\t{best}\t{nb}\t\n")
                if snapshot:
                    pending.append((i, sample, win))
                else:
                    self.apply(names[i], win, r)
            for i, sample, win in pending:
                # no host correction: the snapshot's winner, whatever
                # the batch's earlier samples did to the tree
                r = explicit_score(self.base, sample,
                                   self.state(self.cur_parent(win)),
                                   self.branch(win), self.is_leaf(win))
                self.apply(names[i], win, r)
            del S
        paths = [self.mutation_path(n) for n in names]
        return stats, paths, self.newick()

    def mutation_path(self, name: str) -> str:
        v = self.placed[name]
        chain = []
        while True:
            muts = self.branch(v)
            if muts:
                chain.append(self.name(v) + ":" + ",".join(
                    mut_str(self.base, m) for m in muts) + " ")
            if v == 0:
                break
            v = self.cur_parent(v)
        return name + "\t" + "".join(reversed(chain)) + "\n"

    def newick(self) -> str:
        """final-tree.nh: internal nodes named, branch length = number of
        mutations (the port's `io/newick.py::write_newick`)."""
        parts = []
        stack = [(0, 0)]
        while stack:
            v, st = stack.pop()
            if st == 2:
                parts.append(",")
            elif st == 0:
                kids = self.kids(v)
                if not kids:
                    parts.append(f"{self.name(v)}:{len(self.branch(v))}")
                else:
                    parts.append("(")
                    stack.append((v, 1))
                    for k in range(len(kids) - 1, -1, -1):
                        stack.append((kids[k], 0))
                        if k > 0:
                            stack.append((None, 2))
            else:
                parts.append(f"){self.name(v)}:{len(self.branch(v))}")
        parts.append(";")
        return "".join(parts)
