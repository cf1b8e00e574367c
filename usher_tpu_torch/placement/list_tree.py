"""Index-based structural tree ops for the no-Tree direct driver
(counterpart of usher_tpu/placement/list_tree.py).

The --pb-direct path holds the MAT as BigMAT arrays; output-stage flags
(--collapse-tree/-C, -k/-K subtrees, -o re-condense) need the host Tree's
STRUCTURAL edit semantics (collapse with merge-on-move, condense,
uncondense, subtree extraction).  ListTree provides exactly those ops over
parallel lists indexed by slot — no Node objects, no identifier hash table
of the full tree — mirroring core/tree.py (which itself mirrors the
reference mutation_annotated_tree.cpp) operation for operation:

  collapse_tree   <- Tree.collapse_tree   (m_a_t.cpp:1384-1424)
  move_node       <- Tree.move_node       (m_a_t.cpp:1135-1223)
  remove_node     <- Tree.remove_node     (m_a_t.cpp:960-1054)
  condense_leaves <- Tree.condense_leaves (m_a_t.cpp:1287-1332)
  uncondense      <- Tree.uncondense_leaves (m_a_t.cpp:1334-1382)
  write_newick    <- io/newick.write_newick (m_a_t.cpp:189-264)
  get_subtree     <- matutils/tree_filter.get_subtree (m_a_t.cpp:1577-1660)

Byte-parity with the Tree implementations is asserted by randomized
property tests (tests/test_list_tree.py) and by the end-to-end direct-vs-
Tree driver tests.
"""

from __future__ import annotations

import numpy as np

from ..core.tree import Mutation, Tree


class ListTree:
    def __init__(self):
        self.names: list[str] = []
        self.parent: list[int] = []        # -1 for the root
        self.children: list[list[int]] = []
        self.muts: list[list[Mutation]] = []
        self.ann: list[list[str]] | None = None
        self.alive: list[bool] = []
        self.root: int = 0
        self.curr_internal_node: int = 0
        self.condensed: list[tuple[str, list[str]]] = []
        self.num_annotations: int = 0
        self._name_idx: dict[str, int] | None = None

    # --- construction -------------------------------------------------------

    @classmethod
    def from_placer(cls, placer) -> "ListTree":
        """Build from a DirectPlacer's CURRENT (flushed) state: base CSR +
        per-slot deltas + appended slots."""
        from ..io import pb_arrays as pa
        big = placer.big
        big._flush()
        N = big.N
        lt = cls()
        lt.names = [placer.name_of(i) for i in range(N)]
        lt.muts = [placer.mutations_of(i) for i in range(N)]
        lt.parent = [int(p) for p in big.parent]
        lt.parent[big.root_slot] = -1
        lt.root = int(big.root_slot)
        lt.alive = [True] * N
        nr = np.nonzero(np.arange(N) != big.parent)[0]
        o = np.lexsort((big.child_key[nr], big.parent[nr]))
        lt.children = [[] for _ in range(N)]
        for s in nr[o].tolist():
            lt.children[int(big.parent[s])].append(int(s))
        anns, ncols = pa.ann_lists(placer.ma, N)
        if anns is not None:
            for i in range(placer.ma.n, N):
                anns[i] = [""] * ncols
        lt.ann = anns
        lt.num_annotations = ncols
        lt.curr_internal_node = placer._internal_counter
        lt.condensed = list(placer.ma.condensed)
        return lt

    @classmethod
    def from_arrays(cls, ma) -> "ListTree":
        """Build from loaded MatArrays (io/pb_arrays.py): slots are DFS
        preorder, internal names node_1..node_K in '(' order (the pb
        loader's renaming), so the id counter resumes at K."""
        from ..core.tree import Mutation as Mut
        from ..io import pb_arrays as pa
        n = ma.n
        lt = cls()
        lt.names = ma.names()
        lt.parent = [int(p) for p in ma.parent]
        lt.parent[0] = -1
        lt.root = 0
        lt.alive = [True] * n
        nr = np.nonzero(np.arange(n) != ma.parent)[0]
        order = nr[np.argsort(ma.parent[nr], kind="stable")]
        lt.children = [[] for _ in range(n)]
        for s in order.tolist():
            lt.children[int(ma.parent[s])].append(int(s))
        positions, ref = ma.positions, ma.ref
        lt.muts = []
        for i in range(n):
            lo, hi = int(ma.mut_ptr[i]), int(ma.mut_ptr[i + 1])
            lt.muts.append([
                Mut(ma.chrom, int(positions[ma.mut_col[k]]),
                    int(ref[ma.mut_col[k]]), int(ma.mut_par[k]),
                    int(ma.mut_mut[k])) for k in range(lo, hi)])
        anns, ncols = pa.ann_lists(ma, n)
        lt.ann = anns
        lt.num_annotations = ncols
        lt.curr_internal_node = sum(1 for c in lt.children if c)
        lt.condensed = list(ma.condensed)
        return lt

    def _index(self) -> dict[str, int]:
        if self._name_idx is None:
            self._name_idx = {self.names[i]: i
                              for i in range(len(self.names))
                              if self.alive[i]}
        return self._name_idx

    def get_node(self, name: str):
        return self._index().get(name)

    def is_leaf(self, i: int) -> bool:
        return not self.children[i]

    def new_internal_node_id(self) -> str:
        self.curr_internal_node += 1
        return f"node_{self.curr_internal_node}"

    def create_node(self, name: str, parent_idx: int) -> int:
        j = len(self.names)
        self.names.append(name)
        self.parent.append(parent_idx)
        self.children.append([])
        self.muts.append([])
        self.alive.append(True)
        if self.ann is not None:
            self.ann.append([""] * self.num_annotations)
        if parent_idx >= 0:
            self.children[parent_idx].append(j)
        if self._name_idx is not None:
            self._name_idx[name] = j
        return j

    # --- mutation-list edits (core/tree.py Node.add_mutation) ---------------

    def add_mutation(self, i: int, mut: Mutation) -> None:
        muts = self.muts[i]
        lo, hi = 0, len(muts)
        while lo < hi:
            mid = (lo + hi) // 2
            if muts[mid].position < mut.position:
                lo = mid + 1
            else:
                hi = mid
        if lo < len(muts) and muts[lo].position == mut.position:
            existing = muts[lo]
            if existing.par_nuc != mut.mut_nuc:
                existing.mut_nuc = mut.mut_nuc
            else:
                if existing.mut_nuc != mut.par_nuc:
                    raise ValueError(
                        "add_mutation: consecutive mutations at same "
                        "position disagree on nuc")
                del muts[lo]
        else:
            muts.insert(lo, mut)

    def find_child_with_muts(self, i: int, muts: list[Mutation]):
        key = sorted(muts, key=lambda m: m.position)
        for c in self.children[i]:
            if len(self.muts[c]) == len(key) and self.muts[c] == key:
                return c
        return None

    # --- structural edits ---------------------------------------------------

    def _link(self, parent_idx: int, child_idx: int) -> None:
        self.parent[child_idx] = parent_idx
        self.children[parent_idx].append(child_idx)

    def _remove_child(self, parent_idx: int, child_idx: int) -> None:
        self.children[parent_idx].remove(child_idx)
        if not self.children[parent_idx]:
            self.remove_node(parent_idx)

    def remove_node(self, i: int) -> None:
        """Remove node + subtree; clean up emptied parents
        (Tree.remove_node with move_level=False)."""
        p = self.parent[i]
        if p >= 0:
            self.children[p].remove(i)
            if not self.children[p]:
                if p == self.root:
                    raise ValueError("Tree empty!")
                self.remove_node(p)
        stack = [i]
        while stack:
            cur = stack.pop()
            stack.extend(self.children[cur])
            self.alive[cur] = False
            if self._name_idx is not None:
                self._name_idx.pop(self.names[cur], None)

    def move_node(self, src: int, dest: int) -> None:
        """Re-graft src under dest, merging with an identical-mutation
        sibling if one exists (Tree.move_node, move_level=False)."""
        curr_parent = self.parent[src]
        if curr_parent == dest:
            raise ValueError("move_node: dest is already parent of src")
        dest_existing = self.find_child_with_muts(dest, self.muts[src])
        if dest_existing == curr_parent or not self.muts[src]:
            dest_existing = None

        if dest_existing is None:
            self._link(dest, src)
            self._remove_child(curr_parent, src)
        elif self.is_leaf(dest_existing):
            if self.is_leaf(src):
                ni = self.create_node(self.new_internal_node_id(), dest)
                for m in self.muts[src]:
                    self.add_mutation(ni, m)
                self.muts[src] = []
                self.muts[dest_existing] = []
                self._link(ni, src)
                self._link(ni, dest_existing)
                self._remove_child(dest, dest_existing)
                self._remove_child(curr_parent, src)
            else:
                self.muts[dest_existing] = []
                self._link(src, dest_existing)
                self._link(dest, src)
                self._remove_child(dest, dest_existing)
                self._remove_child(curr_parent, src)
        else:
            if self.is_leaf(src):
                self.muts[src] = []
                self._link(dest_existing, src)
                self._remove_child(curr_parent, src)
            else:
                for sc in list(self.children[src]):
                    self.move_node(sc, dest_existing)

    def collapse_tree(self) -> None:
        """Collapse zero-mutation internal edges, leafmost first
        (Tree.collapse_tree)."""
        post: list[int] = []
        stack = [self.root]
        while stack:
            cur = stack.pop()
            post.append(cur)
            stack.extend(self.children[cur])
        for node in reversed(post):
            if not self.alive[node]:
                continue
            if not self.children[node]:
                continue
            parent = self.parent[node]
            if parent < 0:
                continue
            if not self.muts[node]:
                for child in list(self.children[node]):
                    self.move_node(child, parent)
            elif len(self.children[node]) == 1:
                child = self.children[node][0]
                for m in self.muts[child]:
                    self.add_mutation(node, m.copy())
                self.muts[child] = [m.copy() for m in self.muts[node]]
                self.move_node(child, parent)

    # --- condense / uncondense ---------------------------------------------

    def bfs_order(self) -> list[int]:
        from collections import deque
        out = []
        dq = deque([self.root])
        while dq:
            x = dq.popleft()
            out.append(x)
            dq.extend(self.children[x])
        return out

    def condense_leaves(self, missing=()) -> None:
        """(Tree.condense_leaves over BFS leaf order.)"""
        missing = set(missing)
        if self.condensed:
            self.uncondense_leaves()
        bfs_leaves = [i for i in self.bfs_order() if not self.children[i]]
        for l1 in bfs_leaves:
            if (not self.alive[l1] or self.names[l1] in missing
                    or self.muts[l1] or self.parent[l1] < 0):
                continue
            par = self.parent[l1]
            group = [l2 for l2 in self.children[par]
                     if self.names[l2] not in missing
                     and not self.children[l2] and self.alive[l2]
                     and not self.muts[l2]]
            if len(group) > 1:
                new_name = (f"node_{1 + len(self.condensed)}_condensed_"
                            f"{len(group)}_leaves")
                self.create_node(new_name, par)
                members = [self.names[g] for g in group]
                self.condensed.append((new_name, members))
                for g in group:
                    self.remove_node(g)

    def uncondense_leaves(self) -> None:
        """(Tree.uncondense_leaves; same replay as pb_arrays.
        expand_condensed but over the live/alive representation.)"""
        idx = self._index()
        for name, samples in self.condensed:
            n = idx.get(name)
            if n is None:
                continue
            num = len(samples)
            if num > 1 and self.muts[n]:
                self._rename(n, self.new_internal_node_id())
                for s in samples:
                    self.create_node(s, n)
            elif num > 1:
                par = self.parent[n] if self.parent[n] >= 0 else n
                self._rename(n, samples[0])
                for s in samples[1:]:
                    self.create_node(s, par)
            elif num == 1:
                self._rename(n, samples[0])
        self.condensed = []

    def _rename(self, i: int, new_name: str) -> None:
        if self._name_idx is not None:
            self._name_idx.pop(self.names[i], None)
            self._name_idx[new_name] = i
        self.names[i] = new_name

    # --- traversal / metadata ----------------------------------------------

    def dfs_intervals(self):
        """(preorder list, dfs_idx[], dfs_end[]) over live nodes."""
        n = len(self.names)
        dfs_idx = [-1] * n
        dfs_end = [-1] * n
        pre: list[int] = []
        stack = [self.root]
        while stack:
            x = stack.pop()
            dfs_idx[x] = len(pre)
            pre.append(x)
            stack.extend(reversed(self.children[x]))
        for x in reversed(pre):
            end = dfs_idx[x] + 1
            for c in self.children[x]:
                end = max(end, dfs_end[c])
            dfs_end[x] = end
        return pre, dfs_idx, dfs_end

    def num_leaves_arr(self) -> list[int]:
        pre, _, _ = self.dfs_intervals()
        nl = [0] * len(self.names)
        for x in reversed(pre):
            if not self.children[x]:
                nl[x] = 1
            else:
                nl[x] = sum(nl[c] for c in self.children[x])
        return nl

    # --- writers ------------------------------------------------------------

    def write_newick(self, uncondense: bool = False) -> str:
        """io/newick.write_newick(print_internal=True,
        print_branch_len=True) over the live structure; uncondense
        expands condensed leaves to comma-joined member names."""
        cmap = dict(self.condensed) if uncondense else {}
        parts: list[str] = []
        OPEN, CLOSE, COMMA = 0, 1, 2
        stack = [(self.root, OPEN)]
        while stack:
            cur, state = stack.pop()
            if state == COMMA:
                parts.append(",")
            elif state == OPEN:
                if not self.children[cur]:
                    nm = self.names[cur]
                    members = cmap.get(nm)
                    parts.append(",".join(members) if members else nm)
                    parts.append(":" + str(len(self.muts[cur])))
                else:
                    parts.append("(")
                    stack.append((cur, CLOSE))
                    cs = self.children[cur]
                    for k in range(len(cs) - 1, -1, -1):
                        stack.append((cs[k], OPEN))
                        if k > 0:
                            stack.append((-1, COMMA))
            else:
                parts.append(")")
                parts.append(self.names[cur])
                parts.append(":" + str(len(self.muts[cur])))
        parts.append(";")
        return "".join(parts)

    def parsimony_score(self) -> int:
        pre, _, _ = self.dfs_intervals()
        return sum(len(self.muts[x]) for x in pre)

    def mutation_path(self, name: str) -> str:
        """One root->sample line of mutation-paths.txt
        (driver.write_mutation_paths)."""
        i = self.get_node(name)
        if i is None:
            return ""
        chain = []
        cur = i
        while cur >= 0:
            if self.muts[cur]:
                chain.append(self.names[cur] + ":"
                             + ",".join(m.get_string()
                                        for m in self.muts[cur]) + " ")
            cur = self.parent[cur]
        return name + "\t" + "".join(reversed(chain)) + "\n"

    # --- export -------------------------------------------------------------

    def to_arrays(self, positions, ref, chrom, pos_index):
        """Live structure -> MatArrays (DFS preorder slots), the final
        block of the original DirectPlacer.save_pb."""
        from ..io import pb_arrays as pa
        pre, _, _ = self.dfs_intervals()
        idx_of = {x: i for i, x in enumerate(pre)}
        n2 = len(pre)
        parent2 = np.array(
            [idx_of[self.parent[x]] if self.parent[x] >= 0 else idx_of[x]
             for x in pre], np.int32)
        blob = "\0".join(self.names[x] for x in pre) + "\0"
        blob_b = blob.encode()
        name_off = np.zeros(n2 + 1, np.int64)
        name_off[1:] = np.nonzero(
            np.frombuffer(blob_b, np.uint8) == 0)[0] + 1
        mc_, mp_, mm_ = [], [], []
        ptr = np.zeros(n2 + 1, np.int64)
        for i, x in enumerate(pre):
            for m in self.muts[x]:
                if m.position < 0:
                    continue
                mc_.append(pos_index[m.position])
                mp_.append(int(m.par_nuc))
                mm_.append(int(m.mut_nuc))
            ptr[i + 1] = len(mc_)
        # the reference save writes a (possibly empty) metadata record per
        # node unconditionally (save_mat_pb / mutation_annotated_tree.cpp
        # store path) — emit zero-count records when unannotated
        if self.ann is not None:
            ann_counts2 = np.array([len(self.ann[x]) for x in pre],
                                   np.int32)
            ann_blob2 = ("\0".join(a for x in pre for a in self.ann[x])
                         + "\0").encode() if n2 else b""
        else:
            ann_counts2 = np.zeros(n2, np.int32)
            ann_blob2 = b""
        return pa.MatArrays(
            parent=parent2, names_blob=blob_b, name_off=name_off,
            blen=np.full(n2, -1.0),
            mut_ptr=ptr, mut_col=np.array(mc_, np.int32),
            mut_par=np.array(mp_, np.uint8),
            mut_mut=np.array(mm_, np.uint8),
            positions=np.asarray(positions), ref=np.asarray(ref),
            chrom=chrom, condensed=list(self.condensed),
            ann_counts=ann_counts2, ann_blob=ann_blob2)

    # --- subtree extraction (matutils/tree_filter.get_subtree) --------------

    def get_subtree(self, sample_names: list[str],
                    keep_clade_annotations: bool = False) -> Tree:
        """Compressed induced subtree over the samples as a (small) host
        Tree: kept nodes are the sample leaves plus DFS-consecutive LCAs;
        intervening edges compress with add_mutation merging."""
        import sys
        pre, dfs_idx, dfs_end = self.dfs_intervals()
        nodes = []
        for s in sample_names:
            i = self.get_node(s)
            if i is None:
                print(f"ERROR: Sample {s} not found in the tree!",
                      file=sys.stderr)
            else:
                nodes.append(i)
        nodes.sort(key=lambda i: dfs_idx[i])

        depth = {}

        def _depth(i):
            d = depth.get(i)
            if d is None:
                d = 0
                c = i
                while self.parent[c] >= 0:
                    c = self.parent[c]
                    d += 1
                depth[i] = d
            return d

        def _lca(a, b):
            while _depth(a) > _depth(b):
                a = self.parent[a]
            while _depth(b) > _depth(a):
                b = self.parent[b]
            while a != b:
                a = self.parent[a]
                b = self.parent[b]
            return a

        keep = set(nodes)
        for a, b in zip(nodes, nodes[1:]):
            keep.add(_lca(a, b))

        A = self.num_annotations if keep_clade_annotations else 0
        subtree = Tree()
        stack: list[tuple[int, object]] = []  # (orig idx, new Node)
        for x in pre:
            if x not in keep:
                continue
            while stack and not (dfs_idx[stack[-1][0]] <= dfs_idx[x]
                                 < dfs_end[stack[-1][0]]):
                stack.pop()
            if not stack:
                new_node = subtree.create_node(self.names[x], None, -1.0, A)
                path = []
                cur = x
                while cur >= 0:
                    path.append(cur)
                    cur = self.parent[cur]
                for cur in reversed(path):
                    for m in self.muts[cur]:
                        new_node.add_mutation(m.copy())
            else:
                parent_orig, parent_new = stack[-1]
                new_node = subtree.create_node(
                    self.names[x], parent_new.identifier, -1.0, A)
                path = []
                cur = x
                while cur != parent_orig:
                    path.append(cur)
                    cur = self.parent[cur]
                for cur in reversed(path):
                    for m in self.muts[cur]:
                        new_node.add_mutation(m.copy())
            if A and self.ann is not None:
                for k in range(min(A, len(self.ann[x]))):
                    new_node.clade_annotations[k] = self.ann[x][k]
            stack.append((x, new_node))
        return subtree


# --- usher-style subtree outputs (tools/subtrees.py over ListTree) ----------

class _NoCondensed:
    condensed_nodes: dict = {}


def write_single_subtree_lt(lt: ListTree, samples, outdir,
                            subtree_size,
                            retain_original_branch_len=False) -> None:
    """-K over a ListTree: one subtree with every placed sample plus
    subtree_size random context leaves (tools/subtrees.write_single_subtree
    / mutation_annotated_tree.cpp:1693-1783) — identical rng sequence, so
    outputs byte-match the Tree path."""
    import os
    import random
    import sys

    from ..matutils.translate import rotate_for_display
    from ..tools.subtrees import _write_subtree_files

    idx = lt._index()
    keep = {s for s in samples if s in idx}
    n_samples = len(keep)
    all_leaves = [lt.names[i] for i in lt.bfs_order()
                  if not lt.children[i]]
    rng = random.Random(0)
    for _ in range(len(all_leaves)):
        keep.add(rng.choice(all_leaves))
        if len(keep) >= subtree_size + n_samples:
            break
    new_T = lt.get_subtree(sorted(keep), keep_clade_annotations=False)
    rotate_for_display(new_T)
    path = os.path.join(outdir, "single-subtree")
    print(f"Writing single subtree with {subtree_size} randomly added "
          f"leaves to file {path}.nh.", file=sys.stderr)
    _write_subtree_files(_NoCondensed(), new_T, path,
                         retain_original_branch_len)


def write_sample_subtrees_lt(lt: ListTree, samples, outdir, subtree_size,
                             retain_original_branch_len=False) -> None:
    """-k over a ListTree: per not-yet-displayed sample a ~subtree_size
    subtree — 4/5 nearest by mutation distance below the smallest ancestor
    with enough leaves, 1/5 random (tools/subtrees.write_sample_subtrees /
    mutation_annotated_tree.cpp:1785-1990) — identical traversal orders
    and rng sequence to the Tree path."""
    import os
    import random
    import sys

    from collections import deque

    from ..matutils.translate import rotate_for_display
    from ..tools.subtrees import _write_subtree_files

    random_subtree_size = subtree_size // 5
    nearest_subtree_size = subtree_size - random_subtree_size
    rng = random.Random(0)
    idx = lt._index()
    num_leaves = lt.num_leaves_arr()

    def leaves_under(i):
        """BFS-from-i leaf order (Tree.get_leaves(nid))."""
        out = []
        dq = deque([i])
        while dq:
            x = dq.popleft()
            if not lt.children[x]:
                out.append(x)
            else:
                dq.extend(lt.children[x])
        return out

    displayed = [idx.get(s) is None for s in samples]
    num_subtrees = 0
    for i, sample in enumerate(samples):
        if displayed[i]:
            continue
        node = idx[sample]
        # rsearch(include_self=True)
        anc_chain = []
        cur = node
        while cur >= 0:
            anc_chain.append(cur)
            cur = lt.parent[cur]
        last_anc = node
        for anc in anc_chain:
            if num_leaves[anc] < subtree_size:
                last_anc = anc
                continue
            if num_leaves[anc] > subtree_size:
                leaves_to_keep = [lt.names[l]
                                  for l in leaves_under(last_anc)]
                in_last = set(leaves_to_keep)
                node_distances = []
                for order, l in enumerate(leaves_under(anc)):
                    if lt.names[l] in in_last:
                        continue
                    dist = 0
                    cur = l
                    while cur >= 0 and cur != anc:
                        dist += len(lt.muts[cur])
                        cur = lt.parent[cur]
                    node_distances.append((dist, order, lt.names[l]))
                node_distances.sort(key=lambda t: (t[0], t[1]))
                for _, _, lid in node_distances[:max(
                        0, nearest_subtree_size - len(leaves_to_keep))]:
                    leaves_to_keep.append(lid)
                if (nearest_subtree_size < subtree_size
                        and nearest_subtree_size < len(node_distances)):
                    remaining = node_distances[nearest_subtree_size:]
                    rng.shuffle(remaining)
                    for _, _, lid in remaining:
                        if len(leaves_to_keep) >= subtree_size:
                            break
                        leaves_to_keep.append(lid)
            else:
                leaves_to_keep = [lt.names[l] for l in leaves_under(anc)
                                  ][:subtree_size]

            new_T = lt.get_subtree(leaves_to_keep,
                                   keep_clade_annotations=False)
            rotate_for_display(new_T)
            for j in range(i + 1, len(samples)):
                if (not displayed[j]
                        and new_T.get_node(samples[j]) is not None):
                    displayed[j] = True
            num_subtrees += 1
            path = os.path.join(outdir, f"subtree-{num_subtrees}")
            print(f"Writing subtree {num_subtrees} to file {path}.nh.",
                  file=sys.stderr)
            _write_subtree_files(_NoCondensed(), new_T, path,
                                 retain_original_branch_len)
            break
