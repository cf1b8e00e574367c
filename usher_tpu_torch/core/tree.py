"""Host-side mutation-annotated tree (MAT).

This is the mutable, string-identified phylogeny used for orchestration and
IO; the hot compute paths operate on the flattened tensor view (core/flat.py)
on the device.  The semantics mirror the reference's "classic" MAT
(src/mutation_annotated_tree.{hpp,cpp}) exactly where they affect output
parity:

  - mutation lists kept position-sorted, with the chronological-update rule of
    add_mutation (reference mutation_annotated_tree.cpp:717-752): a second
    mutation at the same position either updates the allele or cancels the
    entry entirely (reversal).
  - internal node ids are "node_<k>" with a monotonically increasing counter
    (reference mutation_annotated_tree.hpp:125).
  - children are kept in insertion order; new children append at the end.
    BFS/DFS orders therefore match the reference, which drives placement
    tie-breaking and output ordering.
  - condense/uncondense/collapse semantics per reference
    mutation_annotated_tree.cpp:1287-1424.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Optional

from .nuc import char_from_nuc_id


class Mutation:
    """A single-position mutation annotation (one-hot nibble alleles).

    position < 0 encodes a masked mutation (details unknown); matches the
    reference's convention (mutation_annotated_tree.hpp:42-44).
    """

    __slots__ = ("chrom", "position", "ref_nuc", "par_nuc", "mut_nuc", "is_missing")

    def __init__(self, chrom="", position=0, ref_nuc=0, par_nuc=0, mut_nuc=0,
                 is_missing=False):
        self.chrom = chrom
        self.position = position
        self.ref_nuc = ref_nuc
        self.par_nuc = par_nuc
        self.mut_nuc = mut_nuc
        self.is_missing = is_missing

    def is_masked(self) -> bool:
        return self.position < 0

    def copy(self) -> "Mutation":
        return Mutation(self.chrom, self.position, self.ref_nuc, self.par_nuc,
                        self.mut_nuc, self.is_missing)

    def get_string(self) -> str:
        """e.g. "A23403G"; "MASKED" for masked (ref mutation_annotated_tree.hpp:79-86)."""
        if self.is_masked():
            return "MASKED"
        return (char_from_nuc_id(self.par_nuc) + str(self.position)
                + char_from_nuc_id(self.mut_nuc))

    def __repr__(self):
        return f"Mutation({self.get_string()})"

    def __eq__(self, other):
        return (self.position == other.position
                and self.is_missing == other.is_missing
                and self.chrom == other.chrom
                and self.par_nuc == other.par_nuc
                and self.mut_nuc == other.mut_nuc)

    def __lt__(self, other):
        return self.position < other.position


class Node:
    __slots__ = ("identifier", "parent", "children", "mutations", "level",
                 "branch_length", "clade_annotations", "dfs_idx", "dfs_end_idx",
                 "slot")

    def __init__(self, identifier: str, parent: Optional["Node"], branch_length: float):
        self.identifier = identifier
        self.parent = parent
        self.children: list[Node] = []
        self.mutations: list[Mutation] = []
        self.level = 1 if parent is None else parent.level + 1
        self.branch_length = branch_length
        self.clade_annotations: list[str] = []
        self.dfs_idx = 0
        self.dfs_end_idx = 0
        # Stable index into the device-resident flat arrays (set by FlatMAT).
        self.slot = -1

    def is_leaf(self) -> bool:
        return not self.children

    def is_root(self) -> bool:
        return self.parent is None

    def add_mutation(self, mut: Mutation) -> None:
        """Sorted insert with chronological same-position semantics
        (reference mutation_annotated_tree.cpp:717-752)."""
        muts = self.mutations
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
                        "add_mutation: consecutive mutations at same position "
                        f"disagree on nuc ({existing.get_string()} > {mut.get_string()})")
                del muts[lo]
        else:
            muts.insert(lo, mut)

    def clear_mutations(self) -> None:
        self.mutations = []

    def find_child_with_muts(self, muts: list[Mutation]) -> Optional["Node"]:
        """Child with an identical (position-sorted) mutation list, else None
        (reference mutation_annotated_tree.cpp:762-781)."""
        muts = sorted(muts, key=lambda m: m.position)
        for child in self.children:
            if len(child.mutations) == len(muts) and child.mutations == muts:
                return child
        return None

    def __repr__(self):
        return f"Node({self.identifier})"


class MissingSample:
    """A sample present in the VCF but absent from the tree; to be placed.

    Mirrors reference usher_graph.hpp:33-53.
    """

    __slots__ = ("name", "mutations", "num_ambiguous", "best_clade_assignment",
                 "clade_assignments")

    def __init__(self, name: str):
        self.name = name
        self.mutations: list[Mutation] = []
        self.num_ambiguous = 0
        self.best_clade_assignment: list[str] = []
        self.clade_assignments: list[list[str]] = []


class Tree:
    def __init__(self):
        self.root: Optional[Node] = None
        self._all_nodes: dict[str, Node] = {}
        self.condensed_nodes: dict[str, list[str]] = {}
        self.condensed_leaves: set[str] = set()
        self.curr_internal_node = 0

    # --- identity / lookup -------------------------------------------------

    def new_internal_node_id(self) -> str:
        self.curr_internal_node += 1
        return f"node_{self.curr_internal_node}"

    def get_node(self, nid: str) -> Optional[Node]:
        return self._all_nodes.get(nid)

    def __contains__(self, nid: str) -> bool:
        return nid in self._all_nodes

    def num_nodes(self) -> int:
        return len(self._all_nodes)

    def get_num_annotations(self) -> int:
        return len(self.root.clade_annotations) if self.root is not None else 0

    # --- construction ------------------------------------------------------

    def create_node(self, identifier: str, parent=None, branch_length: float = -1.0,
                    num_annotations: int = 0) -> Node:
        if parent is None:
            # Creating a root resets the node table (reference
            # mutation_annotated_tree.cpp:881-890).
            self._all_nodes = {}
            n = Node(identifier, None, branch_length)
            n.clade_annotations = [""] * num_annotations
            self.root = n
            self._all_nodes[identifier] = n
            return n
        if isinstance(parent, str):
            parent = self._all_nodes[parent]
        if identifier in self._all_nodes:
            raise ValueError(f"{identifier} already in the tree!")
        n = Node(identifier, parent, branch_length)
        n.clade_annotations = [""] * self.get_num_annotations()
        self._all_nodes[identifier] = n
        parent.children.append(n)
        return n

    def rename_node(self, old_nid: str, new_nid: str) -> None:
        n = self._all_nodes.get(old_nid)
        if n is None:
            raise KeyError(old_nid)
        if new_nid in self._all_nodes:
            raise ValueError(f"rename_node: node {new_nid} already exists")
        n.identifier = new_nid
        del self._all_nodes[old_nid]
        self._all_nodes[new_nid] = n

    # --- traversal ---------------------------------------------------------

    def breadth_first_expansion(self, nid: str = "") -> list[Node]:
        if not nid:
            if self.root is None:
                return []
            node = self.root
        else:
            node = self._all_nodes[nid]
        out = []
        q = deque([node])
        while q:
            cur = q.popleft()
            out.append(cur)
            q.extend(cur.children)
        return out

    def depth_first_expansion(self, node: Optional[Node] = None) -> list[Node]:
        """Preorder traversal; sets dfs_idx/dfs_end_idx like the reference
        (mutation_annotated_tree.cpp:1253-1273)."""
        if node is None:
            node = self.root
        if node is None:
            return []
        out: list[Node] = []
        # Iterative preorder with explicit post hooks to set dfs_end_idx.
        stack: list[tuple[Node, bool]] = [(node, False)]
        while stack:
            cur, done = stack.pop()
            if done:
                cur.dfs_end_idx = len(out)
                continue
            cur.dfs_idx = len(out)
            out.append(cur)
            stack.append((cur, True))
            for c in reversed(cur.children):
                stack.append((c, False))
        return out

    def rsearch(self, nid: str, include_self: bool = False) -> list[Node]:
        node = self._all_nodes.get(nid)
        if node is None:
            return []
        out = [node] if include_self else []
        while node.parent is not None:
            out.append(node.parent)
            node = node.parent
        return out

    def is_ancestor(self, anc_id: str, nid: str) -> bool:
        node = self._all_nodes[nid]
        while node.parent is not None:
            node = node.parent
            if node.identifier == anc_id:
                return True
        return False

    def get_leaves(self, nid: str = "") -> list[Node]:
        return [n for n in self.breadth_first_expansion(nid) if n.is_leaf()]

    def get_leaves_ids(self, nid: str = "") -> list[str]:
        return [n.identifier for n in self.breadth_first_expansion(nid) if n.is_leaf()]

    def get_num_leaves(self, node: Optional[Node] = None) -> int:
        if node is None:
            node = self.root
        if node.is_leaf():
            return 1
        count = 0
        stack = [node]
        while stack:
            cur = stack.pop()
            if cur.is_leaf():
                count += 1
            else:
                stack.extend(cur.children)
        return count

    def get_max_level(self) -> int:
        return max((n.level for n in self._all_nodes.values()), default=0)

    def get_parsimony_score(self) -> int:
        return sum(len(n.mutations) for n in self._all_nodes.values())

    def get_clade_assignment(self, node: Node, clade_id: int, include_self: bool = True) -> str:
        """First non-empty annotation walking up from node
        (reference mutation_annotated_tree.cpp:950-958)."""
        anc = node if include_self else node.parent
        while anc is not None:
            if clade_id < len(anc.clade_annotations) and anc.clade_annotations[clade_id] != "":
                return anc.clade_annotations[clade_id]
            anc = anc.parent
        return "UNDEFINED"

    # --- structural edits --------------------------------------------------

    def _update_levels(self, start: Node) -> None:
        q = deque([start])
        while q:
            cur = q.popleft()
            cur.level = cur.parent.level + 1 if cur.parent is not None else 1
            q.extend(cur.children)

    def remove_node(self, nid: str, move_level: bool) -> None:
        """Remove node and its subtree; clean up empty/single-child parents
        (reference mutation_annotated_tree.cpp:960-1054)."""
        source = self._all_nodes.get(nid)
        if source is None:
            raise KeyError(f"remove_node: {nid} not found")
        curr_parent = source.parent
        if curr_parent is not None:
            curr_parent.children.remove(source)
            if not curr_parent.children:
                if curr_parent is self.root:
                    raise ValueError("Tree empty!")
                self.remove_node(curr_parent.identifier, move_level)
            elif move_level and len(curr_parent.children) == 1:
                child = curr_parent.children[0]
                if curr_parent.parent is not None:
                    for k in range(len(curr_parent.clade_annotations)):
                        if child.clade_annotations[k] == "":
                            child.clade_annotations[k] = curr_parent.clade_annotations[k]
                    child.parent = curr_parent.parent
                    child.branch_length += curr_parent.branch_length
                    tmp = child.mutations
                    child.mutations = []
                    for m in curr_parent.mutations:
                        child.add_mutation(m)
                    for m in tmp:
                        child.add_mutation(m)
                    curr_parent.parent.children.append(child)
                    curr_parent.parent.children.remove(curr_parent)
                    self._update_levels(child)
                del self._all_nodes[curr_parent.identifier]
        # remove source subtree from the table
        q = deque([source])
        while q:
            cur = q.popleft()
            q.extend(cur.children)
            del self._all_nodes[cur.identifier]

    def remove_single_child_nodes(self) -> None:
        for n in self.breadth_first_expansion():
            if n is self.root or len(n.children) != 1:
                continue
            if n.identifier not in self._all_nodes:
                continue
            child = n.children[0]
            if n.parent is not None:
                child.parent = n.parent
                child.branch_length += n.branch_length
                tmp = child.mutations
                child.mutations = []
                for m in n.mutations:
                    child.add_mutation(m)
                for m in tmp:
                    child.add_mutation(m)
                n.parent.children.append(child)
                n.parent.children.remove(n)
                self._update_levels(child)
                del self._all_nodes[n.identifier]

    def _link(self, parent: Node, child: Node) -> None:
        child.parent = parent
        child.branch_length = -1.0
        parent.children.append(child)

    def _remove_child(self, parent: Node, child: Node, move_level: bool) -> None:
        parent.children.remove(child)
        if not parent.children:
            self.remove_node(parent.identifier, move_level)

    def move_node(self, source_id: str, dest_id: str, move_level: bool = True) -> None:
        """Re-graft source under destination, merging with an identical-mutation
        sibling if one exists (reference mutation_annotated_tree.cpp:1135-1223)."""
        source = self._all_nodes[source_id]
        destination = self._all_nodes[dest_id]
        curr_parent = source.parent
        if curr_parent is destination:
            raise ValueError(f"move_node: {dest_id} is already parent of {source_id}")

        dest_existing = destination.find_child_with_muts(source.mutations)
        if dest_existing is curr_parent or not source.mutations:
            dest_existing = None

        need_level_update: list[Node] = []
        if dest_existing is None:
            self._link(destination, source)
            self._remove_child(curr_parent, source, move_level)
            need_level_update.append(source)
        elif dest_existing.is_leaf():
            if source.is_leaf():
                new_internal = self.create_node(self.new_internal_node_id(), destination, -1.0)
                for m in source.mutations:
                    new_internal.add_mutation(m)
                source.mutations = []
                dest_existing.mutations = []
                self._link(new_internal, source)
                self._link(new_internal, dest_existing)
                self._remove_child(destination, dest_existing, move_level)
                self._remove_child(curr_parent, source, move_level)
                need_level_update.append(new_internal)
            else:
                dest_existing.mutations = []
                self._link(source, dest_existing)
                self._link(destination, source)
                self._remove_child(destination, dest_existing, move_level)
                self._remove_child(curr_parent, source, move_level)
                need_level_update.append(source)
        else:
            if source.is_leaf():
                source.mutations = []
                self._link(dest_existing, source)
                self._remove_child(curr_parent, source, move_level)
                need_level_update.append(source)
            else:
                for source_child in list(source.children):
                    self.move_node(source_child.identifier, dest_existing.identifier,
                                   move_level)
                return

        for start in need_level_update:
            self._update_levels(start)

    # --- condense / collapse ----------------------------------------------

    def condense_leaves(self, missing_samples: Iterable[str] = ()) -> None:
        """Condense identical (zero-mutation) leaves of a polytomy into a
        single node (reference mutation_annotated_tree.cpp:1287-1332)."""
        missing = set(missing_samples)
        if self.condensed_nodes:
            self.uncondense_leaves()
        for l1_id in self.get_leaves_ids():
            l1 = self.get_node(l1_id)
            if l1 is None or l1.identifier in missing or l1.mutations:
                continue
            polytomy_nodes = [
                l2 for l2 in l1.parent.children
                if l2.identifier not in missing and l2.is_leaf()
                and self.get_node(l2.identifier) is not None and not l2.mutations
            ]
            if len(polytomy_nodes) > 1:
                new_name = (f"node_{1 + len(self.condensed_nodes)}_condensed_"
                            f"{len(polytomy_nodes)}_leaves")
                new_node = self.create_node(new_name, l1.parent, l1.branch_length)
                new_node.clear_mutations()
                self.condensed_nodes[new_name] = [n.identifier for n in polytomy_nodes]
                for leaf_name in self.condensed_nodes[new_name]:
                    self.condensed_leaves.add(leaf_name)
                    self.remove_node(leaf_name, False)

    def uncondense_leaves(self) -> None:
        """Expand condensed nodes back to individual leaves
        (reference mutation_annotated_tree.cpp:1334-1382)."""
        for name, samples in self.condensed_nodes.items():
            n = self.get_node(name)
            par = n.parent if n.parent is not None else n
            num_samples = len(samples)
            if num_samples > 1 and n.mutations:
                del self._all_nodes[n.identifier]
                n.identifier = self.new_internal_node_id()
                self._all_nodes[n.identifier] = n
                for s in samples:
                    new_n = Node(s, n, -1.0)
                    new_n.clade_annotations = [""] * self.get_num_annotations()
                    self._all_nodes[s] = new_n
                    n.children.append(new_n)
            elif num_samples > 1:
                del self._all_nodes[n.identifier]
                n.identifier = samples[0]
                self._all_nodes[n.identifier] = n
                for s in samples[1:]:
                    new_n = Node(s, par, n.branch_length)
                    new_n.clade_annotations = [""] * self.get_num_annotations()
                    self._all_nodes[s] = new_n
                    par.children.append(new_n)
            elif num_samples == 1:
                del self._all_nodes[n.identifier]
                n.identifier = samples[0]
                self._all_nodes[n.identifier] = n
        self.condensed_nodes = {}
        self.condensed_leaves = set()

    def collapse_tree(self) -> None:
        """Collapse zero-mutation internal edges (reference
        mutation_annotated_tree.cpp:1384-1424), iteratively (leafmost first)."""
        if self.root is None:
            return
        # Post-order without recursion.
        post: list[Node] = []
        stack = [self.root]
        while stack:
            cur = stack.pop()
            post.append(cur)
            stack.extend(cur.children)
        for node in reversed(post):
            if node.identifier not in self._all_nodes:
                continue  # already merged/removed by an earlier move
            if not node.children:
                continue
            parent = node.parent
            if parent is None:
                continue
            if not node.mutations:
                for child in list(node.children):
                    self.move_node(child.identifier, parent.identifier, False)
            elif len(node.children) == 1:
                child = node.children[0]
                for m in child.mutations:
                    node.add_mutation(m.copy())
                child.mutations = []
                for m in node.mutations:
                    child.mutations.append(m.copy())
                self.move_node(child.identifier, parent.identifier, False)

    # --- copy ---------------------------------------------------------------

    def copy(self) -> "Tree":
        """Deep copy preserving child order and the internal-node id counter
        (reference get_tree_copy, mutation_annotated_tree.cpp:1660+)."""
        t = Tree()
        t.curr_internal_node = self.curr_internal_node
        t.condensed_nodes = {k: list(v) for k, v in self.condensed_nodes.items()}
        t.condensed_leaves = set(self.condensed_leaves)
        if self.root is None:
            return t
        mapping: dict[Node, Node] = {}
        new_root = Node(self.root.identifier, None, self.root.branch_length)
        new_root.mutations = [m.copy() for m in self.root.mutations]
        new_root.clade_annotations = list(self.root.clade_annotations)
        t.root = new_root
        t._all_nodes[new_root.identifier] = new_root
        mapping[self.root] = new_root
        stack = [self.root]
        while stack:
            cur = stack.pop()
            new_cur = mapping[cur]
            for c in cur.children:
                nc = Node(c.identifier, new_cur, c.branch_length)
                nc.mutations = [m.copy() for m in c.mutations]
                nc.clade_annotations = list(c.clade_annotations)
                new_cur.children.append(nc)
                t._all_nodes[nc.identifier] = nc
                mapping[c] = nc
                stack.append(c)
        return t
