"""Subtree extraction / pruning / polytomy resolution / rerooting.

Parity: reference get_subtree (src/mutation_annotated_tree.cpp:1577-1660),
filter_master/prune_leaves (src/matUtils/filter.cpp:8-85), resolve_polytomy
and reroot_tree (src/matUtils/filter.cpp:86-313).
"""

from __future__ import annotations

import sys

from ..core.tree import Node, Tree


def _err(*a):
    print(*a, file=sys.stderr)


def _lca(a: Node, b: Node) -> Node:
    while a.level > b.level:
        a = a.parent
    while b.level > a.level:
        b = b.parent
    while a is not b:
        a = a.parent
        b = b.parent
    return a


def get_subtree(T: Tree, samples: list[str],
                keep_clade_annotations: bool = False) -> Tree:
    """Compressed induced subtree over the samples: kept nodes are the sample
    leaves plus all pairwise LCAs; edges compress intervening branches with
    add_mutation merging (reference mutation_annotated_tree.cpp:1577-1660).
    """
    sample_nodes = []
    for s in samples:
        n = T.get_node(s)
        if n is None:
            _err(f"ERROR: Sample {s} not found in the tree!")
        else:
            sample_nodes.append(n)
    T.depth_first_expansion()  # refresh dfs_idx
    sample_nodes.sort(key=lambda n: n.dfs_idx)
    keep: set[int] = {id(n) for n in sample_nodes}
    keep_nodes: dict[int, Node] = {id(n): n for n in sample_nodes}
    # pairwise LCAs = LCAs of DFS-consecutive selected leaves
    for a, b in zip(sample_nodes, sample_nodes[1:]):
        l = _lca(a, b)
        if id(l) not in keep:
            keep.add(id(l))
            keep_nodes[id(l)] = l

    num_annotations = T.get_num_annotations() if keep_clade_annotations else 0
    subtree = Tree()
    stack: list[tuple[Node, Node]] = []  # (orig kept node, new node)

    for n in T.depth_first_expansion():
        if id(n) not in keep:
            continue
        while stack and not (stack[-1][0].dfs_idx <= n.dfs_idx
                             < stack[-1][0].dfs_end_idx):
            stack.pop()
        if not stack:
            new_node = subtree.create_node(n.identifier, None, -1.0,
                                           num_annotations)
            # accumulate mutations from the original root down to n
            path = []
            cur = n
            while cur is not None:
                path.append(cur)
                cur = cur.parent
            for cur in reversed(path):
                for m in cur.mutations:
                    new_node.add_mutation(m.copy())
        else:
            parent_orig, parent_new = stack[-1]
            new_node = subtree.create_node(n.identifier,
                                           parent_new.identifier, -1.0,
                                           num_annotations)
            path = []
            cur = n
            while cur is not parent_orig:
                path.append(cur)
                cur = cur.parent
            for cur in reversed(path):
                for m in cur.mutations:
                    new_node.add_mutation(m.copy())
        if keep_clade_annotations:
            for k in range(min(num_annotations, len(n.clade_annotations))):
                if n.clade_annotations[k]:
                    new_node.clade_annotations[k] = n.clade_annotations[k]
        stack.append((n, new_node))
    return subtree


def prune_leaves(T: Tree, sample_names: list[str]) -> Tree:
    """Copy the tree and remove the named leaves (filter.cpp:26-43)."""
    subtree = T.copy()
    for s in sample_names:
        if subtree.get_node(s) is None:
            _err(f"ERROR: Sample {s} not found in the tree!")
        else:
            subtree.remove_node(s, True)
    return subtree


def get_sample_prune(T: Tree, sample_names: list[str],
                     keep_clade_annotations: bool = True) -> Tree:
    """Keep only the named samples by pruning everything else
    (filter.cpp:55-85)."""
    keep = set(sample_names)
    subtree = T.copy()
    for s in T.get_leaves_ids():
        if s not in keep and subtree.get_node(s) is not None:
            subtree.remove_node(s, False)
    if not keep_clade_annotations:
        for n in subtree.depth_first_expansion():
            n.clade_annotations = []
    return subtree


def filter_master(T: Tree, sample_names: list[str], prune: bool,
                  keep_clade_annotations: bool = True) -> Tree:
    """Dispatch like the reference (filter.cpp:8-24)."""
    if prune:
        return prune_leaves(T, sample_names)
    if len(sample_names) < 10000:
        return get_subtree(T, sample_names, keep_clade_annotations)
    return get_sample_prune(T, sample_names, keep_clade_annotations)


def resolve_polytomies(T: Tree) -> None:
    """Binary-ize polytomies with zero-length internal nodes
    (filter.cpp:86-130): children beyond the first pair chain into new
    internal nodes."""
    for node in T.breadth_first_expansion():
        while len(node.children) > 2:
            ni = T.create_node(T.new_internal_node_id(), node, 0.0)
            movers = node.children[:2]
            for c in movers:
                if c is ni:
                    continue
                node.children.remove(c)
                c.parent = ni
                ni.children.append(c)
            # keep the new internal first so chains build leftward
            node.children.remove(ni)
            node.children.insert(0, ni)
            T._update_levels(ni)


def reroot_tree(T: Tree, new_root_id: str) -> Tree:
    """Reroot at an internal node (filter.cpp:213-313): ancestors of the new
    root are re-hung beneath it with their branch mutations reversed."""
    nr = T.get_node(new_root_id)
    if nr is None:
        raise KeyError(f"reroot: node {new_root_id} not in tree")
    if nr.is_leaf():
        raise ValueError("reroot: new root must be an internal node")
    if nr.parent is None:
        return T
    # collect path root->nr
    path = []
    cur = nr
    while cur is not None:
        path.append(cur)
        cur = cur.parent
    path.reverse()  # [old_root, ..., nr]
    # detach nr from its parent; then walk the path backwards, attaching each
    # former parent as a child of its former child with reversed mutations
    for child, parent in zip(reversed(path), reversed(path[:-1])):
        # child is lower, parent above it
        parent.children.remove(child)
    new_root = nr
    new_root.parent = None
    attach_under = nr
    for parent in reversed(path[:-1]):
        # reverse the mutations that were on the child's branch
        child_branch = attach_under.mutations
        rev = []
        for m in child_branch:
            mm = m.copy()
            mm.par_nuc, mm.mut_nuc = mm.mut_nuc, mm.par_nuc
            rev.append(mm)
        parent.mutations = rev
        parent.parent = attach_under
        attach_under.children.append(parent)
        attach_under = parent
    new_root.mutations = []
    T.root = new_root
    T._update_levels(new_root)
    return T


def modify_fasta(changes, input_reference: str, output_reference: str,
                 output_name: str) -> None:
    """Apply allele changes to a reference fasta (reference modify_fasta,
    filter.cpp:176-212): used with reroot so downstream VCFs stay consistent
    with the new root's sequence."""
    from ..core.nuc import char_from_nuc_id
    from ..io.fatovcf import read_fasta
    records = read_fasta(input_reference)
    if not records:
        raise ValueError(f"ERROR: Could not read fasta {input_reference}")
    ref = list(records[0][1].upper())
    for m in changes:
        if m.position > len(ref):
            raise ValueError(
                f"ERROR: Input fasta {input_reference} has sequence length "
                f"{len(ref)}, can't apply a mutation at position "
                f"{m.position}")
        expect = char_from_nuc_id(m.ref_nuc)
        if ref[m.position - 1] != expect:
            _err(f"WARNING: expected input base at position {m.position} to "
                 f"be {expect} but found {ref[m.position - 1]}")
        ref[m.position - 1] = char_from_nuc_id(m.mut_nuc)
    seq = "".join(ref)
    with open(output_reference, "w") as f:
        f.write(f">{output_name}\n")
        for i in range(0, len(seq), 120):
            f.write(seq[i:i + 120] + "\n")


def root_path_changes(T: Tree, new_root_id: str):
    """Latest allele per position on the old-root -> new-root path (the
    `changes` reroot_tree feeds modify_fasta, filter.cpp:213-313)."""
    nr = T.get_node(new_root_id)
    if nr is None:
        raise KeyError(f"reroot: node {new_root_id} not in tree")
    chain = []
    cur = nr
    while cur is not None:
        chain.append(cur)
        cur = cur.parent
    latest = {}
    first_ref = {}
    for node in reversed(chain):
        for m in node.mutations:
            if m.position not in first_ref:
                first_ref[m.position] = m.par_nuc
            latest[m.position] = m.mut_nuc
    out = []
    from ..core.tree import Mutation
    for pos in sorted(latest):
        if latest[pos] != first_ref[pos]:
            out.append(Mutation(chrom="", position=pos,
                                ref_nuc=first_ref[pos],
                                par_nuc=first_ref[pos],
                                mut_nuc=latest[pos]))
    return out
