"""Newick parse/emit, byte-compatible with the reference.

Parser semantics (reference mutation_annotated_tree.cpp:415-520):
  - internal node labels in the input are DISCARDED; every internal node gets
    a fresh auto-id "node_<k>" in order of '(' occurrence (preorder).
  - branch lengths parse from the characters [0-9.eE+-] after ':'; absent
    lengths become -1.0.

Writer semantics (reference mutation_annotated_tree.cpp:215-346):
  - branch length printed for every node as the NUMBER OF MUTATIONS on the
    branch (the reference's "band-aid" at :230 forces this even when asked to
    retain input branch lengths).
  - with uncondense_leaves, a condensed leaf expands to its comma-joined
    member names, and the branch length attaches only after the last member.
"""

from __future__ import annotations

import re

from ..core.tree import Tree

_TOKEN = re.compile(r"[(),;:]|[^(),;:]+")


def parse_newick_string(newick: str, tree: Tree | None = None) -> Tree:
    T = tree if tree is not None else Tree()

    # Tokenize (whitespace is not meaningful in our inputs).
    tokens = [t for t in _TOKEN.findall(newick) if t.strip() != ""]
    ntok = len(tokens)

    def parse_branch_length(i):
        # after ':' consume one token of length chars, filtering like the
        # reference does (digits, '.', 'e', 'E', '-', '+').
        if i < ntok and tokens[i] not in "(),;:":
            s = "".join(ch for ch in tokens[i] if ch.isdigit() or ch in ".eE-+")
            i += 1
            if s:
                return float(s), i
        return -1.0, i

    # Recursive-descent with explicit stack. Each '(' creates an internal
    # node immediately (fresh id, preorder), matching reference id order.
    parent_stack = []
    i = 0
    root_created = False
    while i < ntok:
        tok = tokens[i]
        if tok == "(":
            nid = T.new_internal_node_id()
            if not parent_stack:
                if root_created:
                    raise ValueError("incorrect Newick format: multiple roots")
                node = T.create_node(nid, None, -1.0)
                root_created = True
            else:
                node = T.create_node(nid, parent_stack[-1], -1.0)
            parent_stack.append(node)
            i += 1
        elif tok == ")":
            if not parent_stack:
                raise ValueError("incorrect Newick format: unbalanced ')'")
            node = parent_stack.pop()
            i += 1
            # optional internal label: discarded (reference drops it)
            if i < ntok and tokens[i] not in "(),;:":
                i += 1
            if i < ntok and tokens[i] == ":":
                bl, i = parse_branch_length(i + 1)
                node.branch_length = bl
        elif tok == ",":
            i += 1
        elif tok == ";":
            i += 1
        elif tok == ":":
            # dangling branch length without a preceding name: leaf with empty id
            raise ValueError("incorrect Newick format: unexpected ':'")
        else:
            name = tok
            i += 1
            bl = -1.0
            if i < ntok and tokens[i] == ":":
                bl, i = parse_branch_length(i + 1)
            if not parent_stack:
                if root_created:
                    raise ValueError("incorrect Newick format: multiple roots")
                T.create_node(name, None, bl)
                root_created = True
            else:
                T.create_node(name, parent_stack[-1], bl)
    if parent_stack:
        raise ValueError("incorrect Newick format: unbalanced '('")
    return T


def parse_newick(filename: str, tree: Tree | None = None) -> Tree:
    with open(filename) as f:
        newick = f.readline().rstrip("\n")
    return parse_newick_string(newick, tree)


def _fmt_len(n_muts: int) -> str:
    return str(n_muts)


def write_newick(T: Tree, node=None, print_internal: bool = True,
                 print_branch_len: bool = True,
                 retain_original_branch_len: bool = False,
                 uncondense_leaves: bool = False,
                 use_stored_branch_len: bool = False) -> str:
    """Serialize the subtree rooted at `node` (default: tree root).

    retain_original_branch_len is accepted for CLI parity but has no effect:
    the reference's classic writer always emits mutation counts
    (mutation_annotated_tree.cpp:229-230).  use_stored_branch_len selects
    the compact-MAT writer semantics instead (branch_length field verbatim,
    e.g. EPP counts; mutation_annotated_tree_load_store.cpp:71-129).
    """
    if node is None:
        node = T.root
    if node is None:
        return ";"

    def _blen(cur):
        if use_stored_branch_len:
            bl = float(cur.branch_length)
            return str(int(bl)) if bl.is_integer() else f"{bl:.6g}"
        return _fmt_len(len(cur.mutations))
    parts: list[str] = []
    OPEN, CLOSE, COMMA = 0, 1, 2
    stack: list[tuple[object, int]] = [(node, OPEN)]
    while stack:
        cur, state = stack.pop()
        if state == COMMA:
            parts.append(",")
        elif state == OPEN:
            if cur.is_leaf():
                if uncondense_leaves and cur.identifier in T.condensed_nodes:
                    parts.append(",".join(T.condensed_nodes[cur.identifier]))
                else:
                    parts.append(cur.identifier)
                if print_branch_len:
                    parts.append(":" + _blen(cur))
            else:
                parts.append("(")
                stack.append((cur, CLOSE))
                cs = cur.children
                for k in range(len(cs) - 1, -1, -1):
                    stack.append((cs[k], OPEN))
                    if k > 0:
                        stack.append((None, COMMA))
        else:
            parts.append(")")
            if print_internal:
                parts.append(cur.identifier)
            if print_branch_len:
                parts.append(":" + _blen(cur))
    parts.append(";")
    return "".join(parts)
