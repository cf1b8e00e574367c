"""matUtils annotate: assign clade annotations to internal nodes.

Three modes, parity with reference src/matUtils/annotate.cpp:
  - clade-to-nid (:170-205): explicit node assignment, last annotation column
  - clade-paths (:832-911): follow recorded mutation paths from the root
  - clade-names (:301-830): infer the best clade root per clade from its
    member samples -- clade-defining mutations (allele frequency >= f among
    members) are placed with the placement kernel, then candidate roots are
    ranked by (clipped descendant-frequency) * overlap^2 and assigned
    greedily, fewest-candidates-first, skipping already-annotated nodes.

Divergence: the reference's mask-frequency band (mutations in
[mask_freq, min_freq) become masked placeholders) is not reproduced; such
mutations are simply excluded from the defining set.
"""

from __future__ import annotations

import sys
from collections import defaultdict

from ..core.tree import Mutation, Node, Tree


def _err(*a):
    print(*a, file=sys.stderr)


def init_annotations(T: Tree, clear_current: bool) -> None:
    """Grow every node's annotation vector by one column (or reset it)
    (reference annotate.cpp init_annotations)."""
    for n in T.depth_first_expansion():
        if clear_current:
            n.clade_annotations = [""]
        else:
            n.clade_annotations = list(n.clade_annotations) + [""]


def assign_lineages_by_nid(T: Tree, clade_to_nid_file: str,
                           clear_current: bool = False) -> None:
    """clade\\tnode_id per line (annotate.cpp:170-205)."""
    init_annotations(T, clear_current)
    num_annotations = T.get_num_annotations()
    with open(clade_to_nid_file) as f:
        for line in f:
            words = line.rstrip("\n").split("\t")
            if len(words) != 2:
                raise ValueError(
                    "ERROR: Incorrect format for clade to node id "
                    f"assignment file: {clade_to_nid_file}!")
            clade, nid = words
            n = T.get_node(nid)
            if n is None:
                raise KeyError(f"ERROR: Node id {nid} not found!")
            if n.clade_annotations[num_annotations - 1] != "":
                _err(f"WARNING: Assigning clade {clade} to node {nid} failed "
                     f"as the node is already assigned to clade "
                     f"{n.clade_annotations[num_annotations-1]}!")
            else:
                n.clade_annotations[num_annotations - 1] = clade


def ancestral_mutations_of(T: Tree, node: Node) -> list[Mutation]:
    """Nearest-entry-per-position root-path mutation set (annotate.cpp
    parse_clade_names inner loop)."""
    seen: set[int] = set()
    out = []
    cur = node
    while cur is not None:
        for m in cur.mutations:
            if m.is_masked() or m.position not in seen:
                out.append(m)
                if not m.is_masked():
                    seen.add(m.position)
        cur = cur.parent
    return out


def get_freq_overlap(T: Tree, node: Node, clade_samples: set[str]):
    """(fraction of node's leaves that are clade samples,
       fraction of clade samples below node) (annotate.cpp:466-481)."""
    leaves = T.get_leaves_ids(node.identifier)
    if not leaves:
        return 0.0, 0.0
    hits = sum(1 for l in leaves if l in clade_samples)
    return hits / len(leaves), hits / max(len(clade_samples), 1)


def parse_clade_mutations(clade_mutations_file: str) -> dict[str, list[Mutation]]:
    """-M file: ``clade\\tmutation-path`` per line.  The path is
    whitespace-separated elements (optionally '>'-separated) of
    comma-separated A123G-style mutations; a first element naming a
    previously defined clade inherits its mutations
    (reference parse_clade_mutations, annotate.cpp:207-302)."""
    from .mask import parse_mutation_string
    from ..core.tree import Node as _Node
    all_clades: dict[str, list[Mutation]] = {}
    with open(clade_mutations_file) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            words = line.split("\t")
            if len(words) == 1 and line.endswith("\t"):
                words.append("")
            if len(words) != 2:
                raise ValueError(
                    f"ERROR: Incorrect format for clade mutations file: "
                    f"{clade_mutations_file}! Expected 2 tab-separated "
                    f"words, got {len(words)} ({line})")
            clade = words[0]
            if clade in all_clades:
                raise ValueError(
                    f"ERROR: clade {clade} is defined on multiple lines")
            node = _Node(clade, None, -1.0)
            mut_words = words[1].split()
            if mut_words and mut_words[0] in all_clades:
                node.mutations = [m.copy() for m in all_clades[mut_words[0]]]
                mut_words = mut_words[1:]
            for path_el in mut_words:
                if path_el in ("", ">"):
                    continue
                for mut_string in path_el.split(","):
                    if not mut_string:
                        continue
                    node.add_mutation(parse_mutation_string(mut_string))
            all_clades[clade] = node.mutations
    return all_clades


def assign_lineages_by_samples(T: Tree, clade_names_file: str,
                               min_freq: float = 0.8,
                               mask_freq: float = 0.2,
                               set_overlap: float = 0.6,
                               clip_sample_frequency: float = 0.1,
                               clear_current: bool = False,
                               mutations_out: str = "",
                               clade_mutations_file: str = "",
                               details_out: str = "") -> None:
    """clade\\tsample per line; infer + assign clade roots
    (annotate.cpp:483-806).  clade_mutations_file (-M) specifies clades'
    defining mutations directly, taking precedence over sample-based
    inference; mask_freq adds N-masked placeholders for mutations between
    the two frequency thresholds (parse_clade_names, annotate.cpp:395-417)."""
    init_annotations(T, clear_current)
    num_annotations = T.get_num_annotations()

    uncond = T.copy()
    uncond.uncondense_leaves()

    direct_mutations: dict[str, list[Mutation]] = {}
    if clade_mutations_file:
        direct_mutations = parse_clade_mutations(clade_mutations_file)

    clade_members: dict[str, list[str]] = defaultdict(list)
    if clade_names_file:
        with open(clade_names_file) as f:
            for line in f:
                words = line.rstrip("\n").split("\t")
                if len(words) != 2:
                    raise ValueError(
                        f"ERROR: Incorrect format for clade assignment file: "
                        f"{clade_names_file}! Expected 2 tab-separated words, "
                        f"got {len(words)}")
                clade, sample = words
                if clade in direct_mutations:
                    continue  # -M takes precedence (annotate.cpp:325-329)
                if uncond.get_node(sample) is None:
                    _err(f"WARNING: Sample {sample} not found in input MAT!")
                else:
                    clade_members[clade].append(sample)

    # clade-defining mutations: frequency >= min_freq among member samples;
    # between mask_freq and min_freq -> masked (N) placeholder
    clade_mutations: dict[str, list[Mutation]] = dict(direct_mutations)
    for clade, members in clade_members.items():
        counts: dict[tuple, int] = defaultdict(int)
        proto: dict[tuple, Mutation] = {}
        for s in members:
            node = uncond.get_node(s)
            for m in ancestral_mutations_of(uncond, node):
                if m.is_masked() or m.ref_nuc == m.mut_nuc:
                    continue
                key = (m.chrom, m.position, m.mut_nuc)
                counts[key] += 1
                proto[key] = m
        muts = []
        from ..core.nuc import N as _N
        for k, c in counts.items():
            frac = c / len(members)
            if frac >= min_freq:
                muts.append(proto[k].copy())
            elif frac >= mask_freq:
                mm = proto[k].copy()
                mm.mut_nuc = _N
                mm.is_missing = True
                muts.append(mm)
        muts.sort(key=lambda m: m.position)
        clade_mutations[clade] = muts

    if mutations_out:
        with open(mutations_out, "w") as f:
            f.write("clade\tmutations\n")
            for clade in sorted(clade_mutations):
                f.write(clade + "\t" + ", ".join(
                    m.get_string() for m in clade_mutations[clade]
                    if not m.is_missing) + "\n")

    # place each clade's defining mutation set; walk ancestors while the
    # member frequency monotonically increases
    from ..placement.driver import PlacementEngine
    engine = PlacementEngine(T)
    clades = sorted(clade_mutations)
    candidates: dict[str, list[tuple[float, Node]]] = {}
    for clade in clades:
        members = set(clade_members.get(clade, ()))
        if not clade_mutations[clade] and not members:
            candidates[clade] = []
            continue
        res = engine.score_samples([clade_mutations[clade]])[0]
        cand: list[tuple[float, float, Node]] = []
        if not members:
            # -M direct-mutation clade: no sample thresholds; use the
            # placement tie set directly (reference clade_size==0 handling)
            cand = [(1.0, 1.0, node) for node in res.tied_nodes]
        else:
            best_freq = -1.0
            for node in res.tied_nodes:
                cur = node
                while cur is not None:
                    freq, overlap = get_freq_overlap(T, cur, members)
                    if freq >= best_freq and overlap >= set_overlap:
                        cand.append((freq, overlap, cur))
                        best_freq = freq
                    else:
                        break
                    cur = cur.parent
            if not cand:
                _err(f"WARNING: {clade}: no placement node or ancestor "
                     f"passed thresholds.")
            # rank by clipped freq * overlap^2 (reference Node_freq)
            cand.sort(key=lambda t: -(min(t[0], clip_sample_frequency)
                                      * t[1] * t[1]))
        candidates[clade] = [(f, n) for f, o, n in cand]

    # direct-mutation clades first, then fewest candidates, larger clades
    # first (reference Clade_Assignments::operator<)
    order = sorted(clades, key=lambda c: (
        0 if not clade_members.get(c) else 1,
        len(candidates[c]), -len(clade_members.get(c, ()))))
    details_f = open(details_out, "w") if details_out else None
    if details_f:
        details_f.write("clade\tmutations\tmasked_mutations\t"
                        "node:freq:overlap\tassigned_node\n")
    for clade in order:
        assigned = False
        assigned_node = ""
        for _, node in candidates[clade]:
            if node.clade_annotations[num_annotations - 1] == "":
                node.clade_annotations[num_annotations - 1] = clade
                _err(f"Assigning {clade} to node {node.identifier}")
                assigned = True
                assigned_node = node.identifier
                break
            _err(f"Node {node.identifier} already assigned to "
                 f"{node.clade_annotations[num_annotations-1]}, cannot "
                 f"assign to {clade}.")
        if not assigned:
            _err(f"WARNING: Could not assign a node to clade {clade}!")
        if details_f:
            muts = [m.get_string() for m in clade_mutations[clade]
                    if not m.is_missing]
            masked = [m.get_string() for m in clade_mutations[clade]
                      if m.is_missing]
            cand_str = ",".join(f"{n.identifier}:{f:.3f}"
                                for f, n in candidates[clade][:5])
            details_f.write(f"{clade}\t{','.join(muts)}\t"
                            f"{','.join(masked)}\t{cand_str}\t"
                            f"{assigned_node}\n")
    if details_f:
        details_f.close()


def assign_lineages_from_paths(T: Tree, clade_paths_file: str,
                               clear_current: bool = False) -> None:
    """clade\\t[root_id\\t]path lines, path = 'node:muts node:muts ...'
    (annotate.cpp:832-911): walk from the root matching each segment's
    mutation set against children."""
    init_annotations(T, clear_current)
    num_annotations = T.get_num_annotations()
    with open(clade_paths_file) as f:
        for line in f:
            words = line.rstrip("\n").split("\t")
            if len(words) < 2:
                continue
            clade = words[0]
            path = words[-1]
            node = T.root
            ok = True
            for seg in path.split():
                muts = seg.split(":", 1)[1] if ":" in seg else seg
                want = set(m for m in muts.split(",") if m)
                found = None
                stack = list(node.children)
                while stack:
                    ch = stack.pop()
                    have = set(m.get_string() for m in ch.mutations)
                    if have == want:
                        found = ch
                        break
                    if not ch.mutations:
                        stack.extend(ch.children)  # skip empty branches
                if found is None:
                    _err(f"WARNING: couldn't find path for clade {clade}")
                    ok = False
                    break
                node = found
            if ok and node is not None:
                if node.clade_annotations[num_annotations - 1] != "":
                    _err(f"WARNING: node {node.identifier} already annotated; "
                         f"skipping clade {clade}")
                else:
                    node.clade_annotations[num_annotations - 1] = clade
