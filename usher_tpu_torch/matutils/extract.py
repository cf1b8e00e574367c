"""matUtils extract: select samples, manipulate, write every output format.

Flow parity with reference src/matUtils/extract.cpp:106-780 (selection
intersection -> optional mrca expansion / random fill / representatives ->
prune or subtree -> polytomy resolution / collapse -> writers).
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field

from ..core.tree import Tree
from ..io.newick import write_newick
from ..io.pbio import save_mat_pb
from . import select as sel
from . import convert as conv
from . import describe
from .tree_filter import filter_master, resolve_polytomies, reroot_tree


def _err(*a):
    print(*a, file=sys.stderr)


@dataclass
class ExtractOptions:
    input_mat: str = ""
    samples_file: str = ""
    clade: str = ""
    mutation: str = ""
    match: str = ""
    max_epps: int = 0
    max_parsimony: int = -1
    max_branch_length: int = -1
    max_path_length: int = -1
    max_mutation_density: float = 0.0
    nearest_k: str = ""
    set_size: int = 0
    limit_to_lca: bool = False
    get_internal_descendents: str = ""
    from_mrca: bool = False
    get_representative: int = 0
    prune: bool = False
    resolve_polytomies: bool = False
    outdir: str = "./"
    used_samples: str = ""
    sample_paths: str = ""
    clade_paths: str = ""
    all_paths: str = ""
    write_diff: str = ""
    write_vcf: str = ""
    no_genotypes: bool = False
    collapse_tree: bool = False
    write_mat: str = ""
    write_json: str = ""
    write_tree: str = ""
    retain_branch_length: bool = False
    reroot: str = ""
    write_reroot_reference: str = ""  # rewrite --input-fasta for the new
                                      # root (filter.cpp:176-212)
    metadata: str = ""
    title: str = "mutation_annotated_tree"
    usher_single_subtree_size: int = 0
    usher_minimum_subtrees_size: int = 0
    minimum_subtrees_size: int = 0   # -N: JSON/newick covering subtrees
                                     # (reference extract.cpp:93-94)
    usher_clades_txt: bool = False   # usher-style clades.txt for selected
                                     # samples (extract.cpp:103-104)
    usher_anchor_samples: str = ""   # context samples for usher subtrees
                                     # (extract.cpp:105-106)
    add_random: int = 0              # -W (extract.cpp:107-108)
    select_nearest: int = 0          # -Y (extract.cpp:109-110)
    closest_relatives: str = ""      # -V tsv of closest relative(s)
                                     # (extract.cpp:111-112)
    break_ties: bool = False         # -q one relative per sample
                                     # (extract.cpp:113-114)
    within_distance: str = ""        # tsv of relatives within threshold
                                     # (extract.cpp:115-116)
    distance_threshold: int = 0      # (extract.cpp:117-118)
    dump_metadata: str = ""          # -Q final metadata tsv
                                     # (extract.cpp:119-120)
    whitelist: str = ""              # -L always-retained samples
                                     # (extract.cpp:121-122)
    load_all_metadata: bool = False  # (extract.cpp:123-124)
    nearest_k_batch: str = ""        # -K file.txt:k per-sample context jsons
                                     # (extract.cpp:39-40, :731-767)
    seed: int = 0
    # Taxodium export (reference extract.cpp --write-taxodium and friends)
    write_taxodium: str = ""
    input_gtf: str = ""
    input_fasta: str = ""
    description: str = ""
    extra_fields: str = ""
    x_scale: float = 0.2
    include_nt: bool = False


def select_samples(T: Tree, opts: ExtractOptions) -> list[str]:
    """Every active filter produces a sample list; lists intersect
    (reference extract.cpp:300-480)."""
    sets: list[list[str]] = []
    if opts.samples_file:
        named = sel.read_sample_names(opts.samples_file)
        present = []
        for s in named:
            n = T.get_node(s)
            if n is None or not n.is_leaf():
                _err(f"WARNING: sample {s} not found in the tree; ignoring")
            else:
                present.append(s)
        sets.append(present)
    if opts.clade:
        got: list[str] = []
        for c in opts.clade.split(","):
            cs = sel.get_clade_samples(T, c.strip())
            if not cs:
                _err(f"ERROR: clade {c} not found in tree")
            got.extend(cs)
        sets.append(got)
    if opts.mutation:
        got = []
        for m in opts.mutation.split(","):
            got.extend(sel.get_mutation_samples(T, m.strip()))
        sets.append(got)
    if opts.match:
        sets.append(sel.get_sample_match(T, opts.match))
    if opts.max_parsimony >= 0:
        sets.append(sel.get_parsimony_samples(T, opts.max_parsimony))
    if opts.get_internal_descendents:
        sets.append(sel.get_internal_descendents(
            T, opts.get_internal_descendents))
    if opts.nearest_k:
        sample_id, _, k = opts.nearest_k.rpartition(":")
        sets.append(sel.get_nearby(T, sample_id, int(k)))
    if opts.max_epps > 0:
        from .uncertainty import get_samples_under_max_epps
        sets.append(get_samples_under_max_epps(T, opts.max_epps))

    if not sets:
        samples = T.get_leaves_ids()
    else:
        samples = sets[0]
        for other in sets[1:]:
            os_ = set(other)
            samples = [s for s in samples if s in os_]
    # ordered, deduplicated
    samples = list(dict.fromkeys(samples))

    if opts.max_branch_length >= 0:
        samples = sel.get_short_steppers(T, samples, opts.max_branch_length)
    if opts.max_path_length >= 0:
        samples = sel.get_short_paths(T, samples, opts.max_path_length)
    if opts.max_mutation_density > 0:
        samples = sel.filter_mut_density(T, samples, opts.max_mutation_density)
    if opts.from_mrca and samples:
        samples = sel.get_mrca_samples(T, samples)
    if opts.select_nearest > 0:
        # -Y: add the y nearest samples to each selected sample
        # (extract.cpp:429-441)
        extra: list[str] = []
        have = set(samples)
        for s in samples:
            for n in sel.get_nearby(T, s, opts.select_nearest):
                if n not in have:
                    have.add(n)
                    extra.append(n)
        samples = samples + extra
    if opts.set_size > 0 or opts.add_random > 0:
        # -z sets the total; otherwise -W adds exactly W randoms
        # (extract.cpp:442-450)
        target = opts.set_size if opts.set_size > 0 \
            else opts.add_random + len(samples)
        samples = sel.fill_random_samples(T, samples, target,
                                          opts.limit_to_lca, opts.seed)
    if opts.whitelist:
        # -L: whitelisted samples join AFTER all other selection
        # (extract.cpp:473-483)
        _err("Whitelisting samples...")
        have = set(samples)
        for w in sel.read_sample_names(opts.whitelist):
            if w in have:
                continue
            n = T.get_node(w)
            if n is None or not n.is_leaf():
                _err(f"WARNING: whitelisted sample {w} not found in the "
                     f"tree; ignoring")
                continue
            have.add(w)
            samples.append(w)
    return samples


def extract_main(T: Tree, opts: ExtractOptions) -> int:
    os.makedirs(opts.outdir, exist_ok=True)

    def out(p):
        return os.path.join(opts.outdir, p)

    if opts.reroot:
        if opts.write_reroot_reference:
            if not opts.input_fasta:
                _err("ERROR: --write-reroot-reference requires --input-fasta")
                return 1
            from .tree_filter import modify_fasta, root_path_changes
            changes = root_path_changes(T, opts.reroot)
            modify_fasta(changes, opts.input_fasta,
                         out(opts.write_reroot_reference), opts.reroot)
        T = reroot_tree(T, opts.reroot)
    if T.condensed_nodes:
        T.uncondense_leaves()

    samples = select_samples(T, opts)
    if not samples:
        _err("ERROR: No samples fulfill selected criteria. Change arguments "
             "and try again")
        return 1
    _err(f"{len(samples)} samples selected.")

    # usher-style subtrees are produced against the FULL input tree, before
    # sample-selection filtering (reference extract.cpp:518-583)
    if opts.usher_single_subtree_size or opts.usher_minimum_subtrees_size:
        from ..tools.subtrees import write_single_subtree, write_sample_subtrees
        anchors: list[str] = []
        if opts.usher_anchor_samples:
            anchors = sel.read_sample_names(opts.usher_anchor_samples)
            if not anchors:
                _err("ERROR: --usher-anchor-samples file is empty or "
                     "unparseable!")
                return 1
        if opts.usher_minimum_subtrees_size:
            write_sample_subtrees(T, samples, opts.outdir,
                                  opts.usher_minimum_subtrees_size,
                                  anchor_samples=anchors)
        if opts.usher_single_subtree_size:
            write_single_subtree(T, samples, opts.outdir,
                                 opts.usher_single_subtree_size,
                                 anchor_samples=anchors)
        if opts.usher_clades_txt and T.get_num_annotations() > 0:
            # usher-style clades.txt for the selected samples
            # (extract.cpp:558-583)
            path = out("clades.txt")
            _err(f"Writing clade annotations to file {path}")
            with open(path, "w") as f:
                for s in samples:
                    node = T.get_node(s)
                    if node is None:
                        continue
                    f.write(s)
                    for k in range(T.get_num_annotations()):
                        f.write("\t" + T.get_clade_assignment(
                            node, k, False))
                    f.write("\n")

    all_leaves = T.get_leaves_ids()
    if len(samples) < len(all_leaves) or opts.prune:
        subtree = filter_master(T, samples, opts.prune,
                                keep_clade_annotations=True)
    else:
        subtree = T

    if opts.get_representative > 0:
        reps = sel.get_clade_representatives(subtree, opts.get_representative)
        if reps:
            subtree = filter_master(subtree, reps, False, True)
            samples = reps

    if opts.resolve_polytomies:
        resolve_polytomies(subtree)
    if opts.collapse_tree:
        subtree.collapse_tree()

    final_samples = (subtree.get_leaves_ids() if not opts.prune
                     else subtree.get_leaves_ids())

    if opts.nearest_k_batch:
        # -K file.txt:k — one <sample>_context.json per listed sample, each
        # the compressed subtree of the sample's k nearest neighbours in the
        # ORIGINAL tree (extract.cpp:731-767; files land in outdir rather
        # than the reference's CWD)
        sample_file, _, nkstr = opts.nearest_k_batch.rpartition(":")
        if not sample_file:
            _err("ERROR: Invalid formatting of -K argument. Requires input "
                 "in the form of 'sample_file.txt:k' to generate json "
                 "context files")
            return 1
        nk = int(nkstr)
        if nk <= 0:
            _err("ERROR: Invalid neighborhood size. Please choose a "
                 "positive nonzero integer.")
            return 1
        _err("Batch sample context writing requested.")
        batch_meta = {}
        if opts.metadata:
            for mpath in opts.metadata.split(","):
                batch_meta.update(conv.read_metafile(
                    mpath, load_all=opts.load_all_metadata,
                    samples_to_use=set(samples)))
        written = 0
        for bs in sel.read_sample_names(sample_file):
            cs = sel.get_nearby(T, bs, nk)
            if not cs:
                continue
            subt = filter_master(T, cs, False, keep_clade_annotations=True)
            conv.write_json_from_mat(
                subt, out(bs.replace("/", "_") + "_context.json"),
                title=opts.title, metadata=batch_meta)
            written += 1
        _err(f"{written} batch sample jsons written.")
    if opts.closest_relatives:
        # -V: tsv of each selected sample's equidistant closest relatives
        # (one, lexicographically smallest, with -q) + the distance
        # (extract.cpp:768-806)
        _err("Per-sample closest relative(s) requested. Computing...")
        if opts.break_ties:
            _err("Storing one closest relative per sample.")
        with open(out(opts.closest_relatives), "w") as f:
            for s in samples:
                rels, dist = sel.get_closest_samples(T, s, False, 0)
                if not rels:
                    continue
                chosen = min(rels) if opts.break_ties else ",".join(rels)
                f.write(f"{s}\t{chosen}\t{dist}\n")
    if opts.within_distance:
        # tsv of relatives within --distance-threshold mutations
        # (extract.cpp:807-824); a sample with none prints bare
        _err(f"Computing per-sample relatives within "
             f"{opts.distance_threshold} mutations...")
        with open(out(opts.within_distance), "w") as f:
            for s in samples:
                rels, _ = sel.get_closest_samples(
                    T, s, True, opts.distance_threshold)
                f.write((f"{s}\t" + ",".join(rels)).rstrip("\t") + "\n")
    if opts.used_samples:
        with open(out(opts.used_samples), "w") as f:
            for s in final_samples:
                f.write(s + "\n")
    if opts.sample_paths:
        with open(out(opts.sample_paths), "w") as f:
            for line in describe.mutation_paths(subtree, final_samples):
                f.write(line + "\n")
    if opts.clade_paths:
        with open(out(opts.clade_paths), "w") as f:
            for line in describe.clade_paths(subtree):
                f.write(line + "\n")
    if opts.all_paths:
        with open(out(opts.all_paths), "w") as f:
            for line in describe.all_paths(subtree):
                f.write(line + "\n")
    if opts.write_vcf:
        _err(f"Generating VCF of final tree at {out(opts.write_vcf)}")
        conv.make_vcf(subtree, out(opts.write_vcf), opts.no_genotypes)
    if opts.write_diff:
        _err(f"Generating MAPLE diff of final tree at {out(opts.write_diff)}")
        conv.make_diff(subtree, out(opts.write_diff))
    if opts.minimum_subtrees_size > 0:
        # -N uses and overrides -j/-t as output prefixes
        # (reference extract.cpp:93-94, convert.cpp:665-798)
        metadata = {}
        if opts.metadata:
            for mpath in opts.metadata.split(","):
                for s, kv in conv.read_metafile(
                        mpath, samples_to_use=set(samples),
                        load_all=opts.load_all_metadata).items():
                    metadata.setdefault(s, {}).update(kv)
        conv.get_minimum_subtrees(
            subtree, samples, opts.minimum_subtrees_size, opts.outdir,
            metadata=metadata,
            json_prefix=os.path.splitext(opts.write_json)[0]
            if opts.write_json else "",
            newick_prefix=os.path.splitext(opts.write_tree)[0]
            if opts.write_tree else "",
            retain_original_branch_len=opts.retain_branch_length)
    elif opts.write_json:
        metadata = {}
        if opts.metadata:
            for mpath in opts.metadata.split(","):
                metadata.update(conv.read_metafile(
                    mpath, samples_to_use=set(samples),
                    load_all=opts.load_all_metadata))
        conv.write_json_from_mat(subtree, out(opts.write_json),
                                 title=opts.title, metadata=metadata)
    if opts.write_tree and not opts.minimum_subtrees_size:
        _err(f"Writing final tree to {out(opts.write_tree)}")
        with open(out(opts.write_tree), "w") as f:
            f.write(write_newick(
                subtree, print_internal=True, print_branch_len=True,
                retain_original_branch_len=opts.retain_branch_length) + "\n")
    if opts.write_taxodium:
        from .translate import save_taxodium_tree
        _err(f"Writing taxodium protobuf to {out(opts.write_taxodium)}")
        save_taxodium_tree(
            subtree, out(opts.write_taxodium),
            [m for m in opts.metadata.split(",") if m],
            opts.input_gtf, opts.input_fasta, title=opts.title,
            description=opts.description,
            additional_meta_fields=[f for f in opts.extra_fields.split(",")
                                    if f],
            x_scale=opts.x_scale, include_nt=opts.include_nt)
    if opts.write_mat:
        _err(f"Saving output MAT file to {out(opts.write_mat)}")
        subtree.condense_leaves()
        save_mat_pb(subtree, out(opts.write_mat))
    if opts.dump_metadata:
        # -Q: all stored metadata for the selected samples, one row per
        # sample, columns sorted by name, "missing" for absent values
        # (extract.cpp:913-944; the reference writes the header in hash
        # order but aligns row values to name-sorted columns — we sort
        # both, which is the only self-consistent reading)
        _err("Dumping final metadata.")
        catmeta: dict[str, dict[str, str]] = {}
        if opts.metadata:
            for mpath in opts.metadata.split(","):
                for s, kv in conv.read_metafile(
                        mpath, samples_to_use=set(samples),
                        load_all=opts.load_all_metadata).items():
                    for col, val in kv.items():
                        catmeta.setdefault(col, {})[s] = val
        cols = sorted(catmeta)
        with open(out(opts.dump_metadata), "w") as f:
            f.write("strain" + "".join("\t" + c for c in cols))
            for s in samples:
                f.write("\n" + s)
                for c in cols:
                    f.write("\t" + catmeta[c].get(s, "missing"))
            f.write("\n")
    return 0
