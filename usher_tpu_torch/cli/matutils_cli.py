"""matUtils CLI of the port: query/manipulate/convert mutation-annotated
trees, with the device work on the device that USHER_TPU_PLATFORM names
(cuda by default).

Counterpart of usher_tpu/cli/matutils_cli.py with the same flags, messages
and exit codes; the subcommand surface mirrors the reference matUtils
(src/matUtils/main.cpp:13-22: extract, summary, annotate, uncertainty,
merge, mask, fix, introduce).  The device modes score through B1
(placement/driver.PlacementEngine: uncertainty, annotate, merge, extract
-e) or, under --pb-direct, the interval engines of core/bigmat.py (X6 and
X5 for uncertainty, X5 through placement/direct.DirectPlacer for merge).
"""

from __future__ import annotations

import argparse
import os
import sys

from ..io.pbio import load_mat_pb, save_mat_pb


def _err(*a):
    print(*a, file=sys.stderr)


def _load(path: str):
    T = load_mat_pb(path)
    if T.root is None:
        raise ValueError("ERROR: empty tree")
    return T


def cmd_extract(argv) -> int:
    from ..matutils.extract import ExtractOptions, extract_main
    p = argparse.ArgumentParser(prog="matUtils extract")
    p.add_argument("--input-mat", "-i", required=True)
    p.add_argument("--samples", "-s", default="", dest="samples_file")
    p.add_argument("--clade", "-c", default="")
    p.add_argument("--mutation", "-m", default="")
    p.add_argument("--match", "-H", default="")
    p.add_argument("--max-epps", "-e", type=int, default=0)
    p.add_argument("--max-parsimony", "-a", type=int, default=-1)
    p.add_argument("--max-branch-length", "-b", type=int, default=-1)
    p.add_argument("--max-path-length", "-P", type=int, default=-1)
    p.add_argument("--max-mutation-density", type=float, default=0.0)
    p.add_argument("--nearest-k", "-k", default="")
    p.add_argument("--set-size", "-z", type=int, default=0)
    p.add_argument("--limit-to-lca", "-Z", action="store_true")
    p.add_argument("--get-internal-descendents", "-I", default="")
    p.add_argument("--from-mrca", "-U", action="store_true")
    p.add_argument("--get-representative", "-r", type=int, default=0)
    p.add_argument("--prune", "-p", action="store_true")
    p.add_argument("--resolve-polytomies", "-R", action="store_true")
    p.add_argument("--output-directory", "-d", default="./", dest="outdir")
    p.add_argument("--used-samples", "-u", default="")
    p.add_argument("--sample-paths", "-S", default="")
    p.add_argument("--clade-paths", "-C", default="")
    p.add_argument("--all-paths", "-A", default="")
    p.add_argument("--write-diff", default="")
    p.add_argument("--write-vcf", "-v", default="")
    p.add_argument("--no-genotypes", "-n", action="store_true")
    p.add_argument("--collapse-tree", "-O", action="store_true")
    p.add_argument("--write-mat", "-o", default="")
    p.add_argument("--write-json", "-j", default="")
    p.add_argument("--write-tree", "-t", default="")
    p.add_argument("--retain-branch-length", "-E", action="store_true")
    p.add_argument("--reroot", "-y", default="")
    p.add_argument("--write-reroot-reference", default="",
                   help="After rerooting, write --input-fasta with the new "
                        "root's allele changes applied")
    p.add_argument("--metadata", "-M", default="")
    p.add_argument("--title", "-B", default="mutation_annotated_tree")
    p.add_argument("--usher-single-subtree-size", "-X", type=int, default=0)
    p.add_argument("--usher-minimum-subtrees-size", "-x", type=int, default=0)
    p.add_argument("--minimum-subtrees-size", "-N", type=int, default=0,
                   help="Generate JSON/newick subtrees of this size covering "
                        "all queried samples; uses and overrides -j/-t")
    p.add_argument("--usher-clades-txt", action="store_true",
                   help="With usher-style subtrees, also write clades.txt")
    p.add_argument("--usher-anchor-samples", default="",
                   help="Add samples from file to usher-style subtree(s)")
    p.add_argument("--add-random", "-W", type=int, default=0,
                   help="Add exactly W random samples to the selection")
    p.add_argument("--select-nearest", "-Y", type=int, default=0,
                   help="Also select the Y nearest samples to each sample")
    p.add_argument("--closest-relatives", "-V", default="",
                   help="Write a tsv of the closest relative(s) in "
                        "mutations of each selected sample")
    p.add_argument("--break-ties", "-q", action="store_true",
                   help="Only output one (lexicographically smallest) "
                        "closest relative per sample (with -V)")
    p.add_argument("--within-distance", default="",
                   help="Write a tsv of the relatives within "
                        "--distance-threshold mutations of each sample")
    p.add_argument("--distance-threshold", type=int, default=0)
    p.add_argument("--dump-metadata", "-Q", default="",
                   help="Write all final stored metadata to a tsv")
    p.add_argument("--whitelist", "-L", default="",
                   help="Samples (one per line) always retained regardless "
                        "of other selection parameters")
    p.add_argument("--load-all-metadata", action="store_true",
                   help="Load all input metadata from -M regardless of "
                        "sample selection")
    p.add_argument("--nearest-k-batch", "-K", default="",
                   help="sample_file.txt:k — write a context json of each "
                        "listed sample's k nearest neighbours")
    p.add_argument("--write-taxodium", "-l", default="")
    p.add_argument("--input-gtf", "-g", default="")
    p.add_argument("--input-fasta", "-f", default="")
    p.add_argument("--description", "-D", default="")
    p.add_argument("--extra-fields", "-F", default="")
    p.add_argument("--x-scale", "-G", type=float, default=0.2)
    p.add_argument("--include-nt", "-J", action="store_true")
    p.add_argument("--pb-direct", action="store_true",
                   help="select (-s/-c/-m/-e/-a/-b/-P/-H/-I/-U/-k/-Y/"
                        "-z/-W/-Z/--max-mutation-density) and build the "
                        "induced subtree straight off the flat arrays — "
                        "the full host tree is never materialized "
                        "(pandemic-scale MATs); all writers then run on "
                        "the subtree.  Tree path only: -p/-y/-X/-x/-N")
    a = p.parse_args(argv)
    if a.pb_direct:
        unsupported = [f for f, v in [
            ("-p", a.prune), ("-y", a.reroot),
            ("-X/-x", a.usher_single_subtree_size
             or a.usher_minimum_subtrees_size),
            ("-N", a.minimum_subtrees_size),
            # relationship queries walk the FULL tree, which pb-direct
            # never materializes
            ("-V/--within-distance/-K", a.closest_relatives
             or a.within_distance or a.nearest_k_batch),
        ] if v]
        if unsupported:
            _err(f"ERROR: --pb-direct extract does not support "
                 f"{', '.join(unsupported)} (use the tree path)")
            return 1
        have_selection = (a.samples_file or a.clade or a.mutation
                          or a.max_epps or a.max_parsimony >= 0
                          or a.max_branch_length >= 0
                          or a.max_path_length >= 0 or a.match
                          or a.get_internal_descendents or a.nearest_k
                          or a.set_size or a.add_random or a.whitelist)
        if not have_selection and (a.write_taxodium or a.write_vcf
                                   or a.write_diff or a.write_json):
            # whole-MAT exports straight off the arrays — the
            # pandemic-scale paths the reference runs on the full public
            # MAT (translate.cpp:330-496 taxodium; convert.cpp:294 VCF,
            # :325 MAPLE diff)
            from ..io.pb_arrays import load_mat_arrays
            ma = load_mat_arrays(a.input_mat)
            os.makedirs(a.outdir, exist_ok=True)
            if a.write_vcf:
                from ..matutils.convert_arrays import make_vcf_arrays
                out = os.path.join(a.outdir, a.write_vcf)
                _err(f"Generating VCF of full MAT at {out}")
                make_vcf_arrays(ma, out, no_genotypes=a.no_genotypes)
            if a.write_diff:
                from ..matutils.convert_arrays import make_diff_arrays
                out = os.path.join(a.outdir, a.write_diff)
                _err(f"Generating MAPLE diff of full MAT at {out}")
                make_diff_arrays(ma, out)
            if a.write_json:
                from ..matutils.convert import read_metafile
                from ..matutils.convert_arrays import (
                    _expanded_lists, write_json_from_mat_arrays)
                names, _p, children, _m = _expanded_lists(ma)
                leaves = {names[i] for i, c in enumerate(children)
                          if not c}
                metadata = {}
                for mpath in [m for m in a.metadata.split(",") if m]:
                    metadata.update(read_metafile(
                        mpath, samples_to_use=leaves,
                        load_all=a.load_all_metadata))
                out = os.path.join(a.outdir, a.write_json)
                _err(f"Writing JSON of full MAT to {out}")
                write_json_from_mat_arrays(ma, out, title=a.title,
                                           metadata=metadata)
            if a.write_taxodium:
                from ..matutils.translate_arrays import \
                    save_taxodium_arrays
                out = os.path.join(a.outdir, a.write_taxodium)
                _err(f"Writing taxodium protobuf to {out}")
                save_taxodium_arrays(
                    ma, out, [m for m in a.metadata.split(",") if m],
                    a.input_gtf, a.input_fasta, title=a.title,
                    description=a.description,
                    additional_meta_fields=[f for f in
                                            a.extra_fields.split(",")
                                            if f],
                    x_scale=a.x_scale, include_nt=a.include_nt)
            return 0
        if not have_selection:
            _err("ERROR: --pb-direct extract needs a selection "
                 "(-s/-c/-m/-e/-a/-b/-P/-H/-I/-k/-z/-W), or -v/"
                 "--write-diff/-l for whole-MAT exports; without one the "
                 "induced subtree is the whole MAT — use the tree path")
            return 1
        from ..io.pb_arrays import load_mat_arrays
        from ..matutils import arrays as marr
        ma = load_mat_arrays(a.input_mat)
        lists = marr._children_lists(ma)
        samples = marr.select_sample_indices(
            ma, lists, samples_file=a.samples_file, clade=a.clade,
            mutation=a.mutation, max_epps=a.max_epps,
            max_parsimony=a.max_parsimony,
            max_branch_length=a.max_branch_length,
            max_path_length=a.max_path_length,
            match=a.match,
            internal_descendents=a.get_internal_descendents,
            from_mrca=a.from_mrca,
            max_mutation_density=a.max_mutation_density,
            nearest_k=a.nearest_k, set_size=a.set_size,
            add_random=a.add_random, limit_to_lca=a.limit_to_lca,
            select_nearest=a.select_nearest)
        if a.whitelist:
            # -L joins after all other selection (extract.cpp:473-483)
            names, _nm, _mo, _par, children, _root = lists
            leaf_names = {names[i] for i, c in enumerate(children) if not c}
            have = set(samples)
            from ..matutils.select import read_sample_names
            for w in read_sample_names(a.whitelist):
                if w in have:
                    continue
                if w not in leaf_names:
                    _err(f"WARNING: whitelisted sample {w} not found in "
                         f"the tree; ignoring")
                    continue
                have.add(w)
                samples.append(w)
        if not samples:
            _err("ERROR: No samples fulfill selected criteria. Change "
                 "arguments and try again")
            return 1
        # filter_master's exact dispatch (tree_filter.py:123-130): the
        # compressed LCA subtree below 10k samples, prune semantics
        # (original structure, unary chains kept) at or above it, and the
        # unchanged tree when the selection covers every leaf
        names, _nm, _mo, _par, children, _root = lists
        total_leaves = sum(1 for c in children if not c)
        if len(samples) == total_leaves or len(samples) >= 10000:
            T = marr.verbatim_subtree(ma, samples, lists=lists)
        else:
            T = marr.extract_subtree(ma, samples, lists=lists)
        # the subtree IS the selection: clear every filter (re-applying
        # them would act on the COMPRESSED subtree, whose merged edges
        # inflate terminal branch lengths) and hand the small tree to
        # the standard writer pipeline
        a.samples_file = a.clade = a.mutation = a.whitelist = ""
        a.match = a.get_internal_descendents = a.nearest_k = ""
        a.max_epps = 0
        a.max_parsimony = a.max_branch_length = a.max_path_length = -1
        a.max_mutation_density = 0.0
        a.set_size = a.add_random = a.select_nearest = 0
        a.limit_to_lca = a.from_mrca = False
    else:
        T = _load(a.input_mat)
    opts = ExtractOptions(
        input_mat=a.input_mat, samples_file=a.samples_file, clade=a.clade,
        mutation=a.mutation, match=a.match, max_epps=a.max_epps,
        max_parsimony=a.max_parsimony, max_branch_length=a.max_branch_length,
        max_path_length=a.max_path_length,
        max_mutation_density=a.max_mutation_density, nearest_k=a.nearest_k,
        set_size=a.set_size, limit_to_lca=a.limit_to_lca,
        get_internal_descendents=a.get_internal_descendents,
        from_mrca=a.from_mrca, get_representative=a.get_representative,
        prune=a.prune, resolve_polytomies=a.resolve_polytomies,
        outdir=a.outdir, used_samples=a.used_samples,
        sample_paths=a.sample_paths, clade_paths=a.clade_paths,
        all_paths=a.all_paths, write_diff=a.write_diff,
        write_vcf=a.write_vcf, no_genotypes=a.no_genotypes,
        collapse_tree=a.collapse_tree, write_mat=a.write_mat,
        write_json=a.write_json, write_tree=a.write_tree,
        retain_branch_length=a.retain_branch_length, reroot=a.reroot,
        write_reroot_reference=a.write_reroot_reference,
        metadata=a.metadata, title=a.title,
        usher_single_subtree_size=a.usher_single_subtree_size,
        usher_minimum_subtrees_size=a.usher_minimum_subtrees_size,
        minimum_subtrees_size=a.minimum_subtrees_size,
        usher_clades_txt=a.usher_clades_txt,
        usher_anchor_samples=a.usher_anchor_samples,
        add_random=a.add_random,
        select_nearest=a.select_nearest,
        closest_relatives=a.closest_relatives, break_ties=a.break_ties,
        within_distance=a.within_distance,
        distance_threshold=a.distance_threshold,
        dump_metadata=a.dump_metadata, whitelist=a.whitelist,
        load_all_metadata=a.load_all_metadata,
        nearest_k_batch=a.nearest_k_batch,
        write_taxodium=a.write_taxodium, input_gtf=a.input_gtf,
        input_fasta=a.input_fasta, description=a.description,
        extra_fields=a.extra_fields, x_scale=a.x_scale,
        include_nt=a.include_nt)
    return extract_main(T, opts)


def cmd_summary(argv) -> int:
    from ..matutils import summary as summ
    p = argparse.ArgumentParser(prog="matUtils summary")
    p.add_argument("--input-mat", "-i", required=True)
    p.add_argument("--samples", "-s", default="")
    p.add_argument("--clades", "-c", default="")
    p.add_argument("--mutations", "-m", default="")
    p.add_argument("--haplotype", "--haplotypes", "-H", dest="haplotypes",
                   default="")
    p.add_argument("--sample-clades", "-C", default="")
    p.add_argument("--aberrant", "-a", default="")
    p.add_argument("--get-all-basic", "--get-all", "-A", dest="get_all",
                   action="store_true")
    p.add_argument("--mutation-stats", "-M", action="store_true",
                   help="print counts of different kinds of mutations")
    p.add_argument("--output-directory", "-d", default="./")
    p.add_argument("--translate", "-t", default="",
                   help="aa+nt mutations per node (needs -g and -f)")
    p.add_argument("--input-gtf", "-g", default="")
    p.add_argument("--input-fasta", "-f", default="")
    p.add_argument("--node-stats", "-N", default="")
    p.add_argument("--calculate-roho", "-R", default="")
    p.add_argument("--expanded-roho", "-E", action="store_true")
    p.add_argument("--metadata", default="",
                   help="sample metadata TSV with date column (expanded RoHo)")
    p.add_argument("--pb-direct", action="store_true",
                   help="answer from flat arrays without building a host "
                        "tree (pandemic-scale MATs; supports the default "
                        "summary, -s, -c, -m, -M)")
    a = p.parse_args(argv)
    if a.pb_direct:
        unsupported = [f for f, v in [
            ("-H", a.haplotypes), ("-C", a.sample_clades),
            ("-a", a.aberrant),
            ("-N", a.node_stats), ("-R", a.calculate_roho),
            ("-A", a.get_all),
        ] if v]
        if unsupported:
            _err(f"ERROR: --pb-direct summary does not support "
                 f"{', '.join(unsupported)} (use the tree path)")
            return 1
        from ..io.pb_arrays import load_mat_arrays
        from ..matutils import arrays as arr
        ma = load_mat_arrays(a.input_mat)
        os.makedirs(a.output_directory, exist_ok=True)

        def outp(p_):
            return os.path.join(a.output_directory, p_)

        did = False
        if a.samples:
            arr.write_sample_table(ma, outp(a.samples))
            did = True
        if a.clades:
            arr.write_clade_table(ma, outp(a.clades))
            did = True
        if a.mutations:
            arr.write_mutation_table(ma, outp(a.mutations))
            did = True
        if a.mutation_stats:
            arr.print_mutation_type_counts(ma)
            did = True
        if a.translate:
            if not (a.input_gtf and a.input_fasta):
                _err("ERROR: --translate requires --input-gtf and "
                     "--input-fasta")
                return 1
            from ..matutils.translate_arrays import translate_arrays
            translate_arrays(ma, outp(a.translate), a.input_gtf,
                             a.input_fasta)
            did = True
        if not did:
            arr.print_summary(ma)
        return 0
    T = _load(a.input_mat)
    T.uncondense_leaves()
    os.makedirs(a.output_directory, exist_ok=True)

    def out(p_):
        return os.path.join(a.output_directory, p_)

    did = False
    if a.get_all:
        a.samples = a.samples or "samples.tsv"
        a.clades = a.clades or "clades.tsv"
        a.mutations = a.mutations or "mutations.tsv"
        a.aberrant = a.aberrant or "aberrant.tsv"
    if a.samples:
        summ.write_sample_table(T, out(a.samples))
        did = True
    if a.clades:
        summ.write_clade_table(T, out(a.clades))
        did = True
    if a.mutations:
        summ.write_mutation_table(T, out(a.mutations))
        did = True
    if a.haplotypes:
        summ.write_haplotype_table(T, out(a.haplotypes))
        did = True
    if a.sample_clades:
        summ.write_sample_clades_table(T, out(a.sample_clades))
        did = True
    if a.aberrant:
        summ.write_aberrant_table(T, out(a.aberrant))
        did = True
    if a.translate:
        if not (a.input_gtf and a.input_fasta):
            _err("ERROR: --translate requires --input-gtf and --input-fasta")
            return 1
        from ..matutils.translate import translate_main
        translate_main(T, out(a.translate), a.input_gtf, a.input_fasta)
        did = True
    if a.node_stats:
        summ.write_node_stats(T, out(a.node_stats))
        did = True
    if a.mutation_stats:
        summ.print_mutation_type_counts(T)
        did = True
    if a.calculate_roho:
        date_meta = {}
        if a.expanded_roho and a.metadata:
            import csv
            with open(a.metadata) as mf:
                delim = "," if a.metadata.endswith(".csv") else "\t"
                rdr = csv.DictReader(mf, delimiter=delim)
                for row in rdr:
                    key = row.get("strain") or row.get("sample") or ""
                    if key:
                        date_meta[key] = row.get("date", "")
        summ.write_roho_table(T, out(a.calculate_roho),
                              get_dates=a.expanded_roho,
                              date_metadata=date_meta)
        did = True
    if not did:
        summ.print_summary(T)
    return 0


def cmd_annotate(argv) -> int:
    from ..matutils import annotate as ann
    p = argparse.ArgumentParser(prog="matUtils annotate")
    p.add_argument("--input-mat", "-i", required=True)
    p.add_argument("--output-mat", "-o", required=True)
    p.add_argument("--clade-names", "-c", default="")
    p.add_argument("--clade-to-nid", "-C", default="")
    p.add_argument("--clade-paths", "-P", default="")
    p.add_argument("--clade-mutations", "-M", default="",
                   help="clade\\tmutation-path per line: assign clades "
                        "placed by their given defining mutations")
    p.add_argument("--allele-frequency", "-f", type=float, default=0.8)
    p.add_argument("--mask-frequency", "-m", type=float, default=0.2)
    p.add_argument("--set-overlap", "-s", type=float, default=0.6)
    p.add_argument("--clip-sample-frequency", "-p", type=float, default=0.1)
    p.add_argument("--clear-current", "-l", action="store_true")
    p.add_argument("--output-directory", "-d", default="./")
    p.add_argument("--write-mutations", "-u", default="")
    p.add_argument("--write-details", "-D", default="")
    p.add_argument("--pb-direct", action="store_true",
                   help="apply -C clade-to-node assignments straight over "
                        "the flat arrays (no host tree)")
    a = p.parse_args(argv)

    def outp(name):
        import os as _os
        return _os.path.join(a.output_directory, name) if name else ""

    if a.pb_direct:
        if not a.clade_to_nid or a.clade_names or a.clade_paths \
                or a.clade_mutations:
            _err("ERROR: --pb-direct annotate supports -C only "
                 "(use the tree path)")
            return 1
        from ..io.pb_arrays import load_mat_arrays, save_arrays_to_pb
        from ..matutils.arrays import annotate_by_nid
        ma = load_mat_arrays(a.input_mat)
        annotate_by_nid(ma, a.clade_to_nid, a.clear_current)
        save_arrays_to_pb(ma, a.output_mat)
        return 0
    T = _load(a.input_mat)
    if a.clade_to_nid:
        if a.clade_names or a.clade_paths:
            _err("ERROR: --clade-to-nid cannot be used with --clade-names "
                 "or --clade-paths")
            return 1
        ann.assign_lineages_by_nid(T, a.clade_to_nid, a.clear_current)
    elif a.clade_paths:
        ann.assign_lineages_from_paths(T, a.clade_paths, a.clear_current)
    elif a.clade_names or a.clade_mutations:
        ann.assign_lineages_by_samples(
            T, a.clade_names, min_freq=a.allele_frequency,
            mask_freq=a.mask_frequency,
            set_overlap=a.set_overlap,
            clip_sample_frequency=a.clip_sample_frequency,
            clear_current=a.clear_current,
            mutations_out=outp(a.write_mutations),
            clade_mutations_file=a.clade_mutations,
            details_out=outp(a.write_details))
    else:
        _err("ERROR: annotate requires one of -c, -C, -P, -M")
        return 1
    save_mat_pb(T, a.output_mat)
    return 0


def cmd_uncertainty(argv) -> int:
    from ..matutils.uncertainty import uncertainty_main
    p = argparse.ArgumentParser(prog="matUtils uncertainty")
    p.add_argument("--input-mat", "-i", required=True)
    p.add_argument("--samples", "-s", default="")
    p.add_argument("--find-epps", "-e", default="")
    p.add_argument("--record-placements", "-o", default="")
    p.add_argument("--dropout-mutations", "-d", default="",
                   help="Calculate mutations possibly associated with "
                        "primer dropout [EXPERIMENTAL]")
    p.add_argument("--pb-direct", action="store_true",
                   help="compute EPPs/neighborhoods straight over the "
                        "flat arrays (no host tree; supports -s/-e/-o)")
    a = p.parse_args(argv)
    if not a.samples and not a.dropout_mutations:
        _err("ERROR: uncertainty requires -s and/or -d")
        return 1
    if a.pb_direct:
        if a.dropout_mutations:
            _err("ERROR: --pb-direct uncertainty does not support -d "
                 "(use the tree path)")
            return 1
        from ..io.pb_arrays import load_mat_arrays
        from ..matutils.arrays import uncertainty_main as arr_unc
        ma = load_mat_arrays(a.input_mat)
        return arr_unc(ma, a.samples, epps_out=a.find_epps,
                       locs_out=a.record_placements)
    T = _load(a.input_mat)
    T.uncondense_leaves()
    if a.dropout_mutations:
        from ..matutils.uncertainty import check_for_droppers
        _err("Identifying primer-dropout associated mutations.")
        check_for_droppers(T, a.dropout_mutations)
    if a.samples:
        return uncertainty_main(T, a.samples, a.find_epps,
                                a.record_placements)
    return 0


def cmd_merge(argv) -> int:
    from ..matutils.merge import merge_mats
    p = argparse.ArgumentParser(prog="matUtils merge")
    p.add_argument("--input-mat-1", "-1", required=True, dest="mat1")
    p.add_argument("--input-mat-2", "-2", required=True, dest="mat2")
    p.add_argument("--output-mat", "-o", required=True)
    p.add_argument("--max-depth", "-d", type=int, default=20,
                   help="Max depth to consider in the subtree rooted at "
                        "the consistent node (merge.cpp:16)")
    p.add_argument("--threads", "-T", type=int, default=0,
                   help="Accepted for CLI parity")
    p.add_argument("--pb-direct", action="store_true",
                   help="merge off flat arrays without building host "
                        "trees (pandemic-scale base MATs)")
    a = p.parse_args(argv)
    if a.pb_direct:
        from ..matutils.merge_arrays import merge_main_arrays
        return merge_main_arrays(a.mat1, a.mat2, a.output_mat,
                                 max_depth=a.max_depth)
    T1 = _load(a.mat1)
    T2 = _load(a.mat2)
    # the reference clears existing clade annotations on load
    # (merge.cpp:142-153)
    for T in (T1, T2):
        for n in T.depth_first_expansion():
            n.clade_annotations = []
    # the reference picks the larger tree as the base
    if len(T2.get_leaves_ids()) > len(T1.get_leaves_ids()):
        T1, T2 = T2, T1
    merged = merge_mats(T1, T2, max_depth=a.max_depth)
    merged.condense_leaves()
    save_mat_pb(merged, a.output_mat)
    return 0


def cmd_mask(argv) -> int:
    from ..matutils import mask as mk
    p = argparse.ArgumentParser(prog="matUtils mask")
    p.add_argument("--input-mat", "-i", required=True)
    p.add_argument("--output-mat", "-o", required=True)
    p.add_argument("--restricted-samples", "-s", default="")
    p.add_argument("--rename-samples", "-r", default="")
    p.add_argument("--mask-mutations", "-m", default="")
    p.add_argument("--simplify", "-S", action="store_true")
    p.add_argument("--move-nodes", "-M", default="")
    p.add_argument("--condense-tree", "-c", action="store_true",
                   help="Condense identical leaves before saving")
    p.add_argument("--max-snp-distance", "-D", type=int, default=0,
                   help="Locally mask mutations overlapping nearby samples' "
                        "missing data (needs -f); reference mask.cpp:35-36")
    p.add_argument("--maple-file", "-f", default="",
                   help="MAPLE diff file with per-sample missing intervals "
                        "for -D")
    p.add_argument("--pb-direct", action="store_true",
                   help="rename samples straight over the flat arrays "
                        "(no host tree; supports -r only)")
    a = p.parse_args(argv)
    if a.max_snp_distance > 0 and not a.maple_file:
        _err("ERROR: -D/--max-snp-distance requires -f/--maple-file")
        return 1
    if a.pb_direct:
        unsupported = [f for f, v in [
            ("-s", a.restricted_samples), ("-m", a.mask_mutations),
            ("-S", a.simplify), ("-M", a.move_nodes),
            ("-c", a.condense_tree), ("-D", a.max_snp_distance),
        ] if v]
        if unsupported:
            _err(f"ERROR: --pb-direct mask does not support "
                 f"{', '.join(unsupported)} (use the tree path)")
            return 1
        if not a.rename_samples:
            _err("ERROR: --pb-direct mask needs -r/--rename-samples")
            return 1
        from ..io.pb_arrays import load_mat_arrays, save_arrays_to_pb
        from ..matutils.arrays import rename_samples as arr_rename
        ma = load_mat_arrays(a.input_mat)
        arr_rename(ma, a.rename_samples)
        save_arrays_to_pb(ma, a.output_mat)
        return 0
    T = _load(a.input_mat)
    if a.simplify:
        T.uncondense_leaves()
    if a.restricted_samples:
        mk.restrict_samples(T, a.restricted_samples)
    if a.rename_samples:
        mk.rename_samples(T, a.rename_samples)
    if a.mask_mutations:
        n = mk.mask_mutations(T, a.mask_mutations)
        _err(f"Masked {n} mutation instances")
    if a.max_snp_distance > 0:
        n = mk.local_mask(T, a.max_snp_distance, a.maple_file)
        _err(f"Locally masked {n} mutation instances")
    if a.simplify:
        mk.simplify_tree(T)
    if a.move_nodes:
        mk.move_nodes(T, a.move_nodes)
    if a.condense_tree:
        if T.condensed_nodes:
            T.uncondense_leaves()
        T.condense_leaves()
    save_mat_pb(T, a.output_mat)
    return 0


def cmd_fix(argv) -> int:
    from ..matutils.fix import fix_grandparent_reversions
    p = argparse.ArgumentParser(prog="matUtils fix")
    p.add_argument("--input-mat", "-i", required=True)
    p.add_argument("--output-mat", "-o", required=True)
    p.add_argument("--iterations", "-n", type=int, default=1)
    p.add_argument("--min-descendent-count", "-c", type=int, default=1)
    a = p.parse_args(argv)
    T = _load(a.input_mat)
    fix_grandparent_reversions(T, a.iterations, a.min_descendent_count)
    save_mat_pb(T, a.output_mat)
    return 0


def cmd_introduce(argv) -> int:
    from ..matutils.introduce import introduce_main
    p = argparse.ArgumentParser(prog="matUtils introduce")
    p.add_argument("--input-mat", "-i", required=True)
    p.add_argument("--population-samples", "-s", required=True,
                   help="sample names (optionally sample\\tregion) of the "
                        "population of interest")
    p.add_argument("--additional-info", "-a", action="store_true")
    p.add_argument("--clade-regions", "-c", default="")
    p.add_argument("--date-metadata", "-M", default="")
    p.add_argument("--full-output", "-o", default="")
    p.add_argument("--origin-confidence", "-C", type=float, default=0.5)
    p.add_argument("--evaluate-metadata", "-E", action="store_true")
    p.add_argument("--dump-assignments", "-D", default="")
    p.add_argument("--latest-date", "-l", default="1500/1/1")
    p.add_argument("--cluster-output", "-u", default="")
    p.add_argument("--earliest-date", "-L", default="1500/1/1")
    p.add_argument("--num-to-report", "-r", type=int, default=1)
    p.add_argument("--minimum-to-report", "-R", type=float, default=0.05)
    p.add_argument("--num-to-look", "-X", type=int, default=0)
    p.add_argument("--minimum-gap", "-G", type=int, default=0)
    p.add_argument("--threads", "-T", type=int, default=0)
    p.add_argument("--pb-direct", action="store_true",
                   help="run off flat arrays without building a host "
                        "tree (pandemic-scale MATs; full flag surface)")
    a = p.parse_args(argv)
    if a.pb_direct:
        from ..matutils.introduce_arrays import introduce_main_arrays
        introduce_main_arrays(
            a.input_mat, a.population_samples,
            additional_info=a.additional_info,
            clade_regions=a.clade_regions,
            date_metadata=a.date_metadata, full_output=a.full_output,
            origin_confidence=a.origin_confidence,
            evaluate_metadata=a.evaluate_metadata,
            dump_assignments=a.dump_assignments,
            latest_date=a.latest_date, cluster_output=a.cluster_output,
            earliest_date=a.earliest_date, num_to_report=a.num_to_report,
            minimum_to_report=a.minimum_to_report,
            num_to_look=a.num_to_look, minimum_gap=a.minimum_gap)
        return 0
    introduce_main(
        a.input_mat, a.population_samples,
        additional_info=a.additional_info, clade_regions=a.clade_regions,
        date_metadata=a.date_metadata, full_output=a.full_output,
        origin_confidence=a.origin_confidence,
        evaluate_metadata=a.evaluate_metadata,
        dump_assignments=a.dump_assignments, latest_date=a.latest_date,
        cluster_output=a.cluster_output, earliest_date=a.earliest_date,
        num_to_report=a.num_to_report,
        minimum_to_report=a.minimum_to_report, num_to_look=a.num_to_look,
        minimum_gap=a.minimum_gap)
    return 0


COMMANDS = {
    "extract": cmd_extract,
    "summary": cmd_summary,
    "annotate": cmd_annotate,
    "uncertainty": cmd_uncertainty,
    "merge": cmd_merge,
    "mask": cmd_mask,
    "fix": cmd_fix,
    "introduce": cmd_introduce,
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        _err("matUtils-torch: query/manipulate/convert mutation-annotated "
             "trees.\nSubcommands: " + " ".join(sorted(COMMANDS))
             + "\nUse 'matUtils <subcommand> --help' for details.")
        return 0 if argv else 1
    if argv[0] == "--version":
        print("matUtils-torch (v0.1.0)")
        return 0
    cmd = COMMANDS.get(argv[0])
    if cmd is None:
        _err(f"Invalid command: {argv[0]}. Choose from: "
             + " ".join(sorted(COMMANDS)))
        return 1
    try:
        return cmd(argv[1:])
    except (OSError, KeyError, ValueError) as e:
        _err(str(e))
        return 1


if __name__ == "__main__":
    sys.exit(main())
