"""usher-sampled CLI of the port: batched placement with interleaved
optimization, on the device that USHER_TPU_PLATFORM names (cuda by default).

Counterpart of usher_tpu/cli/usher_sampled_cli.py with the same flags,
messages and output files.  The flag surface mirrors the reference
usher-sampled (src/usher-sampled/driver/main.cpp:408-469): a superset of the
usher flags plus batching/optimization controls and MAPLE diff input.  The
MPI leader/follower distribution is replaced by the batch scorer (one
device call scores a whole batch against every node) with stale retry
(placement/sampled.py).  --mesh-devices -1 counts CUDA cards;
--distributed is a later slice and stops with an error.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from ..core.tree import Tree
from ..io.newick import parse_newick, write_newick
from ..io.pbio import load_mat_pb, save_mat_pb
from ..io.vcf import read_vcf
from ..placement.driver import PlacementEngine, write_mutation_paths
from ..placement.sampled import place_batch
from ..utils.device import apply_platform_env
from ..utils.instrument import maybe_begin_session_from_env, timeit


def _err(*a):
    print(*a, file=sys.stderr, flush=True)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="usher-sampled-torch",
        description="Batched maximum-parsimony placement with interleaved "
                    "SPR optimization.")
    p.add_argument("--vcf", "-v", default="")
    p.add_argument("--tree", "-t", default="")
    p.add_argument("--load-mutation-annotated-tree", "-i", default="",
                   dest="din")
    p.add_argument("--save-mutation-annotated-tree", "-o", default="",
                   dest="dout")
    p.add_argument("--outdir", "-d", default=".")
    p.add_argument("--diff", default="", help="MAPLE diff input")
    p.add_argument("--ref", default="", help="Reference fasta for --diff")
    p.add_argument("--sort-before-placement-1", "-s", action="store_true")
    p.add_argument("--sort-before-placement-2", "-S", action="store_true")
    p.add_argument("--sort-before-placement-3", "-A", action="store_true",
                   help="Sort new samples by number of ambiguous bases")
    p.add_argument("--reverse-sort", "-r", action="store_true")
    p.add_argument("--collapse-tree", "-c", action="store_true")
    p.add_argument("--max-uncertainty-per-sample", "-e", type=int,
                   default=1_000_000)
    p.add_argument("--max-parsimony-per-sample", "-E", type=int,
                   default=1_000_000)
    p.add_argument("--write-uncondensed-final-tree", "-u", action="store_true")
    p.add_argument("--write-subtrees-size", "-k", type=int, default=0)
    p.add_argument("--write-single-subtree", "-K", type=int, default=0)
    p.add_argument("--detailed-clades", "-D", action="store_true")
    p.add_argument("--no-ignore-prefix", default="", dest="duplicate_prefix",
                   help="prefix samples already in the tree to force "
                        "placement")
    p.add_argument("--multiple-placements", "-M", type=int, default=1,
                   help="Fork one tree per co-optimal placement up to this "
                        "many trees (driver/main.cpp:437; routed through "
                        "the serial multi-tree placer)")
    p.add_argument("--bigmat", action="store_true",
                   help="Use the CSR BigMAT engine (O(N+M) memory) for "
                        "trees too large for the dense path-state matrix")
    p.add_argument("--batch_size_per_process", type=int, default=5)
    p.add_argument("--parsimony_threshold", type=int, default=100_000)
    p.add_argument("--optimization_radius", type=int, default=4)
    p.add_argument("--optimization_minutes", type=float, default=5.0)
    p.add_argument("--last_optimization_minutes", type=float, default=0.0)
    p.add_argument("--first_n_samples", type=int, default=0)
    p.add_argument("--reduce-back-mutations", "-B", action="store_true")
    p.add_argument("--retain-input-branch-lengths", "-l", action="store_true")
    p.add_argument("--no-add", "-n", action="store_true")
    p.add_argument("--mesh-devices", type=int, default=-1,
                   help="Shard batch scoring + interleaved optimization "
                        "over N devices (-1 auto, 0 off) — the mesh "
                        "data-parallel replacement for the reference's "
                        "MPI follower protocol (place_sample.cpp:591)")
    p.add_argument("--threads", "-T", type=int, default=0,
                   help="Accepted for CLI parity; device parallelism is "
                        "managed by CUDA")
    p.add_argument("--distributed", action="store_true",
                   help="Multi-host placement (not ported yet)")
    p.add_argument("--version", action="version",
                   version="usher-sampled-torch (v0.1.0)")
    return p


def _optimize(T: Tree, radius: int, minutes: float,
              mesh_devices: int = 0, device=None) -> None:
    from ..optimize import OptimizeOptions, optimize_tree
    with timeit("sampled:optimize"):
        optimize_tree(T, OptimizeOptions(
            radius=radius, max_hours=minutes / 60.0 if minutes else 0.0,
            max_iterations=100, reduce_back_mutations=False,
            mesh_devices=mesh_devices), device)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = apply_platform_env()
    maybe_begin_session_from_env()
    if args.distributed or os.environ.get("USHER_TPU_DISTRIBUTED"):
        raise NotImplementedError("multi-host placement is not ported yet "
                                  "(ROADMAP A11, multi-GPU)")
    t0 = time.time()

    if args.din:
        _err(f"Loading existing mutation-annotated tree object from file "
             f"{args.din}")
        with timeit("cli:load_pb"):
            T = load_mat_pb(args.din)
        from_newick = False
    elif args.tree:
        T = parse_newick(args.tree)
        from_newick = True
    else:
        _err("ERROR: provide -i MAT.pb or -t newick")
        return 1
    if T.root is None:
        _err("ERROR: Empty tree.")
        return 1

    vcf = None
    if args.diff:
        if not args.ref:
            _err("ERROR: --diff requires --ref fasta")
            return 1
        from ..io.diff import load_reference_fasta, load_diff
        refs, chrom = load_reference_fasta(args.ref)
        missing_samples = load_diff(args.diff, refs, chrom,
                                    tree_node_ids=set(
                                        n for n in T._all_nodes))
    elif args.vcf:
        with timeit("cli:read_vcf"):
            missing_samples, vcf = read_vcf(
                T, args.vcf, create_new_mat=from_newick,
                duplicate_prefix=args.duplicate_prefix)
        if from_newick:
            _err("Computing parsimonious assignments for input variants.")
            from ..ops.sankoff import assign_states_from_vcf
            with timeit("cli:sankoff"):
                assign_states_from_vcf(T, vcf, device)
    else:
        _err("ERROR: provide -v VCF or --diff")
        return 1

    if args.collapse_tree:
        T.collapse_tree()
        T.condense_leaves()

    if args.first_n_samples > 0:
        missing_samples = missing_samples[:args.first_n_samples]
    _err(f"Found {len(missing_samples)} missing samples.")

    os.makedirs(args.outdir, exist_ok=True)
    outdir = os.path.realpath(args.outdir)

    if args.multiple_placements > 1:
        # -M: the multi-tree mode is inherently serial (one fork per
        # co-optimal placement, reference multiple_placement.cpp:8-86);
        # route through the classic multi-tree placer for identical outputs
        from ..placement.driver import UsherOptions, run_usher_multi
        opts = UsherOptions(
            dout_filename=args.dout, outdir=outdir,
            max_trees=args.multiple_placements,
            max_uncertainty=args.max_uncertainty_per_sample,
            max_parsimony=args.max_parsimony_per_sample,
            collapse_tree=args.collapse_tree,
            print_uncondensed_tree=args.write_uncondensed_final_tree,
            retain_original_branch_len=args.retain_input_branch_lengths,
            no_add=args.no_add,
            print_subtrees_size=args.write_subtrees_size,
            print_subtrees_single=args.write_single_subtree,
        )
        return run_usher_multi(T, missing_samples, opts, vcf, device)

    mesh = None
    want = args.mesh_devices
    if want == -1:
        nd = torch.cuda.device_count() if device.type == "cuda" else 1
        want = nd if nd > 1 else 0
    if want > 1:
        from ..parallel.mesh import make_mesh
        mesh = make_mesh(want, device=device)
        _err(f"Sharding placement over a {dict(mesh.shape)} device mesh.")

    extra = None
    if args.diff:
        extra = [m for s in missing_samples for m in s.mutations]
    if args.bigmat:
        from ..placement.big_engine import BigPlacementEngine
        engine = BigPlacementEngine(T, vcf, extra_mutations=extra,
                                    mesh=mesh, device=device)
    else:
        with timeit("placement:flat_build"):
            engine = PlacementEngine(T, vcf, extra_mutations=extra,
                                     device=device, mesh=mesh)
    if args.diff:
        # expand each diff sample's N ranges over the segregating positions
        from ..io.diff import materialize_missing
        pos_ref = {int(p): int(r) for p, r in
                   zip(engine.flat.positions, engine.flat.ref)}
        for s in missing_samples:
            s.mutations = materialize_missing(
                s, engine.flat.positions, pos_ref, engine.flat.chrom)

    if (args.sort_before_placement_1 or args.sort_before_placement_2) \
            and len(missing_samples) > 1:
        _err("Sorting missing samples using a dry placement run.")
        with timeit("sampled:sort_scores"):
            pres = engine.score_samples(
                [s.mutations for s in missing_samples])
        key1 = [(r.best_score, r.num_best) for r in pres]
        key2 = [(r.num_best, r.best_score) for r in pres]
        keys = key1 if args.sort_before_placement_1 else key2
        order = sorted(range(len(missing_samples)), key=lambda i: keys[i])
        if args.reverse_sort:
            order.reverse()
        missing_samples = [missing_samples[i] for i in order]
    elif args.sort_before_placement_3 and len(missing_samples) > 1:
        # sort by #ambiguous bases (driver/main.cpp sort_by_ambiguous_bases)
        order = sorted(range(len(missing_samples)),
                       key=lambda i: missing_samples[i].num_ambiguous)
        missing_samples = [missing_samples[i] for i in order]

    stats_path = os.path.join(outdir, "placement_stats.tsv")
    stats_f = open(stats_path, "w")

    num_annotations = T.get_num_annotations()

    def on_placed(s, res, detail):
        if detail is None:
            stats_f.write(f"{s.name}\t\t{res.num_best}\t\n")
            return
        _err(f"Sample name: {s.name}\tParsimony score: "
             f"{detail.set_difference}\tNumber of parsimony-optimal "
             f"placements: {res.num_best}")
        stats_f.write(f"{s.name}\t{detail.set_difference}\t{res.num_best}\t\n")
        if num_annotations > 0 and res.tied_nodes:
            # clade assignment over the tie set (usher_common.cpp:600-619)
            s.clade_assignments = []
            s.best_clade_assignment = [""] * num_annotations
            for c in range(num_annotations):
                assignments = []
                for node, hu in zip(res.tied_nodes, res.tied_has_unique):
                    include_self = (not node.is_leaf()) and (not hu)
                    clade = T.get_clade_assignment(node, c, include_self)
                    assignments.append(clade)
                    if node is res.best_node:
                        s.best_clade_assignment[c] = clade
                assignments.sort()
                s.clade_assignments.append(assignments)

    if not args.no_add:
        pending = list(missing_samples)
        pars_accum = 0
        while pending:
            batch = pending[:max(args.batch_size_per_process, 1) * 64]
            pending = pending[len(batch):]
            with timeit("sampled:place_batch"):
                stats = place_batch(
                    engine, batch,
                    batch_size=max(args.batch_size_per_process, 1) * 8,
                    max_uncertainty=args.max_uncertainty_per_sample,
                    max_parsimony=args.max_parsimony_per_sample,
                    on_placed=on_placed)
            pars_accum += stats.parsimony_increase
            if pars_accum > args.parsimony_threshold and pending:
                _err(f"Cumulative parsimony increase {pars_accum} exceeds "
                     f"threshold; optimizing (radius "
                     f"{args.optimization_radius}).")
                # drop the old engine's device arrays before the new build
                engine = None
                _optimize(T, args.optimization_radius,
                          args.optimization_minutes,
                          mesh_devices=want if want > 1 else 0,
                          device=device)
                if args.bigmat:
                    from ..placement.big_engine import BigPlacementEngine
                    engine = BigPlacementEngine(T, vcf, mesh=mesh,
                                                device=device)
                else:
                    engine = PlacementEngine(T, vcf, device=device,
                                             mesh=mesh)
                pars_accum = 0
    stats_f.close()

    if args.last_optimization_minutes > 0:
        _err("Final optimization round.")
        engine = None
        _optimize(T, args.optimization_radius,
                  args.last_optimization_minutes,
                  mesh_devices=want if want > 1 else 0, device=device)

    if args.reduce_back_mutations:
        from ..core.flat import collect_positions
        from ..optimize.fitch import FitchEngine
        positions, ref, chrom = collect_positions(T)
        engine = None
        with timeit("sampled:min_back"):
            fe = FitchEngine(T, positions, device=device)
            from ..optimize.leafstore import SparseLeafStore
            leaf_store, ref_row = SparseLeafStore.from_tree(T, positions)
            states, _ = fe.run(leaf_store, ref_row, min_back=True)
            fe.rewrite_mutations(states, leaf_store, ref_row, chrom)

    # outputs (same artifact set as usher)
    if args.write_uncondensed_final_tree:
        path = os.path.join(outdir, "uncondensed-final-tree.nh")
        _err(f"Writing uncondensed final tree to file {path}")
        with open(path, "w") as f:
            f.write(write_newick(T, print_internal=True, print_branch_len=True,
                                 uncondense_leaves=True))
    else:
        path = os.path.join(outdir, "final-tree.nh")
        _err(f"Writing final tree to file {path}")
        with open(path, "w") as f:
            f.write(write_newick(T, print_internal=True,
                                 print_branch_len=True))
    _err(f"The parsimony score for this tree is: {T.get_parsimony_score()}")

    if missing_samples:
        path = os.path.join(outdir, "mutation-paths.txt")
        write_mutation_paths(T, [s.name for s in missing_samples], path)

    if num_annotations > 0 and not args.no_add:
        # clades.txt incl. -D histogram (usher_common.cpp:583-619 format)
        path = os.path.join(outdir, "clades.txt")
        _err(f"Writing clade annotations to file {path}")
        with open(path, "w") as f:
            for s in missing_samples:
                if not s.best_clade_assignment:
                    continue
                f.write(f"{s.name}\t")
                cols = []
                for k in range(num_annotations):
                    col = s.best_clade_assignment[k]
                    if args.detailed_clades:
                        col += "*|"
                        hist = []
                        curr_clade, curr_count = "", 0
                        total = len(s.clade_assignments[k])
                        for clade in s.clade_assignments[k]:
                            if clade == curr_clade:
                                curr_count += 1
                            else:
                                if curr_count > 0:
                                    hist.append(
                                        f"{curr_clade}({curr_count}/{total})")
                                curr_clade, curr_count = clade, 1
                        if curr_count > 0:
                            hist.append(f"{curr_clade}({curr_count}/{total})")
                        col += ",".join(hist)
                    cols.append(col)
                f.write("\t".join(cols) + "\n")

    if args.write_single_subtree > 1 and missing_samples and not args.no_add:
        from ..tools.subtrees import write_single_subtree
        if T.condensed_nodes:
            T.uncondense_leaves()
        write_single_subtree(
            T, [s.name for s in missing_samples], outdir,
            args.write_single_subtree,
            retain_original_branch_len=args.retain_input_branch_lengths)
    if args.write_subtrees_size > 1 and missing_samples and not args.no_add:
        from ..tools.subtrees import write_sample_subtrees
        if T.condensed_nodes:
            T.uncondense_leaves()
        write_sample_subtrees(
            T, [s.name for s in missing_samples], outdir,
            args.write_subtrees_size,
            retain_original_branch_len=args.retain_input_branch_lengths)

    if args.dout:
        _err(f"Saving mutation-annotated tree object to file {args.dout}")
        if T.condensed_nodes:
            T.uncondense_leaves()
        T.condense_leaves()
        save_mat_pb(T, args.dout)

    _err(f"Completed in {int((time.time()-t0)*1000)} msec")
    return 0


if __name__ == "__main__":
    sys.exit(main())
