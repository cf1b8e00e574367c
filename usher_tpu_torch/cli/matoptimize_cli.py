"""matOptimize CLI of the port: parsimony optimization of a MAT by SPR
moves, on the device that USHER_TPU_PLATFORM names (cuda by default).

Counterpart of usher_tpu/cli/matoptimize_cli.py with the same flags and
messages; the flag surface mirrors the reference matOptimize
(src/matOptimize/main.cpp:155-184).  --mesh-devices N > 1 shards the FS
positions and the SPR source batches over N shards (more shards than cards
share the cards; -1 is one shard per visible card); --distributed is a later
slice and raises.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from ..io.newick import parse_newick
from ..io.pbio import load_mat_pb, save_mat_pb
from ..optimize import OptimizeOptions, optimize_tree
from ..utils.device import apply_platform_env
from ..utils.instrument import maybe_begin_session_from_env


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="matOptimize-torch",
        description="Optimize a mutation-annotated tree by SPR moves "
                    "(re-placement scoring on PyTorch/CUDA).")
    p.add_argument("--load-mutation-annotated-tree", "-i", default="", dest="din",
                   help="Load MAT protobuf to optimize")
    p.add_argument("--tree", "-t", default="",
                   help="Load tree from newick (with --vcf)")
    p.add_argument("--vcf", "-v", default="",
                   help="VCF for state assignment when loading from newick")
    p.add_argument("--load-intermediate", "-a", default="", dest="resume",
                   help="Resume from a checkpoint MAT protobuf")
    p.add_argument("--save-mutation-annotated-tree", "-o", required=True,
                   dest="dout", help="Output optimized MAT protobuf")
    p.add_argument("--radius", "-r", type=int, default=-1,
                   help="SPR radius; <0 enables radius doubling (default)")
    p.add_argument("--min-improvement", "-m", type=float, default=0.0005)
    p.add_argument("--drift_iterations", "-d", type=int, default=0)
    p.add_argument("--max-iterations", "-N", type=int, default=1000)
    p.add_argument("--max-hours", "-M", type=float, default=0)
    p.add_argument("--minutes-between-save", "-s", type=float, default=0,
                   help="Checkpoint interval (minutes); 0 disables")
    p.add_argument("--save-profitable-src-log", "-S", default="", dest="src_log")
    p.add_argument("--node_proportion", "-z", type=float, default=1.0)
    p.add_argument("--node_seed", "-y", type=int, default=0)
    p.add_argument("--transposed-vcf-path", "-V", default="",
                   help="Auxiliary transposed VCF for ambiguous bases, used "
                        "in combination with usher protobuf (-i)")
    p.add_argument("--diff_file_path", "-D", default="",
                   help="Diff file from MAPLE, used with newick tree (-t)")
    p.add_argument("--reference", "-R", default="",
                   help="Reference fasta, use with diff file (-D)")
    p.add_argument("--epps_on_branch_len", "-E", default="",
                   help="Output a newick with the number of equally "
                        "parsimonious placements on the branch length field")
    p.add_argument("--drift_nwk_file", "-b", default="",
                   help="Newick filename stem for intermediate trees while "
                        "drifting")
    p.add_argument("--black_list_node_file", default="",
                   help="Nodes that won't be moved")
    p.add_argument("--do-not-write-intermediate-files", "-n",
                   action="store_true")
    p.add_argument("--no-reduce-back-mutations", action="store_true",
                   help="Skip the final (parsimony, back-mutation) "
                        "lexicographic state reassignment")
    p.add_argument("--threads", "-T", type=int, default=0,
                   help="Accepted for CLI parity; device parallelism is "
                        "managed by CUDA")
    p.add_argument("--spr-backend", choices=["dense", "big"],
                   default="dense",
                   help="Move-scoring path: dense [N,P] device states, or "
                        "the CSR BigMAT path for trees too large for them")
    p.add_argument("--stream-states", action="store_true",
                   help="Pandemic-scale mode: never hold [nodes x positions] "
                        "state matrices; each iteration re-runs the streamed "
                        "full Fitch-Sankoff (implies --spr-backend big)")
    p.add_argument("--distributed", action="store_true",
                   help="Multi-host optimization (not ported yet)")
    p.add_argument("--mesh-devices", type=int, default=-1,
                   help="Shard Fitch-Sankoff positions and SPR source "
                        "batches over N devices (-1 auto, 0/1 off); more "
                        "shards than cards share the cards")
    p.add_argument("--version", action="version",
                   version="matOptimize-torch (v0.1.0)")
    return p


def _visible_cards(device) -> int:
    """--mesh-devices -1: one shard per visible CUDA card (the JAX CLI
    counted its jax devices); no mesh on the CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = apply_platform_env()
    maybe_begin_session_from_env()
    if args.distributed or os.environ.get("USHER_TPU_DISTRIBUTED"):
        raise NotImplementedError("multi-host optimization is not ported "
                                  "yet (ROADMAP A11, multi-GPU)")

    try:
        if args.resume:
            print(f"Loading intermediate checkpoint {args.resume}",
                  file=sys.stderr)
            from ..io.detailed import (is_detailed_checkpoint,
                                       load_detailed_mutations)
            resume_changed: set = set()
            if is_detailed_checkpoint(args.resume):
                T, resume_changed = load_detailed_mutations(args.resume)
            else:
                T = load_mat_pb(args.resume)  # legacy plain-pb checkpoint
        elif args.din and args.transposed_vcf_path:
            # -i + -V: restore ambiguous bases from the transposed VCF
            # (reference main.cpp:346-358)
            from ..io.patch import patch_mat_from_transposed_vcf
            T = load_mat_pb(args.din)
            T.uncondense_leaves()
            patch_mat_from_transposed_vcf(T, args.transposed_vcf_path)
        elif args.diff_file_path:
            # -t + -D + -R: newick topology + MAPLE diff genotypes
            # (reference main.cpp:360-374)
            if not args.tree:
                print("expect newick file", file=sys.stderr)
                return 1
            if not args.reference:
                print("expect reference fasta file", file=sys.stderr)
                return 1
            from ..io.patch import assign_states_from_diff
            T = parse_newick(args.tree)
            assign_states_from_diff(T, args.diff_file_path, args.reference)
        elif args.din:
            T = load_mat_pb(args.din)
        elif args.tree and args.vcf:
            T = parse_newick(args.tree)
            from ..io.vcf import read_vcf_sites
            from ..ops.sankoff import assign_states_from_vcf
            vcf = read_vcf_sites(args.vcf)
            assign_states_from_vcf(T, vcf, device)
        else:
            print("ERROR: provide -i MAT.pb, -a checkpoint.pb, "
                  "-t newick -v vcf, -i MAT.pb -V transposed.vcf, or "
                  "-t newick -D diff -R ref.fa", file=sys.stderr)
            return 1
    except OSError as e:
        print(f"ERROR: cannot read input: {e}", file=sys.stderr)
        return 1
    if T.root is None:
        print("ERROR: empty tree", file=sys.stderr)
        return 1

    if args.epps_on_branch_len:
        # -E: EPP-annotated newick instead of optimization
        # (reference main.cpp:438-504)
        from ..io.newick import write_newick
        from ..optimize.epp import count_epps
        # the tie lists go beside the -E newick
        dump_dir = os.path.dirname(args.epps_on_branch_len)
        count_epps(T, args.radius,
                   dump_path=os.path.join(dump_dir, "epps_dump")
                   if dump_dir else "epps_dump", device=device)
        with open(args.epps_on_branch_len, "w") as f:
            f.write(write_newick(T, print_internal=True,
                                 print_branch_len=True,
                                 uncondense_leaves=True,
                                 use_stored_branch_len=True))
        return 0

    # the reference checks output writability up front (main.cpp:256-262)
    try:
        with open(args.dout, "wb"):
            pass
    except OSError as e:
        print(f"ERROR: cannot write output file {args.dout}: {e}",
              file=sys.stderr)
        return 1

    checkpoint = "" if args.do_not_write_intermediate_files else (
        args.dout + ".intermediate" if args.minutes_between_save > 0 else "")
    from ..optimize.driver import install_signal_handlers
    try:
        install_signal_handlers()
        pid = __import__("os").getpid()
        print(f"Run kill -s SIGUSR1 {pid} to flush the source node log",
              file=sys.stderr)
        print(f"Run kill -s SIGUSR2 {pid} to apply all the move found "
              f"immediately, then output and exit.", file=sys.stderr)
    except (ValueError, OSError):
        pass  # non-main thread / unsupported platform

    blacklist = set()
    if args.black_list_node_file:
        with open(args.black_list_node_file) as f:
            blacklist = {l.strip() for l in f if l.strip()}

    opts = OptimizeOptions(
        radius=args.radius,
        min_improvement=args.min_improvement,
        drift_iterations=args.drift_iterations,
        max_iterations=args.max_iterations,
        max_hours=args.max_hours,
        checkpoint_path=checkpoint,
        checkpoint_minutes=args.minutes_between_save,
        profitable_src_log=args.src_log,
        node_proportion=args.node_proportion,
        seed=args.node_seed,
        reduce_back_mutations=not args.no_reduce_back_mutations,
        blacklist=blacklist,
        drift_nwk_stem=args.drift_nwk_file,
        initial_changed_ids=frozenset(
            resume_changed if args.resume else ()),
        spr_backend=args.spr_backend,
        stream_states=args.stream_states,
        mesh_devices=(_visible_cards(device) if args.mesh_devices < 0
                      else args.mesh_devices),
    )
    optimize_tree(T, opts, device)
    save_mat_pb(T, args.dout)
    print(f"Saved optimized tree to {args.dout}", file=sys.stderr)
    try:
        import resource
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        print(f"Maximum memory usage: {rss} kb", file=sys.stderr)
    except Exception:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
