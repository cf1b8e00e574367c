"""usher-sampled socket server of the port: unix-socket placement daemon on
the device that USHER_TPU_PLATFORM names (cuda by default).  Counterpart of
usher_tpu/cli/usher_socket_server_cli.py.

Mirrors the reference ``usher-sampled-server``
(src/usher-sampled/driver/socket.cpp:100-661):

- a unix stream socket accepts requests: usher command-line arguments one per
  line, terminated by an empty line; the reply is the run's output text,
  terminated by ASCII EOT (0x04) + newline (socket.cpp help text :604-607).
- a manager fifo accepts commands (socket.cpp:137-186): ``stop``, ``reload``
  (followed by one tree path per line then a blank line), ``thread N``,
  ``timeout N``.
- trees named by ``-i`` must be in the pre-loaded collection
  (``--pb-to-load``); unknown paths get a "Tree ... not found" reply listing
  the loaded trees (socket.cpp:389-398).
- loaded protobufs are checked for on-disk staleness every ``reload_peroid``
  minutes and transparently re-loaded (tree_update_watch, socket.cpp:545-589).
- ``--existing_samples FILE`` requests extract context subtrees around
  existing samples from the uncondensed tree instead of placing new ones
  (socket.cpp:404-447).

Deviation from the reference: it forks one child per connection (each child
mutates a copy-on-write replica and is killed on timeout).  A CUDA context
does not survive a fork, so this server runs a single-process event loop
(selectors over socket + fifo) and handles requests sequentially against an
explicit ``Tree.copy()``: the same isolation the fork provided, without a
second device context.  Each placement builds its engine (FlatMAT) anew and
drops it when the request ends, so device memory does not grow across
requests.
"""

from __future__ import annotations

import argparse
import os
import selectors
import socket
import sys
import time

from ..core.tree import Tree
from ..io.pbio import load_mat_pb
from ..io.vcf import read_vcf


def _err(*a):
    print(*a, file=sys.stderr, flush=True)


EOT = b"\x04\n"


class TreeInfo:
    """A pre-loaded tree + its uncondensed twin (socket.cpp tree_info)."""

    def __init__(self, path: str):
        self.path = path
        self.tree = load_mat_pb(path)
        self.expanded_tree = self.tree.copy()
        self.expanded_tree.uncondense_leaves()
        self.condensed_nodes = {
            s for names in self.tree.condensed_nodes.values() for s in names}
        try:
            self.mtime = os.path.getmtime(os.path.realpath(path))
        except OSError:
            self.mtime = 0.0

    def is_stale(self) -> bool:
        try:
            return os.path.getmtime(os.path.realpath(self.path)) != self.mtime
        except OSError:
            return False


class TreeCollection:
    def __init__(self, paths: list[str]):
        self.trees: dict[str, TreeInfo] = {}
        self.reload(paths)

    def reload(self, paths: list[str]) -> None:
        _err("loading the tree")
        new = {}
        for path in paths:
            if path not in new:
                new[path] = TreeInfo(path)
        self.trees = new
        _err("finish loading the tree")

    def refresh_stale(self) -> None:
        for path, info in list(self.trees.items()):
            if info.is_stale():
                _err(f"reloading tree {path}")
                self.trees[path] = TreeInfo(path)
                _err(f"finished reloading tree {path}")


def build_request_parser() -> argparse.ArgumentParser:
    """Per-request flags (socket.cpp:273-360 get_options)."""
    p = argparse.ArgumentParser(prog="usher", add_help=False)
    p.add_argument("--vcf", "-v", default="")
    p.add_argument("--existing_samples", default="")
    p.add_argument("--anchor_samples", default="")
    p.add_argument("--outdir", "-d", default=".")
    p.add_argument("--mat-index", "-i", default="", dest="mat_index")
    p.add_argument("--save-mutation-annotated-tree", "-o", default="",
                   dest="dout")
    p.add_argument("--sort-before-placement-1", "-s", action="store_true")
    p.add_argument("--sort-before-placement-2", "-S", action="store_true")
    p.add_argument("--sort-before-placement-3", "-A", action="store_true")
    p.add_argument("--reverse-sort", "-r", action="store_true")
    p.add_argument("--collapse-tree", "-c", action="store_true")
    p.add_argument("--collapse-output-tree", "-C", action="store_true")
    p.add_argument("--max-uncertainty-per-sample", "-e", type=int,
                   default=1_000_000)
    p.add_argument("--max-parsimony-per-sample", "-E", type=int,
                   default=1_000_000)
    p.add_argument("--write-uncondensed-final-tree", "-u", action="store_true")
    p.add_argument("--write-subtrees-size", "-k", type=int, default=0)
    p.add_argument("--write-single-subtree", "-K", type=int, default=0)
    p.add_argument("--retain-input-branch-lengths", "-l", action="store_true")
    p.add_argument("--detailed-clades", "-D", action="store_true")
    p.add_argument("--no-ignore-prefix", default="", dest="duplicate_prefix")
    p.add_argument("--version", action="store_true")
    p.add_argument("--help", "-h", action="store_true", dest="want_help")
    return p


def read_sample_nodes(samples_file: str, T: Tree, reply: list[str]):
    """utils.cpp:622-638: resolve sample names, report missing ones."""
    nodes = []
    with open(samples_file) as f:
        for line in f:
            name = line.rstrip("\n")
            if not name:
                continue
            node = T.get_node(name)
            if node is None:
                reply.append(f"node {name} in file {samples_file} does not "
                             f"exist\n")
            else:
                nodes.append(node)
    return nodes


def handle_existing_samples(args, info: TreeInfo, reply: list[str]) -> None:
    """Subtree extraction around existing samples (socket.cpp:404-447)."""
    from ..tools.subtrees import write_sample_subtrees, write_single_subtree
    tree = info.expanded_tree
    nodes = read_sample_nodes(args.existing_samples, tree, reply)
    anchors = []
    if args.anchor_samples:
        anchors = read_sample_nodes(args.anchor_samples, tree, reply)
    sample_names = [n.identifier for n in nodes]
    anchor_names = [n.identifier for n in anchors]
    if args.detailed_clades:
        path = os.path.join(args.outdir, "clades.txt")
        num_ann = max((len(n.clade_annotations)
                       for n in tree.depth_first_expansion()), default=0)
        with open(path, "w") as f:
            for n in nodes:
                anns = list(n.clade_annotations) + [""] * num_ann
                f.write(n.identifier
                        + "".join("\t" + a for a in anns[:num_ann]) + "\n")
    if args.write_single_subtree > 1:
        _err(f"Computing the single subtree for added samples with "
             f"{args.write_single_subtree} random leaves. \n")
        write_single_subtree(
            tree, sample_names + anchor_names, args.outdir,
            args.write_single_subtree,
            retain_original_branch_len=args.retain_input_branch_lengths)
    if args.write_subtrees_size > 1:
        _err("Computing subtrees for added samples. \n")
        write_sample_subtrees(
            tree, sample_names + anchor_names, args.outdir,
            args.write_subtrees_size,
            retain_original_branch_len=args.retain_input_branch_lengths)


def handle_placement(args, info: TreeInfo, reply: list[str]) -> None:
    """Placement request against a copy of the pre-loaded tree
    (socket.cpp:448-507).  The fork's copy-on-write replica becomes an
    explicit Tree.copy()."""
    from ..io.newick import write_newick
    from ..io.pbio import save_mat_pb
    from ..placement.driver import PlacementEngine, write_mutation_paths
    from ..placement.sampled import place_batch

    T = info.tree.copy()
    missing_samples, vcf = read_vcf(T, args.vcf, create_new_mat=False,
                                    duplicate_prefix=args.duplicate_prefix)
    if not missing_samples:
        reply.append("Found no new samples\n")
        return
    engine = PlacementEngine(T, vcf)

    if (args.sort_before_placement_1 or args.sort_before_placement_2) \
            and len(missing_samples) > 1:
        pres = engine.score_samples([s.mutations for s in missing_samples])
        key1 = [(r.best_score, r.num_best) for r in pres]
        key2 = [(r.num_best, r.best_score) for r in pres]
        keys = key1 if args.sort_before_placement_1 else key2
        order = sorted(range(len(missing_samples)), key=lambda i: keys[i])
        if args.reverse_sort:
            order.reverse()
        missing_samples = [missing_samples[i] for i in order]
    elif args.sort_before_placement_3 and len(missing_samples) > 1:
        order = sorted(range(len(missing_samples)),
                       key=lambda i: missing_samples[i].num_ambiguous)
        missing_samples = [missing_samples[i] for i in order]

    stats_path = os.path.join(args.outdir, "placement_stats.tsv")
    stats_f = open(stats_path, "w")

    def on_placed(s, res, detail):
        if detail is None:
            stats_f.write(f"{s.name}\t\t{res.num_best}\t\n")
            return
        line = (f"Sample name: {s.name}\tParsimony score: "
                f"{detail.set_difference}\tNumber of parsimony-optimal "
                f"placements: {res.num_best}")
        _err(line)
        reply.append(line + "\n")
        stats_f.write(f"{s.name}\t{detail.set_difference}\t{res.num_best}\t\n")

    place_batch(engine, missing_samples,
                max_uncertainty=args.max_uncertainty_per_sample,
                max_parsimony=args.max_parsimony_per_sample,
                on_placed=on_placed)
    stats_f.close()

    if args.write_uncondensed_final_tree:
        path = os.path.join(args.outdir, "uncondensed-final-tree.nh")
        with open(path, "w") as f:
            f.write(write_newick(
                T, print_internal=True, print_branch_len=True,
                uncondense_leaves=True,
                retain_original_branch_len=args.retain_input_branch_lengths))
    else:
        path = os.path.join(args.outdir, "final-tree.nh")
        with open(path, "w") as f:
            f.write(write_newick(
                T, print_internal=True, print_branch_len=True,
                retain_original_branch_len=args.retain_input_branch_lengths))
    write_mutation_paths(T, [s.name for s in missing_samples],
                         os.path.join(args.outdir, "mutation-paths.txt"))
    sample_names = [s.name for s in missing_samples]
    if args.write_single_subtree > 1:
        from ..tools.subtrees import write_single_subtree
        write_single_subtree(
            T, sample_names, args.outdir, args.write_single_subtree,
            retain_original_branch_len=args.retain_input_branch_lengths)
    if args.write_subtrees_size > 1:
        from ..tools.subtrees import write_sample_subtrees
        write_sample_subtrees(
            T, sample_names, args.outdir, args.write_subtrees_size,
            retain_original_branch_len=args.retain_input_branch_lengths)
    if args.dout:
        if T.condensed_nodes:
            T.uncondense_leaves()
        T.condense_leaves()
        save_mat_pb(T, args.dout)
    reply.append("\n")


def handle_request(raw_args: list[str], trees: TreeCollection) -> bytes:
    """Run one request, returning the full reply (terminated with EOT)."""
    reply: list[str] = []
    parser = build_request_parser()
    try:
        args = parser.parse_args(raw_args)
    except SystemExit:
        return b"parsing failed\n" + EOT
    if args.version:
        return b"usher-sampled-torch (v0.1.0)\n" + EOT
    if args.want_help or not args.mat_index:
        return b"usher-sampled-server request requires -i MAT\n" + EOT

    info = trees.trees.get(args.mat_index)
    if info is None:
        lines = [f"Tree {args.mat_index} not found\n Have trees :\n"]
        lines += [p + "\n" for p in trees.trees]
        return "".join(lines).encode() + EOT

    os.makedirs(args.outdir, exist_ok=True)
    args.outdir = os.path.realpath(args.outdir)
    try:
        if args.existing_samples:
            handle_existing_samples(args, info, reply)
        else:
            if not args.vcf:
                return b"request requires -v VCF\n" + EOT
            handle_placement(args, info, reply)
    except Exception as e:  # reply with the error; keep the daemon alive
        _err(f"request failed: {e!r}")
        reply.append(f"request failed: {e!r}\n")
    return "".join(reply).encode() + EOT


def _read_request(conn: socket.socket, timeout: float) -> list[str] | None:
    """Read newline-separated args until an empty line (socket.cpp:256-271)."""
    conn.settimeout(timeout)
    buf = b""
    try:
        while b"\n\n" not in buf and not buf.startswith(b"\n"):
            chunk = conn.recv(4096)
            if not chunk:
                break
            buf += chunk
    except socket.timeout:
        return None
    text = buf.decode(errors="replace")
    args = []
    for line in text.split("\n"):
        if line == "":
            break
        args.append(line)
    return args


class SocketServer:
    def __init__(self, socket_path: str, fifo_path: str,
                 trees: TreeCollection, timeout_s: int = 180,
                 refresh_period_min: int = 1):
        self.socket_path = socket_path
        self.fifo_path = fifo_path
        self.trees = trees
        self.timeout_s = timeout_s
        self.refresh_period_min = refresh_period_min
        self.interrupted = False
        self._fifo_buf = b""

        if os.path.exists(socket_path):
            os.unlink(socket_path)
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.bind(socket_path)
        self.sock.listen(128)
        self.sock.setblocking(False)

        if os.path.exists(fifo_path):
            os.unlink(fifo_path)
        os.mkfifo(fifo_path, 0o700)
        # O_RDWR (not O_RDONLY): with no writer attached a read-only FIFO is
        # permanently readable-at-EOF, so select() would wake immediately
        # forever and the daemon would busy-spin.  Holding a write end
        # ourselves keeps reads returning EAGAIN until a real writer shows up.
        self.fifo_fd = os.open(fifo_path, os.O_RDWR | os.O_NONBLOCK)

        self.sel = selectors.DefaultSelector()
        self.sel.register(self.sock, selectors.EVENT_READ, "sock")
        self.sel.register(self.fifo_fd, selectors.EVENT_READ, "fifo")

    def _handle_fifo_lines(self) -> None:
        try:
            chunk = os.read(self.fifo_fd, 65536)
        except BlockingIOError:
            return
        self._fifo_buf += chunk
        while b"\n" in self._fifo_buf:
            line, self._fifo_buf = self._fifo_buf.split(b"\n", 1)
            cmd = line.decode().strip()
            if cmd == "stop":
                self.interrupted = True
                return
            elif cmd == "reload":
                paths = []
                # subsequent lines up to a blank line are tree paths
                deadline = time.time() + 5.0
                while time.time() < deadline:
                    if b"\n" in self._fifo_buf:
                        nxt, self._fifo_buf = self._fifo_buf.split(b"\n", 1)
                        if nxt == b"":
                            break
                        paths.append(nxt.decode())
                    else:
                        try:
                            more = os.read(self.fifo_fd, 65536)
                            if more:
                                self._fifo_buf += more
                            else:
                                time.sleep(0.01)
                        except BlockingIOError:
                            time.sleep(0.01)
                self.trees.reload(paths)
            elif cmd.startswith("thread "):
                _err(f"setting thread count to {cmd.split()[1]}")
            elif cmd.startswith("timeout "):
                try:
                    self.timeout_s = int(cmd.split()[1])
                    _err(f"setting new timeout to {self.timeout_s} seconds")
                except ValueError:
                    pass

    def _serve_connection(self) -> None:
        try:
            conn, _ = self.sock.accept()
        except (BlockingIOError, OSError):
            return
        with conn:
            raw_args = _read_request(conn, float(self.timeout_s))
            if raw_args is None:
                return
            _err(" ".join(raw_args))
            reply = handle_request(raw_args, self.trees)
            try:
                conn.sendall(reply)
            except OSError as e:
                _err(f"failed to send reply: {e}")
        _err("done")

    def serve_forever(self, max_requests: int = 0) -> None:
        handled = 0
        last_refresh = time.time()
        while not self.interrupted:
            events = self.sel.select(timeout=1.0)
            for key, _ in events:
                if key.data == "fifo":
                    self._handle_fifo_lines()
                elif key.data == "sock":
                    self._serve_connection()
                    handled += 1
            if max_requests and handled >= max_requests:
                break
            if time.time() - last_refresh > self.refresh_period_min * 60:
                self.trees.refresh_stale()
                last_refresh = time.time()
        self.close()

    def close(self) -> None:
        if self.fifo_fd is None:
            return
        self.sel.close()
        self.sock.close()
        os.close(self.fifo_fd)
        self.fifo_fd = None
        for p in (self.socket_path, self.fifo_path):
            try:
                os.unlink(p)
            except OSError:
                pass


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="usher-sampled-server-torch",
        description="Unix-socket placement server against pre-loaded MATs.")
    p.add_argument("--manager-fifo-path", "-m", required=True,
                   help="Path to a fifo taking commands (stop, reload, "
                        "thread N, timeout N); existing file is deleted")
    p.add_argument("--socket-path", "-s", required=True,
                   help="Path to the unix socket; requests are usher args "
                        "one per line terminated by an empty line; replies "
                        "end with ASCII EOT")
    p.add_argument("--threads-per-process", "-T", type=int, default=0,
                   help="Accepted for CLI parity; device parallelism is "
                        "managed by CUDA")
    p.add_argument("--timeout", "-t", type=int, default=180,
                   help="Per-request timeout in seconds")
    p.add_argument("--reload_peroid", "-r", type=int, default=1,
                   help="Minutes between checks for outdated loaded protobuf")
    p.add_argument("--pb-to-load", "-l", nargs="+", default=[],
                   help="Initial list of protobufs to load")
    return p


def main(argv=None) -> int:
    from ..utils.device import apply_platform_env
    from ..utils.instrument import maybe_begin_session_from_env
    apply_platform_env()
    maybe_begin_session_from_env()
    args = build_parser().parse_args(argv)
    if len(args.socket_path) >= 107:
        _err(f"socket path length {len(args.socket_path)} is too long, "
             f"cannot exceed 107 bytes")
        return 1
    _err(f"Server PID: {os.getpid()}")
    trees = TreeCollection(args.pb_to_load)
    server = SocketServer(args.socket_path, args.manager_fifo_path, trees,
                          timeout_s=args.timeout,
                          refresh_period_min=args.reload_peroid)
    server.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
