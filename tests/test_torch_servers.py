"""The port's two servers against the JAX package's, on the CPU
(USHER_TPU_PLATFORM=cpu).

usher_server (usher_tpu_torch/cli/usher_server_cli.py, argument-directory
daemon) and the usher-sampled socket server
(usher_tpu_torch/cli/usher_socket_server_cli.py, unix socket + manager
FIFO): the nine tests of tests/test_servers.py on the port's side, each
also holding the files the port writes, and the socket replies it sends,
equal to the JAX servers' for the same requests; then a `-s` request (the
fused B2 sort pre-pass, its plain twin here), `main` of both daemons, and
two identical socket requests that must get identical replies and files.
Tolerance: none (byte-equal files and replies).
"""

import os
import socket
import threading
import time

import pytest

from usher_tpu.cli import usher_server_cli as jserver
from usher_tpu.cli import usher_socket_server_cli as jsock
from usher_tpu.cli.usher_cli import main as jax_usher
from usher_tpu_torch.cli import usher_server_cli as tserver
from usher_tpu_torch.cli import usher_socket_server_cli as tsock

from conftest import REFERENCE_SCRIPTS_DIR

SCRIPTS = REFERENCE_SCRIPTS_DIR

NEW_SAMPLE_VCF = """##fileformat=VCFv4.2
#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tGT\tz1
x\t1\t.\tA\tT\t.\t.\t.\t.\t1
x\t2\t.\tA\tT\t.\t.\t.\t.\t1
x\t3\t.\tA\tT\t.\t.\t.\t.\t1
x\t6\t.\tA\tT\t.\t.\t.\t.\t1
x\t7\t.\tA\tT\t.\t.\t.\t.\t1
"""
TWO_SAMPLE_VCF = """##fileformat=VCFv4.2
#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tGT\tz1\tz2\tz3
x\t1\t.\tA\tT\t.\t.\t.\t.\t1\t0\t1
x\t6\t.\tA\tT\t.\t.\t.\t.\t1\t1\t0
x\t7\t.\tA\tT\t.\t.\t.\t.\t0\t1\t1
"""


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("USHER_TPU_PLATFORM", "cpu")


@pytest.fixture(scope="module")
def small_mat(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("server_build"))
    pb = os.path.join(outdir, "small.pb")
    assert jax_usher(["-t", os.path.join(SCRIPTS, "testBranchLen2.nwk"),
                      "-v", os.path.join(SCRIPTS, "testBranchLen2.vcf"),
                      "-o", pb, "-d", outdir, "--mesh-devices", "0"]) == 0
    return pb


def _files(d):
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


def _serve_both(tmp_path, small_mat, lines, mat_list=False):
    """One argument file of `lines` ({d}: the side's output directory, {v}:
    the new-sample VCF) through each package's serve(); each side's output
    files by name."""
    vcf = tmp_path / "new.vcf"
    vcf.write_text(NEW_SAMPLE_VCF)
    got = {}
    for side, mod in (("jax", jserver), ("torch", tserver)):
        arg_dir = tmp_path / f"args_{side}"
        arg_dir.mkdir()
        d = tmp_path / side
        (arg_dir / "job.txt").write_text("".join(
            ln.format(d=d, v=vcf, m=small_mat) + "^\n" for ln in lines))
        if mat_list:
            listing = tmp_path / f"mats_{side}.txt"
            listing.write_text(small_mat + "\n")
            store = mod.MatStore(str(listing))
            assert store.load_list()
        else:
            store = mod.MatStore("")
        assert mod.serve(str(arg_dir), store, sleep_ms=10, term_char=94,
                         once=True) == 0
        assert not list(arg_dir.iterdir())
        got[side] = (_files(d), store)
    assert got["torch"][0] and got["torch"][0] == got["jax"][0]
    return got["torch"]


def _request(sock_path: str, args: list[str]) -> bytes:
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.settimeout(60)
    c.connect(sock_path)
    c.sendall(("".join(a + "\n" for a in args) + "\n").encode())
    buf = b""
    while not buf.endswith(b"\x04\n"):
        chunk = c.recv(4096)
        if not chunk:
            break
        buf += chunk
    c.close()
    return buf


def _socket_session(mod, tmp_path, tag, preload, requests):
    """Serve `requests` (argument lists; {d} is the side's directory) on a
    fresh socket server of `mod`; the replies, in order."""
    sock_path = str(tmp_path / f"{tag}.sock")
    trees = mod.TreeCollection(preload)
    server = mod.SocketServer(sock_path, str(tmp_path / f"{tag}.fifo"),
                              trees, timeout_s=60)
    th = threading.Thread(target=server.serve_forever,
                          kwargs={"max_requests": len(requests)},
                          daemon=True)
    th.start()
    try:
        replies = [_request(sock_path, [a.format(d=tmp_path / tag)
                                        for a in args])
                   for args in requests]
    finally:
        th.join(timeout=120)
        server.close()
    assert not th.is_alive()
    return replies, trees


# --- usher_server: the tests of tests/test_servers.py --------------------------

def test_usher_server_processes_request(small_mat, tmp_path):
    files, _ = _serve_both(tmp_path, small_mat,
                           ["-i {m} -v {v} -d {d} -o {d}/result.pb"])
    assert {"final-tree.nh", "result.pb"} <= set(files)
    assert files["placement_stats.tsv"].startswith(b"z1\t")


def test_usher_server_skips_unterminated_file(small_mat, tmp_path):
    arg_dir = tmp_path / "args"
    arg_dir.mkdir()
    (arg_dir / "notready.txt").write_text("-i x -v y -d z\n")  # no '^'
    store = tserver.MatStore("")
    assert tserver.serve(str(arg_dir), store, sleep_ms=10, term_char=94,
                         once=True) == 0
    assert (arg_dir / "notready.txt").exists()


def test_usher_server_mat_list_preload_and_consume(small_mat, tmp_path):
    mat_list = tmp_path / "mats.txt"
    mat_list.write_text(small_mat + "\n")
    store = tserver.MatStore(str(mat_list))
    assert store.load_list()
    assert store.trees[small_mat] is not None
    T = store.acquire(small_mat)
    assert T.root is not None
    assert store.trees[small_mat] is None
    store.refresh_consumed()
    assert store.trees[small_mat] is not None
    # the port's own Tree, not the JAX package's
    assert type(T).__module__ == "usher_tpu_torch.core.tree"


def test_usher_server_version_and_reload_lines(small_mat, tmp_path, capsys):
    arg_dir = tmp_path / "args"
    arg_dir.mkdir()
    mat_list = tmp_path / "mats.txt"
    mat_list.write_text(small_mat + "\n")
    (arg_dir / "job.txt").write_text("--version^\n--reload^\n")
    store = tserver.MatStore(str(mat_list))
    assert tserver.serve(str(arg_dir), store, sleep_ms=10, term_char=94,
                         once=True) == 0
    assert "UShER (v0.1.0 usher-torch)" in capsys.readouterr().out
    assert store.trees[small_mat] is not None


def test_usher_server_mat_list_serve_cycle(small_mat, tmp_path):
    files, store = _serve_both(tmp_path, small_mat, ["-i {m} -v {v} -d {d}"],
                               mat_list=True)
    assert "placement_stats.tsv" in files
    store.refresh_consumed()
    assert store.trees[small_mat] is not None
    assert store.trees[small_mat].get_node("z1") is None


def test_usher_server_sort_requests(small_mat, tmp_path):
    """A -s -p request (B2 pre-pass) and a -S -r -u one in one file: the
    files equal the JAX server's."""
    vcf2 = tmp_path / "two.vcf"
    vcf2.write_text(TWO_SAMPLE_VCF)
    files, _ = _serve_both(tmp_path, small_mat, [
        f"-i {{m}} -v {vcf2} -d {{d}}/s -s -p",
        f"-i {{m}} -v {vcf2} -d {{d}}/S -S -r -u"])
    assert {"s/parsimony-scores.tsv", "S/uncondensed-final-tree.nh"} <= \
        set(files)


def test_usher_server_main(small_mat, tmp_path):
    arg_dir = tmp_path / "args"
    arg_dir.mkdir()
    vcf = tmp_path / "new.vcf"
    vcf.write_text(NEW_SAMPLE_VCF)
    mat_list = tmp_path / "mats.txt"
    mat_list.write_text(small_mat + "\n")
    (arg_dir / "a.txt").write_text(f"-i {small_mat} -v {vcf} -d "
                                   f"{tmp_path}/out^\n")
    assert tserver.main(["-a", str(arg_dir), "-i", str(mat_list),
                         "--once"]) == 0
    assert (tmp_path / "out" / "placement_stats.tsv").exists()
    assert tserver.main(["-a", str(tmp_path / "nodir")]) == 1


# --- the socket server: the tests of tests/test_servers.py ---------------------

def test_socket_server_placement_roundtrip(small_mat, tmp_path):
    vcf = tmp_path / "new.vcf"
    vcf.write_text(NEW_SAMPLE_VCF)
    requests = [["-i", "/nonexistent.pb", "-v", str(vcf)],
                ["-i", small_mat, "-v", str(vcf), "-d", "{d}"]]
    replies = {}
    for side, mod in (("jax", jsock), ("torch", tsock)):
        replies[side], trees = _socket_session(mod, tmp_path, side,
                                               [small_mat], requests)
        # the resident tree is unchanged (Tree.copy per request)
        assert trees.trees[small_mat].tree.get_node("z1") is None
    assert replies["torch"] == replies["jax"]
    miss, placed = replies["torch"]
    assert b"not found" in miss and small_mat.encode() in miss
    assert miss.endswith(b"\x04\n") and placed.endswith(b"\x04\n")
    assert b"Sample name: z1" in placed
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")
    stats = (tmp_path / "torch" / "placement_stats.tsv").read_text()
    assert stats.startswith("z1\t")


def test_socket_server_existing_samples_mode(small_mat, tmp_path):
    samples_file = tmp_path / "samples.txt"
    samples_file.write_text("a\nb\nnosuchsample\n")
    replies = {}
    for side, mod in (("jax", jsock), ("torch", tsock)):
        outdir = tmp_path / side
        outdir.mkdir()
        trees = mod.TreeCollection([small_mat])
        replies[side] = mod.handle_request(
            ["-i", small_mat, "--existing_samples", str(samples_file),
             "-K", "4", "-k", "3", "-D", "-d", str(outdir)], trees)
    assert replies["torch"] == replies["jax"]
    assert replies["torch"].endswith(b"\x04\n")
    assert b"nosuchsample" in replies["torch"]
    files = _files(tmp_path / "torch")
    assert "single-subtree.nh" in files
    assert files == _files(tmp_path / "jax")


def test_socket_server_fifo_stop(small_mat, tmp_path):
    sock_path = str(tmp_path / "s2.sock")
    fifo_path = str(tmp_path / "mgr2.fifo")
    server = tsock.SocketServer(sock_path, fifo_path,
                                tsock.TreeCollection([]), timeout_s=5)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    with open(fifo_path, "w") as f:
        f.write("stop\n")
        f.flush()
    th.join(timeout=30)
    assert not th.is_alive()
    assert not os.path.exists(sock_path)


def test_socket_server_fifo_reload_and_timeout(small_mat, tmp_path):
    sock_path = str(tmp_path / "s3.sock")
    fifo_path = str(tmp_path / "mgr3.fifo")
    trees = tsock.TreeCollection([])
    assert trees.trees == {}
    server = tsock.SocketServer(sock_path, fifo_path, trees, timeout_s=30)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        with open(fifo_path, "w") as f:
            f.write(f"timeout 77\nthread 4\nreload\n{small_mat}\n\n")
            f.flush()
        for _ in range(100):
            if small_mat in trees.trees and server.timeout_s == 77:
                break
            time.sleep(0.1)
        assert server.timeout_s == 77
        assert small_mat in trees.trees
        reply = _request(sock_path, ["-i", small_mat, "--existing_samples",
                                     "/dev/null", "-d", str(tmp_path)])
        want = jsock.handle_request(
            ["-i", small_mat, "--existing_samples", "/dev/null", "-d",
             str(tmp_path)], jsock.TreeCollection([small_mat]))
        assert reply == want and reply.endswith(b"\x04\n")
        assert _request(sock_path, ["--version"]) == \
            b"usher-sampled-torch (v0.1.0)\n\x04\n"
    finally:
        with open(fifo_path, "w") as f:
            f.write("stop\n")
        th.join(timeout=30)
        server.close()
    assert not th.is_alive()


# --- beyond tests/test_servers.py ----------------------------------------------

def test_socket_server_repeated_requests_match(small_mat, tmp_path):
    """Two identical -s requests on one server: equal replies and files,
    and equal to the JAX server's (each request places onto its own copy
    of the resident tree)."""
    vcf = tmp_path / "two.vcf"
    vcf.write_text(TWO_SAMPLE_VCF)
    req = ["-i", small_mat, "-v", str(vcf), "-s", "-d", "{d}", "-o",
           "{d}/o.pb"]
    (tmp_path / "jax").mkdir()
    jreplies, _ = _socket_session(jsock, tmp_path, "jax", [small_mat], [req])
    jfiles = _files(tmp_path / "jax")
    replies, trees = _socket_session(tsock, tmp_path, "torch", [small_mat],
                                     [req, req])
    assert replies == jreplies * 2
    assert _files(tmp_path / "torch") == jfiles
    assert trees.trees[small_mat].tree.get_node("z1") is None


def test_socket_server_main(small_mat, tmp_path):
    """main(): pre-load, serve one request, stop on the FIFO."""
    sock_path = str(tmp_path / "m.sock")
    fifo_path = str(tmp_path / "m.fifo")
    rc = []
    th = threading.Thread(target=lambda: rc.append(tsock.main(
        ["-m", fifo_path, "-s", sock_path, "-l", small_mat])), daemon=True)
    th.start()
    for _ in range(200):
        if os.path.exists(sock_path) and os.path.exists(fifo_path):
            break
        time.sleep(0.05)
    reply = _request(sock_path, ["-i", small_mat, "--version"])
    assert reply.startswith(b"usher-sampled-torch")
    with open(fifo_path, "w") as f:
        f.write("stop\n")
    th.join(timeout=30)
    assert not th.is_alive() and rc == [0]
    assert tsock.main(["-m", fifo_path, "-s", "x" * 120]) == 1
