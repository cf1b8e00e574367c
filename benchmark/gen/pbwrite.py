"""Writer of a MAT as a UShER parsimony.pb, vectorised with numpy.

Written from the protobuf wire format that `usher_tpu_torch/io/proto_wire.py`
and `io/pbio.py::save_mat_pb` use at commit f18dcaca4b2a (nothing of the
port is imported): field 1 the newick (leaves named, internal nodes
unnamed, branch length = number of mutations, the root's too); field 2 one
`node_mutations` message per node in preorder, each a list of mutations
{1 position, 2 ref (0-3), 3 parent allele (0-3), 4 packed new alleles,
5 chromosome}.  No condensed nodes and no clade metadata.
"""

from __future__ import annotations

import numpy as np

CHROM = "NC_045512v2"


def varints(values: np.ndarray):
    """Protobuf varints of non-negative ints: (bytes [n, 10] uint8, lengths)."""
    x = np.asarray(values, np.uint64).copy()
    out = np.zeros((len(x), 10), np.uint8)
    lens = np.ones(len(x), np.int64)
    for i in range(10):
        low = (x & np.uint64(0x7F)).astype(np.uint8)
        x >>= np.uint64(7)
        more = x > 0
        out[:, i] = low | (more.astype(np.uint8) << 7)
        if not more.any():
            break
        lens += more
    return out, lens


class _Rows:
    """Byte rows of varying length, filled column by column."""

    def __init__(self, n: int, width: int):
        self.buf = np.zeros((n, width), np.uint8)
        self.cur = np.zeros(n, np.int64)
        self.rows = np.arange(n)

    def put(self, data: np.ndarray, lens=None) -> None:
        data = np.atleast_2d(data)
        if data.shape[0] == 1 and len(self.rows) != 1:
            data = np.broadcast_to(data, (len(self.rows), data.shape[1]))
        if lens is None:
            lens = np.full(len(self.rows), data.shape[1], np.int64)
        for j in range(data.shape[1]):
            m = j < lens
            self.buf[self.rows[m], self.cur[m] + j] = data[m, j]
        self.cur += lens


def nt2(nib: np.ndarray) -> np.ndarray:
    """One-hot nibble -> 2-bit index (A 0, C 1, G 2, T 3)."""
    return np.searchsorted(np.array([1, 2, 4, 8]), nib).astype(np.uint8)


def newick(mat: dict) -> str:
    """The pb's newick: preorder nodes, leaves `leaf_<i>`, internal nodes
    unnamed, `:<number of mutations>` on every node."""
    parent = mat["parent"].tolist()
    leaf = mat["is_leaf"].tolist()
    cnt = np.diff(mat["mut_ptr"]).tolist()
    end = (np.arange(len(parent)) + mat["size"]).tolist()
    parts: list[str] = []
    stack: list[int] = []
    for v in range(len(parent)):
        while stack and end[stack[-1]] <= v:
            parts.append(f"):{cnt[stack.pop()]}")
        if v and v != parent[v] + 1:
            parts.append(",")
        if leaf[v]:
            parts.append(f"leaf_{v}:{cnt[v]}")
        else:
            parts.append("(")
            stack.append(v)
    while stack:
        parts.append(f"):{cnt[stack.pop()]}")
    parts.append(";")
    return "".join(parts)


def pb_bytes(mat: dict) -> bytes:
    mut_ptr = mat["mut_ptr"]
    n = len(mut_ptr) - 1
    m = int(mut_ptr[-1])
    col = mat["mut_col"]
    chrom = np.frombuffer(CHROM.encode(), np.uint8)
    pos_v, pos_l = varints(mat["positions"][col])
    mb_len = 1 + pos_l + 2 + 2 + 3 + 2 + len(chrom)
    if mb_len.max() >= 128:
        raise ValueError("mutation message longer than a 1-byte length")
    mr = _Rows(m, 2 + int(mb_len.max()))
    mr.put(np.array([[0x0A]], np.uint8))
    mr.put(mb_len[:, None].astype(np.uint8))
    mr.put(np.array([[0x08]], np.uint8))
    mr.put(pos_v, pos_l)
    ref_nt = nt2(mat["ref"][col])
    mr.put(np.stack([np.full(m, 0x10, np.uint8), ref_nt], 1))
    mr.put(np.stack([np.full(m, 0x18, np.uint8),
                     nt2(mat["mut_par"])], 1))
    mr.put(np.stack([np.full(m, 0x22, np.uint8), np.ones(m, np.uint8),
                     nt2(mat["mut_mut"])], 1))
    mr.put(np.concatenate([[0x2A, len(chrom)], chrom]).astype(np.uint8)[None])
    node_len = np.zeros(n, np.int64)
    np.add.at(node_len, np.repeat(np.arange(n), np.diff(mut_ptr)),
              mr.cur)
    nl_v, nl_l = varints(node_len)
    hr = _Rows(n, 11)
    hr.put(np.array([[0x12]], np.uint8))
    hr.put(nl_v, nl_l)
    width = max(mr.buf.shape[1], hr.buf.shape[1])
    rows = np.zeros((n + m, width), np.uint8)
    lens = np.zeros(n + m, np.int64)
    head_at = np.arange(n) + mut_ptr[:-1]
    mut_at = np.repeat(np.arange(n), np.diff(mut_ptr)) + 1 + np.arange(m)
    rows[head_at, :hr.buf.shape[1]] = hr.buf
    lens[head_at] = hr.cur
    rows[mut_at, :mr.buf.shape[1]] = mr.buf
    lens[mut_at] = mr.cur
    body = rows[np.arange(width)[None, :] < lens[:, None]]
    nwk = newick(mat).encode()
    nv, nlen = varints(np.array([len(nwk)]))
    return (b"\x0a" + nv[0, :nlen[0]].tobytes() + nwk + body.tobytes())


def write_pb(mat: dict, path: str) -> None:
    with open(path, "wb") as f:
        f.write(pb_bytes(mat))
