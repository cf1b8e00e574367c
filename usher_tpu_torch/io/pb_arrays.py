"""Array-form parsimony.pb loading: pandemic-scale MATs without host Nodes
(counterpart of usher_tpu/io/pb_arrays.py).

load_mat_pb (io/pbio.py) builds a Python Node per tree node -- at the
reference's >2M-leaf public MAT that costs minutes and ~GBs before any
compute starts.  This loader goes straight to flat arrays (the compiled
proto/newick scanners, native/src/usher_native.cpp pb_to_arrays /
newick_to_arrays, where they are built; the pure-Python ones otherwise) and
hands them to
core/bigmat.py: slots are DFS preorder (the order parsimony.pb stores
node_mutations in, mutation_annotated_tree.cpp:522-613), with exact BFS
tie-break ranks recomputed from (level, parent rank, child key).

save_arrays_to_pb is the mirror writer, byte-compatible with
io/pbio.save_mat_pb for the same tree.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field

import numpy as np


@dataclass
class MatArrays:
    """Flat MAT: everything load_mat_pb knows, no Node objects."""
    parent: np.ndarray          # int32 [N], root -> itself; DFS preorder
    names_blob: bytes           # \0-joined, slot order
    name_off: np.ndarray        # int64 [N+1] offsets into names_blob
    blen: np.ndarray            # float64 [N]
    mut_ptr: np.ndarray         # int64 [N+1] CSR (post semantic filtering)
    mut_col: np.ndarray         # int32 [M] (column in `positions`)
    mut_par: np.ndarray         # uint8 [M] nibble
    mut_mut: np.ndarray         # uint8 [M] nibble mask
    positions: np.ndarray       # int64 [P] genome coordinates
    ref: np.ndarray             # uint8 [P] nibble
    chrom: str
    condensed: list = field(default_factory=list)   # (name, [leaves])
    ann_counts: np.ndarray | None = None            # int32 per node (slot)
    ann_blob: bytes = b""

    @property
    def n(self) -> int:
        return len(self.parent)

    def name(self, i: int) -> str:
        return self.names_blob[self.name_off[i]:
                               self.name_off[i + 1] - 1].decode()

    def names(self) -> list[str]:
        return self.names_blob.decode().split("\0")[:-1]

    def to_bigmat(self, device=None):
        """BigMAT over these arrays with exact reference tie-break ranks, on
        ``device`` (default: from USHER_TPU_PLATFORM, utils/device.py)."""
        from ..core.bigmat import BigMAT
        big = BigMAT(self.parent, self.mut_ptr, self.mut_col,
                     self.mut_par, self.mut_mut, self.positions, self.ref,
                     device=device)
        # slots are preorder, not BFS — recompute true BFS ranks so the
        # tie-break matches from_tree's BFS-slot build bit-for-bit
        big._recompute_ranks()
        for k in ("_dfs_meta_spr", "_dfs_meta_plc", "_csc_dev_cache"):
            if hasattr(big, k):
                delattr(big, k)
        return big


def _py_pb_to_arrays(buf: bytes):
    """parsimony.pb bytes -> (newick, per-node mutation counts, positions,
    ref / par nt ids, mut masks, chrom, condensed, annotation counts and
    blob), the fields in file order."""
    from . import proto_wire as pw
    newick = b""
    counts, pos, refn, parn, mask = [], [], [], [], []
    chrom = ""
    condensed = []
    ann_counts = []
    ann_parts = []
    for fn, wt, val in pw.iter_fields(buf):
        if fn == 1:
            newick = bytes(val)
        elif fn == 2:
            cnt = 0
            for fn2, wt2, val2 in pw.iter_fields(val):
                if fn2 != 1:
                    continue
                mpos = mref = mpar = 0
                mmask = 0
                for f3, w3, v3 in pw.iter_fields(val2):
                    if f3 == 1:
                        mpos = pw.to_int32(v3)
                    elif f3 == 2:
                        mref = pw.to_int32(v3)
                    elif f3 == 3:
                        mpar = pw.to_int32(v3)
                    elif f3 == 4:
                        nts = (pw.decode_packed_int32(v3) if w3 == 2
                               else [pw.to_int32(v3)])
                        for nt in nts:
                            if 0 <= nt < 4:
                                mmask |= 1 << nt
                    elif f3 == 5 and not chrom:
                        chrom = bytes(v3).decode()
                pos.append(mpos)
                refn.append(mref)
                parn.append(mpar)
                mask.append(mmask)
                cnt += 1
            counts.append(cnt)
        elif fn == 3:
            name, leaves = "", []
            for fn2, _, val2 in pw.iter_fields(val):
                if fn2 == 1:
                    name = bytes(val2).decode()
                elif fn2 == 2:
                    leaves.append(bytes(val2).decode())
            condensed.append((name, leaves))
        elif fn == 4:
            cnt = 0
            for fn2, _, val2 in pw.iter_fields(val):
                if fn2 == 1:
                    ann_parts.append(bytes(val2))
                    cnt += 1
            ann_counts.append(cnt)
    ann_blob = b"\0".join(ann_parts) + (b"\0" if ann_parts else b"")
    return (newick,
            np.asarray(counts, np.int32), np.asarray(pos, np.int32),
            np.asarray(refn, np.int8), np.asarray(parn, np.int8),
            np.asarray(mask, np.uint8), chrom, condensed,
            np.asarray(ann_counts, np.int32), ann_blob)


def _py_newick_to_arrays(newick: bytes):
    """Parse via io.newick then flatten in creation (= preorder) order."""
    from ..core.tree import Tree  # noqa: F401
    from .newick import parse_newick_string
    T = parse_newick_string(newick.decode())
    dfs = T.depth_first_expansion()
    slot = {id(nd): i for i, nd in enumerate(dfs)}
    parent = np.array([slot[id(nd.parent)] if nd.parent is not None else i
                       for i, nd in enumerate(dfs)], np.int32)
    names = "\0".join(nd.identifier for nd in dfs) + "\0"
    blen = np.array([nd.branch_length for nd in dfs], np.float64)
    return len(dfs), parent, names.encode(), blen


def load_mat_arrays(filename: str) -> MatArrays:
    """parsimony.pb -> MatArrays (no Python Node objects anywhere)."""
    if ".gz" in filename:
        with gzip.open(filename, "rb") as f:
            buf = f.read()
    else:
        with open(filename, "rb") as f:
            buf = f.read()

    from ..native import HAVE_NATIVE, ext
    if HAVE_NATIVE:
        (newick, counts_b, pos_b, ref_b, par_b, mask_b, chrom, condensed,
         annc_b, ann_blob) = ext.pb_to_arrays(buf)

        def fb(b, dt):
            # empty C++ vectors surface as None through y# (null data ptr)
            return (np.frombuffer(b, dt) if b
                    else np.zeros(0, dt))
        counts = fb(counts_b, np.int32)
        pos = fb(pos_b, np.int32)
        refn = fb(ref_b, np.int8)
        parn = fb(par_b, np.int8)
        mask = fb(mask_b, np.uint8)
        ann_counts = fb(annc_b, np.int32)
        ann_blob = ann_blob or b""
        n, parent_b, names_blob, blen_b = ext.newick_to_arrays(newick)
        parent = np.frombuffer(parent_b, np.int32)
        blen = np.frombuffer(blen_b, np.float64)
    else:
        (newick, counts, pos, refn, parn, mask, chrom, condensed,
         ann_counts, ann_blob) = _py_pb_to_arrays(buf)
        n, parent, names_blob, blen = _py_newick_to_arrays(newick)

    if len(counts) != n:
        raise ValueError(f"pb node_mutations count {len(counts)} != "
                         f"tree node count {n}")

    # semantic filtering, vectorized (load_mat_pb drops masked mutations'
    # alleles and mutations with mut_nuc == par_nuc,
    # mutation_annotated_tree.cpp:560-600)
    node_of = np.repeat(np.arange(n, dtype=np.int64),
                        counts.astype(np.int64))
    masked = pos < 0
    par_nib = np.where(masked, 0,
                       (1 << np.maximum(parn, 0).astype(np.int32))
                       ).astype(np.uint8)
    ref_nib = np.where(masked, 0,
                       (1 << np.maximum(refn, 0).astype(np.int32))
                       ).astype(np.uint8)
    keep = (~masked) & (mask != par_nib)
    node_k = node_of[keep]
    pos_k = pos[keep].astype(np.int64)
    par_k = par_nib[keep]
    mut_k = mask[keep]
    ref_k = ref_nib[keep]

    positions, inv = np.unique(pos_k, return_inverse=True)
    ref = np.zeros(len(positions), np.uint8)
    # first occurrence wins (collect_positions' rule; on well-formed MATs
    # every mutation at a position agrees on ref anyway)
    ref[inv[::-1]] = ref_k[::-1]
    # CSR over (already node-major) kept mutations
    kcounts = np.bincount(node_k, minlength=n).astype(np.int64)
    mut_ptr = np.zeros(n + 1, np.int64)
    mut_ptr[1:] = np.cumsum(kcounts)

    name_off = np.zeros(n + 1, np.int64)
    nb = np.frombuffer(names_blob, np.uint8)
    name_off[1:] = np.nonzero(nb == 0)[0] + 1

    return MatArrays(parent=np.asarray(parent), names_blob=bytes(names_blob),
                     name_off=name_off, blen=np.asarray(blen),
                     mut_ptr=mut_ptr, mut_col=inv.astype(np.int32),
                     mut_par=par_k, mut_mut=mut_k,
                     positions=positions, ref=ref, chrom=chrom or "",
                     condensed=list(condensed),
                     ann_counts=np.asarray(ann_counts, np.int32),
                     ann_blob=bytes(ann_blob))


def write_newick_arrays(ma: MatArrays, big=None) -> str:
    """final-tree.nh from arrays: internal labels + branch length =
    mutation count (write_newick semantics, io/newick.py /
    mutation_annotated_tree.cpp:215-346).  Iterative post-assembly over
    DFS preorder — no Node objects."""
    n = ma.n
    parent = ma.parent
    counts = np.diff(ma.mut_ptr)
    # children in slot order (preorder slots = children-list order)
    root = int(np.nonzero(parent == np.arange(n, dtype=parent.dtype))[0][0])
    nr = np.nonzero(np.arange(n) != root)[0]
    order = nr[np.argsort(parent[nr], kind="stable")]
    ch_ptr = np.zeros(n + 1, np.int64)
    ch_ptr[1:] = np.cumsum(np.bincount(parent[nr], minlength=n))
    children = order  # grouped by parent

    out: list[str] = []
    # explicit stack: (slot, child cursor)
    stack = [(root, 0)]
    while stack:
        slot, ci = stack[-1]
        lo, hi = ch_ptr[slot], ch_ptr[slot + 1]
        if ci == 0 and hi > lo:
            out.append("(")
        if lo + ci < hi:
            if ci > 0:
                out.append(",")
            stack[-1] = (slot, ci + 1)
            stack.append((int(children[lo + ci]), 0))
            continue
        if hi > lo:
            out.append(")")
        out.append(f"{ma.name(slot)}:{int(counts[slot])}")
        stack.pop()
    return "".join(out) + ";"


def set_names(ma: MatArrays, names: list[str]) -> None:
    """Replace the names blob (and offsets) from a python list."""
    blob = ("\0".join(names) + "\0").encode()
    ma.names_blob = blob
    off = np.zeros(len(names) + 1, np.int64)
    off[1:] = np.nonzero(np.frombuffer(blob, np.uint8) == 0)[0] + 1
    ma.name_off = off


def expand_condensed(names, parent, children, has_muts, condensed,
                     counter: int, on_new) -> int:
    """Tree.uncondense_leaves (core/tree.py:467-497) over index lists,
    shared by the array-native writers: a with-mutations group turns its
    node into a fresh internal (node_<counter+1>) with all members as new
    leaves; a plain group renames the node to the first member and
    appends the rest under the parent; empty groups are skipped (the Tree
    path matches no branch for them).  Mutates the lists in place;
    on_new(j) initializes caller-side per-node state for appended index
    j; returns the updated internal-node counter."""
    slot_of = {nm: i for i, nm in enumerate(names)}
    for name, samples in condensed:
        i = slot_of.get(name)
        if i is None or not samples:
            continue
        if len(samples) > 1 and has_muts(i):
            counter += 1
            names[i] = f"node_{counter}"
            tgt = par = i
        else:
            names[i] = samples[0]
            samples = samples[1:]
            tgt = par = parent[i]
        for snm in samples:
            j = len(names)
            names.append(snm)
            parent.append(par)
            children.append([])
            children[tgt].append(j)
            on_new(j)
    return counter


def ann_lists(ma: MatArrays, n: int | None = None):
    """(per-slot annotation lists, column count) from the packed blob;
    (None, 0) when the MAT carries no annotations.  Slots beyond the
    stored counts get empty lists — callers appending nodes must widen
    them to the column count for Tree-path parity."""
    if ma.ann_counts is None or not len(ma.ann_counts):
        return None, 0
    if n is None:
        n = ma.n
    blob = ma.ann_blob.decode().split("\0")[:-1]
    ac = np.zeros(n, np.int64)
    ac[:len(ma.ann_counts)] = ma.ann_counts
    st = np.cumsum(ac) - ac
    ncols = int(ac.max())
    return [blob[int(st[i]):int(st[i] + ac[i])] for i in range(n)], ncols


def _mutation_blocks_vec(ma: MatArrays, pre) -> bytes | None:
    """Vectorized encoder for the per-node node_mutations blocks of
    save_arrays_to_pb: one numpy pass over the whole CSR instead of
    millions of per-field Python varint calls (the pb save was ~1/4 of a
    4096-sample serve; at the >2M-leaf public MAT scale the Python loop
    is minutes).  Byte-identical to the loop (the save parity tests
    cover both via the fallback switch).  Returns None for layouts the
    fast path doesn't cover (ambiguous ref/par nibbles whose nt id is
    -1, giant positions, >90-char chromosome names): callers fall back
    to the general loop."""
    n = ma.n
    M = len(ma.mut_col)
    chrom_b = ma.chrom.encode() if ma.chrom else b""
    CL = len(chrom_b)
    if CL > 90:
        return None
    counts = np.diff(ma.mut_ptr).astype(np.int64)
    # mutations in preorder node order
    if np.array_equal(pre, np.arange(n)):
        src = np.arange(M, dtype=np.int64)
        node_counts = counts
    else:
        starts = ma.mut_ptr[pre]
        node_counts = counts[pre]
        src = (np.repeat(starts, node_counts)
               + _ranges_i64(node_counts))
    col = ma.mut_col[src].astype(np.int64)
    pv = ma.positions[col].astype(np.int64)
    if len(pv) and (pv.min() < 0 or pv.max() >= (1 << 28)):
        return None
    NT = np.full(16, -1, np.int64)
    NT[[1, 2, 4, 8]] = [0, 1, 2, 3]
    ref_nt = NT[ma.ref[col]]
    par_nt = NT[ma.mut_par[src]]
    if len(ref_nt) and (ref_nt.min() < 0 or par_nt.min() < 0):
        return None
    # mut_nuc nibble -> packed nt list (0/15 expand to all four)
    LTAB = np.zeros((16, 4), np.uint8)
    LLEN = np.zeros(16, np.int64)
    from ..core.nuc import nt_list_from_nuc_id as _nl
    for x in range(16):
        lst = _nl(x)
        LLEN[x] = len(lst)
        LTAB[x, :len(lst)] = lst
    mut_n = ma.mut_mut[src]
    ml_len = LLEN[mut_n]
    # varint length of the position (1..4 bytes under the 2^28 guard)
    pb_len = (1 + (pv >= 1 << 7) + (pv >= 1 << 14)
              + (pv >= 1 << 21)).astype(np.int64)
    chrom_part = (2 + CL) if CL else 0
    mb_len = 1 + pb_len + 2 + 2 + 2 + ml_len + chrom_part   # < 128
    rec_len = 2 + mb_len                                    # 0x0a len mb
    node_body = np.zeros(n, np.int64)
    node_of = np.repeat(np.arange(n, dtype=np.int64), node_counts)
    np.add.at(node_body, node_of, rec_len)
    nb_len = (1 + (node_body >= 1 << 7) + (node_body >= 1 << 14)
              + (node_body >= 1 << 21)).astype(np.int64)
    node_total = 1 + nb_len + node_body                     # 0x12 len ml
    node_start = np.cumsum(node_total) - node_total
    buf = np.zeros(int(node_total.sum()), np.uint8)
    # node headers
    buf[node_start] = 0x12
    o = node_start + 1
    v = node_body.copy()
    for k in range(int(nb_len.max())):
        live = nb_len > k
        more = nb_len > k + 1
        buf[o[live] + k] = ((v[live] & 0x7F)
                            | np.where(more[live], 0x80, 0))
        v >>= 7
    # per-record offsets: node content start + exclusive prefix within
    rec_end = np.cumsum(rec_len)
    rec_off0 = rec_end - rec_len
    base_rec = np.zeros(n, np.int64)
    if n:
        np.maximum.at(base_rec, node_of, rec_end)  # end of node's last
        base_rec = base_rec - node_body            # start of node's block
    rs = (node_start[node_of] + 1 + nb_len[node_of]
          + (rec_off0 - base_rec[node_of]))
    buf[rs] = 0x0A
    buf[rs + 1] = mb_len.astype(np.uint8)
    buf[rs + 2] = 0x08
    o = rs + 3
    v = pv.copy()
    for k in range(int(pb_len.max()) if M else 0):
        live = pb_len > k
        more = pb_len > k + 1
        buf[o[live] + k] = ((v[live] & 0x7F)
                            | np.where(more[live], 0x80, 0))
        v >>= 7
    o = rs + 3 + pb_len
    buf[o] = 0x10
    buf[o + 1] = ref_nt.astype(np.uint8)
    buf[o + 2] = 0x18
    buf[o + 3] = par_nt.astype(np.uint8)
    buf[o + 4] = 0x22
    buf[o + 5] = ml_len.astype(np.uint8)
    for k in range(4):
        live = ml_len > k
        buf[o[live] + 6 + k] = LTAB[mut_n[live], k]
    if CL:
        o = o + 6 + ml_len
        buf[o] = 0x2A
        buf[o + 1] = CL
        idx2 = (o[:, None] + 2 + np.arange(CL)[None, :]).reshape(-1)
        buf[idx2] = np.tile(np.frombuffer(chrom_b, np.uint8), M)
    return buf.tobytes()


def _ranges_i64(counts):
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    starts = np.cumsum(counts) - counts
    return np.arange(total, dtype=np.int64) - np.repeat(starts, counts)


def save_arrays_to_pb(ma: MatArrays, filename: str) -> None:
    """MatArrays -> parsimony.pb, wire-compatible with io/pbio.save_mat_pb
    (same field layout; newick via write_newick_arrays' leaf-label form).
    The mirror of load_mat_arrays — pb fixtures at pandemic scale can be
    produced and re-read without any host Node objects."""
    from ..core.nuc import nt_from_nuc_id, nt_list_from_nuc_id
    from . import proto_wire as pw

    out = bytearray()
    # newick with UNLABELED internals + branch length = mutation count
    # (save_mat_pb writes print_internal=False)
    n = ma.n
    parent = ma.parent
    counts = np.diff(ma.mut_ptr)
    root = int(np.nonzero(parent == np.arange(n, dtype=parent.dtype))[0][0])
    nr = np.nonzero(np.arange(n) != root)[0]
    order = nr[np.argsort(parent[nr], kind="stable")]
    ch_ptr = np.zeros(n + 1, np.int64)
    ch_ptr[1:] = np.cumsum(np.bincount(parent[nr], minlength=n))
    parts: list[str] = []
    stack = [(root, 0)]
    while stack:
        slot, ci = stack[-1]
        lo, hi = ch_ptr[slot], ch_ptr[slot + 1]
        if ci == 0 and hi > lo:
            parts.append("(")
        if lo + ci < hi:
            if ci > 0:
                parts.append(",")
            stack[-1] = (slot, ci + 1)
            stack.append((int(order[lo + ci]), 0))
            continue
        if hi > lo:
            parts.append(f"):{int(counts[slot])}")
        else:
            parts.append(f"{ma.name(slot)}:{int(counts[slot])}")
        stack.pop()
    pw.write_string_field(1, "".join(parts) + ";", out)

    # node_mutations in DFS preorder.  Slots ARE preorder for arrays built
    # by load_mat_arrays; recompute generally via the parent structure.
    pre = np.empty(n, np.int64)
    k = 0
    stack2 = [root]
    while stack2:
        slot = stack2.pop()
        pre[k] = slot
        k += 1
        stack2.extend(order[ch_ptr[slot]:ch_ptr[slot + 1]][::-1].tolist())
    blocks = _mutation_blocks_vec(ma, pre)
    if blocks is not None:
        out += blocks
    else:
        for slot in pre.tolist():
            ml = bytearray()
            for j in range(int(ma.mut_ptr[slot]),
                           int(ma.mut_ptr[slot + 1])):
                mb = bytearray()
                col = int(ma.mut_col[j])
                pw.write_varint_field(1, int(ma.positions[col]), mb)
                pw.write_varint_field(2, nt_from_nuc_id(int(ma.ref[col])),
                                      mb)
                pw.write_varint_field(3,
                                      nt_from_nuc_id(int(ma.mut_par[j])),
                                      mb)
                pw.write_packed_int32_field(
                    4, nt_list_from_nuc_id(int(ma.mut_mut[j])), mb)
                if ma.chrom:
                    pw.write_string_field(5, ma.chrom, mb)
                pw.write_bytes_field(1, bytes(mb), ml)
            pw.write_bytes_field(2, bytes(ml), out)

    for name, leaves in ma.condensed:
        cb = bytearray()
        pw.write_string_field(1, name, cb)
        for leaf in leaves:
            pw.write_string_field(2, leaf, cb)
        pw.write_bytes_field(3, bytes(cb), out)

    if ma.ann_counts is not None and len(ma.ann_counts):
        anns = ma.ann_blob.decode().split("\0")[:-1]
        # ann_blob is stored in SLOT order — index by per-slot offsets, not
        # a cursor advancing in the (recomputed) preorder
        acounts = np.zeros(n, np.int64)
        acounts[:len(ma.ann_counts)] = ma.ann_counts
        astarts = np.cumsum(acounts) - acounts
        for slot in pre.tolist():
            meta = bytearray()
            lo = int(astarts[slot])
            for ann in anns[lo:lo + int(acounts[slot])]:
                pw.write_string_field(1, ann, meta)
            pw.write_bytes_field(4, bytes(meta), out)

    data = bytes(out)
    if ".gz" in filename:
        with gzip.open(filename, "wb") as f:
            f.write(data)
    else:
        with open(filename, "wb") as f:
            f.write(data)
