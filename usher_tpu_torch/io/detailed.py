"""Detailed-mutations checkpoint: chunked, zlib-compressed, parallel-load.

The matOptimize intermediate checkpoint format, structurally matching the
reference (mutation_detailed.proto:4-31; writer
src/matOptimize/detailed_mutations_store.cpp:279-296; parallel loader
src/matOptimize/detailed_mutations_load.cpp):

File layout (detailed_mutations_store.cpp:13-19)::

    repeated blocks: [u64 uncompressed_start_offset][u64 compressed_size]
                     [zlib-compressed data]
    trailing 8 bytes: total uncompressed length

Uncompressed stream: per-node ``node`` messages serialized children-first
(each parent records its children's (offset, length) pairs, enabling
parallel subtree deserialization), then the ``meta`` message (reference
genome, chromosomes, node-id<->name map, root offset/length), then 8 bytes
holding the meta message's offset.

Field numbers match mutation_detailed.proto: node{1 mutation_positions,
2 mutation_other_fields (fixed32: chrom_idx | par_mut_nuc<<8 |
boundary1_all_major_allele<<16 | decrement_increment_effect<<24, the compact
Mutation's second word, mutation_annotated_tree.hpp:105-240), 5 node_id,
6 children_offsets, 7 children_lengths, 8 condensed_nodes, 9 changed},
meta{1 ref_nuc, 2 nodes_idx_next, 3 chromosomes, 4 root_offset,
5 root_length, 6 node_idx_map{1 node_id, 2 node_name}}.

Deviations (documented, additive): node field 10 carries clade annotation
strings and field 11 the branch length as packed float, so a checkpoint
roundtrip is lossless for our classic MAT (the reference's compact MAT
drops both).  Block decompression on load runs in a thread pool (zlib
releases the GIL) — the analog of the reference's TBB pipelined load.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

from ..core.tree import Mutation, Node, Tree
from .proto_wire import (decode_packed_int32, decode_varint, encode_varint,
                         iter_fields, write_bytes_field,
                         write_packed_float_field, write_packed_int32_field,
                         write_string_field, write_varint_field)

BLOCK_SIZE = 0x1000000  # 16 MiB, detailed_mutation_load_store.hpp:1


def _write_packed_fixed32_field(field_number: int, values, out: bytearray):
    if not values:
        return
    write_bytes_field(field_number,
                      struct.pack(f"<{len(values)}I", *values), out)


def _decode_packed_fixed32(payload) -> list[int]:
    n = len(payload) // 4
    return list(struct.unpack(f"<{n}I", bytes(payload)))


class _BlockWriter:
    """Accumulates the uncompressed stream, emitting compressed blocks
    (serializer_t + compressor_node, detailed_mutations_store.cpp:33-115)."""

    def __init__(self, f):
        self.f = f
        self.offset = 0          # uncompressed offset of pending buffer start
        self.total = 0           # total uncompressed bytes appended
        self.pending = bytearray()

    def append(self, data: bytes) -> int:
        """Append to the stream; returns the data's uncompressed offset."""
        off = self.total
        self.pending += data
        self.total += len(data)
        if len(self.pending) >= BLOCK_SIZE:
            self._flush()
        return off

    def _flush(self):
        if not self.pending:
            return
        comp = zlib.compress(bytes(self.pending))
        self.f.write(struct.pack("<QQ", self.offset, len(comp)))
        self.f.write(comp)
        self.offset = self.total
        self.pending = bytearray()

    def finalize(self) -> int:
        self._flush()
        self.f.write(struct.pack("<Q", self.total))
        return self.total


def _chrom_table(T: Tree) -> tuple[list[str], dict[str, int]]:
    chroms: list[str] = []
    index: dict[str, int] = {}
    for n in T.depth_first_expansion():
        for m in n.mutations:
            if m.chrom not in index:
                index[m.chrom] = len(chroms)
                chroms.append(m.chrom)
    if not chroms:
        chroms, index = [""], {"": 0}
    return chroms, index


def _encode_node(node: Node, node_id: int, T: Tree, chrom_idx: dict[str, int],
                 child_offsets: list[int], child_lengths: list[int],
                 changed: bool) -> bytes:
    out = bytearray()
    positions, other = [], []
    for m in node.mutations:
        positions.append(m.position)
        par_mut = ((m.par_nuc & 0xF) << 4) | (m.mut_nuc & 0xF)
        other.append(chrom_idx.get(m.chrom, 0)
                     | (par_mut << 8)
                     | ((m.mut_nuc & 0xF) << 16))
    write_packed_int32_field(1, positions, out)
    _write_packed_fixed32_field(2, other, out)
    write_varint_field(5, node_id, out)
    if child_offsets:
        payload = bytearray()
        for v in child_offsets:
            encode_varint(v, payload)
        write_bytes_field(6, bytes(payload), out)
        write_packed_int32_field(7, child_lengths, out)
    for name in T.condensed_nodes.get(node.identifier, ()):
        write_string_field(8, name, out)
    if changed:
        write_varint_field(9, 1, out)
    for ann in node.clade_annotations:
        write_string_field(10, ann, out)
    if node.branch_length:
        write_packed_float_field(11, [float(node.branch_length)], out)
    return bytes(out)


def save_detailed_mutations(T: Tree, path: str,
                            changed_ids: set[str] | None = None) -> None:
    """Write the checkpoint (save_detailed_mutations,
    detailed_mutations_store.cpp:279-296).  Atomic via .tmp + rename
    (reference mkstemps + rename, matOptimize/main.cpp:264-273)."""
    changed_ids = changed_ids or set()
    chroms, chrom_idx = _chrom_table(T)

    # reference genome vector indexed by position (Mutation::refs)
    max_pos = 0
    for n in T.depth_first_expansion():
        for m in n.mutations:
            max_pos = max(max_pos, m.position)
    refs = [0] * (max_pos + 1)
    for n in T.depth_first_expansion():
        for m in n.mutations:
            if m.position >= 0:
                refs[m.position] = m.ref_nuc & 0xF

    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        w = _BlockWriter(f)
        # children-first: iterative postorder with (offset, length) results
        results: dict[int, tuple[int, int]] = {}  # id(node) -> (off, len)
        node_ids: dict[int, int] = {}
        name_map: list[tuple[int, str]] = []
        next_id = 0
        stack: list[tuple[Node, bool]] = [(T.root, False)]
        while stack:
            node, expanded = stack.pop()
            if not expanded:
                stack.append((node, True))
                for ch in reversed(node.children):
                    stack.append((ch, False))
                continue
            nid = next_id
            next_id += 1
            node_ids[id(node)] = nid
            name_map.append((nid, node.identifier))
            offs = [results[id(c)][0] for c in node.children]
            lens = [results[id(c)][1] for c in node.children]
            data = _encode_node(node, nid, T, chrom_idx, offs, lens,
                                node.identifier in changed_ids)
            results[id(node)] = (w.append(data), len(data))

        root_off, root_len = results[id(T.root)]
        meta = bytearray()
        write_packed_int32_field(1, refs, meta)
        write_varint_field(2, next_id, meta)
        for c in chroms:
            write_string_field(3, c, meta)
        write_varint_field(4, root_off, meta)
        write_varint_field(5, root_len, meta)
        for nid, name in name_map:
            entry = bytearray()
            write_varint_field(1, nid, entry)
            write_string_field(2, name, entry)
            write_bytes_field(6, bytes(entry), meta)
        meta_off = w.append(bytes(meta))
        w.append(struct.pack("<Q", meta_off))
        w.finalize()
    os.replace(tmp, path)


def _decompress_blocks(raw: bytes) -> bytes:
    """Decompress all blocks into the contiguous uncompressed stream; blocks
    decompress concurrently (reference's TBB-pipelined parallel load)."""
    total = struct.unpack("<Q", raw[-8:])[0]
    blocks = []  # (uncompressed_offset, compressed bytes)
    pos = 0
    end = len(raw) - 8
    while pos < end:
        off, csize = struct.unpack_from("<QQ", raw, pos)
        pos += 16
        blocks.append((off, raw[pos:pos + csize]))
        pos += csize
    out = bytearray(total)
    def _one(args):
        off, comp = args
        data = zlib.decompress(comp)
        out[off:off + len(data)] = data
    if len(blocks) > 1:
        with ThreadPoolExecutor(max_workers=min(8, len(blocks))) as ex:
            list(ex.map(_one, blocks))
    elif blocks:
        _one(blocks[0])
    return bytes(out)


def _parse_meta(buf: bytes, start: int, end: int):
    refs: list[int] = []
    chroms: list[str] = []
    names: dict[int, str] = {}
    root_off = root_len = 0
    for fn, wt, val in iter_fields(buf, start, end):
        if fn == 1:
            refs = decode_packed_int32(val)
        elif fn == 3:
            chroms.append(bytes(val).decode())
        elif fn == 4:
            root_off = val
        elif fn == 5:
            root_len = val
        elif fn == 6:
            nid, name = 0, ""
            for f2, w2, v2 in iter_fields(val):
                if f2 == 1:
                    nid = v2
                elif f2 == 2:
                    name = bytes(v2).decode()
            names[nid] = name
    return refs, chroms, names, root_off, root_len


def load_detailed_mutations(path: str):
    """Load a checkpoint; returns (Tree, changed_ids set)
    (detailed_mutations_load.cpp)."""
    with open(path, "rb") as f:
        raw = f.read()
    buf = _decompress_blocks(raw)
    meta_off = struct.unpack("<Q", buf[-8:])[0]
    refs, chroms, names, root_off, root_len = _parse_meta(
        buf, meta_off, len(buf) - 8)
    if not chroms:
        chroms = [""]

    T = Tree()
    changed_ids: set[str] = set()

    def parse_node(off: int, length: int, parent: Node | None):
        """Parse one node message, attach under parent, return (node,
        child (offset,length) list) — called from an explicit stack so deep
        chains can't overflow the interpreter stack."""
        positions: list[int] = []
        other: list[int] = []
        child_offs: list[int] = []
        child_lens: list[int] = []
        condensed: list[str] = []
        annotations: list[str] = []
        nid = 0
        changed = 0
        branch_len = 0.0
        for fn, wt, val in iter_fields(buf, off, off + length):
            if fn == 1:
                positions = decode_packed_int32(val)
            elif fn == 2:
                other = _decode_packed_fixed32(val)
            elif fn == 5:
                nid = val
            elif fn == 6:
                pos2 = 0
                pay = bytes(val)
                while pos2 < len(pay):
                    v, pos2 = decode_varint(pay, pos2)
                    child_offs.append(v)
            elif fn == 7:
                child_lens = decode_packed_int32(val)
            elif fn == 8:
                condensed.append(bytes(val).decode())
            elif fn == 9:
                changed = val
            elif fn == 10:
                annotations.append(bytes(val).decode())
            elif fn == 11:
                from .proto_wire import decode_packed_float
                vals = decode_packed_float(val)
                if vals:
                    branch_len = vals[0]
        name = names.get(nid, f"node_{nid}")
        node = T.create_node(name, parent, branch_len)
        node.clade_annotations = annotations
        for p, o in zip(positions, other):
            par_mut = (o >> 8) & 0xFF
            m = Mutation(chrom=chroms[o & 0xFF] if (o & 0xFF) < len(chroms)
                         else chroms[0],
                         position=p,
                         ref_nuc=refs[p] if 0 <= p < len(refs) else 0,
                         par_nuc=(par_mut >> 4) & 0xF,
                         mut_nuc=par_mut & 0xF)
            node.mutations.append(m)
        if condensed:
            T.condensed_nodes[name] = condensed
            for s in condensed:
                T.condensed_leaves.add(s)
        if changed:
            changed_ids.add(name)
        return node, list(zip(child_offs, child_lens))

    root, root_children = parse_node(root_off, root_len, None)
    stack = [(coff, clen, root) for coff, clen in reversed(root_children)]
    while stack:
        coff, clen, parent = stack.pop()
        node, kids = parse_node(coff, clen, parent)
        for coff2, clen2 in reversed(kids):
            stack.append((coff2, clen2, node))
    return T, changed_ids


def is_detailed_checkpoint(path: str) -> bool:
    """Sniff: a detailed checkpoint starts with a block header whose
    uncompressed_start_offset is 0 and whose compressed payload starts with
    a zlib magic byte (0x78)."""
    try:
        with open(path, "rb") as f:
            head = f.read(17)
    except OSError:
        return False
    if len(head) < 17:
        return False
    off, csize = struct.unpack_from("<QQ", head, 0)
    return off == 0 and csize > 0 and head[16] == 0x78
