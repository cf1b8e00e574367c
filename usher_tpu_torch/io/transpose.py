"""Transposed-VCF codec: sample-major compressed genotypes.

On-disk format identical to the reference
(src/matOptimize/transpose_vcf/transposed_vcf.md + transpose_vcf.hpp:28-78):
zlib blocks framed by u32 length; per sample: name, varint-packed called
mutations (two alleles per byte), varint N ranges.  Uses the compiled
codec (native/) where it is built; the pure-Python one otherwise.
"""

from __future__ import annotations

import struct
import zlib


# --- pure-Python codec (fallback + oracle) -----------------------------------

def _write_varint(buf: bytearray, v: int) -> None:
    while v >= 0x80:
        buf.append((v & 0x7F) | 0x80)
        v >>= 7
    buf.append(v)


def _read_varint(data: bytes, i: int) -> tuple[int, int]:
    out = data[i] & 0x7F
    shamt = 7
    while data[i] & 0x80:
        i += 1
        out |= (data[i] & 0x7F) << shamt
        shamt += 7
    return out, i + 1


def _encode_py(samples, path: str, append: bool = False) -> None:
    raw = bytearray()
    for name, muts, nranges in samples:
        raw += name.encode()
        raw.append(0)
        for k in range(0, len(muts) - 1, 2):
            (p1, a1), (p2, a2) = muts[k], muts[k + 1]
            _write_varint(raw, p1)
            _write_varint(raw, p2)
            raw.append(((a2 & 0xF) << 4) | (a1 & 0xF))
        if len(muts) & 1:
            p1, a1 = muts[-1]
            _write_varint(raw, p1)
            raw.append(a1 & 0xF)
        raw.append(0)
        for start, end in nranges:
            _write_varint(raw, end)
            if start < end:
                _write_varint(raw, start)
        raw.append(0)
    comp = zlib.compress(bytes(raw))
    with open(path, "ab" if append else "wb") as f:
        f.write(struct.pack("<I", len(comp)))
        f.write(comp)


def _decode_py(path: str):
    out = []
    with open(path, "rb") as f:
        while True:
            hdr = f.read(4)
            if len(hdr) < 4:
                break
            (length,) = struct.unpack("<I", hdr)
            comp = f.read(length)
            data = zlib.decompress(comp)
            i = 0
            n = len(data)
            while i < n:
                j = data.index(0, i)
                name = data[i:j].decode()
                i = j + 1
                muts = []
                while data[i]:
                    p1, i = _read_varint(data, i)
                    if data[i + 1]:
                        p2, i = _read_varint(data, i)
                        muts.append((p1, data[i] & 0xF))
                        muts.append((p2, (data[i] >> 4) & 0xF))
                    else:
                        muts.append((p1, data[i] & 0xF))
                    i += 1
                i += 1
                nranges = []
                while data[i]:
                    first, i = _read_varint(data, i)
                    after_first = i
                    if not data[i]:
                        nranges.append((first, first))
                        break
                    second, i = _read_varint(data, i)
                    if first > second:
                        nranges.append((second, first))
                    else:
                        nranges.append((first, first))
                        i = after_first
                i += 1
                out.append((name, muts, nranges))
    return out


def encode(samples, path: str, append: bool = False) -> None:
    """samples: iterable of (name, [(pos, allele_nibble)], [(start, end)])."""
    samples = [(n, list(m), list(r)) for n, m, r in samples]
    from ..native import ext, HAVE_NATIVE
    if HAVE_NATIVE:
        ext.transpose_encode(samples, path, append)
    else:
        _encode_py(samples, path, append)


def decode(path: str):
    from ..native import ext, HAVE_NATIVE
    if HAVE_NATIVE:
        return [(n, [(int(p), int(a)) for p, a in m],
                 [(int(s), int(e)) for s, e in r])
                for n, m, r in ext.transpose_decode(path)]
    return _decode_py(path)


# --- conversions --------------------------------------------------------------

def samples_from_vcf(vcf) -> list:
    """VcfData -> transposed sample records. N entries merge into ranges of
    consecutive segregating positions (the reference records per-position Ns
    from the VCF as 1-length ranges; adjacent ones merge)."""
    from ..core.nuc import N as NUC_N
    per_sample_muts: dict[int, list] = {}
    per_sample_ns: dict[int, list] = {}
    for site in vcf.sites:
        for col, nuc in site.variants:
            if nuc == NUC_N:
                per_sample_ns.setdefault(col, []).append(site.position)
            else:
                per_sample_muts.setdefault(col, []).append(
                    (site.position, int(nuc)))
    out = []
    for col, name in enumerate(vcf.sample_ids):
        muts = sorted(per_sample_muts.get(col, []))
        npos = sorted(per_sample_ns.get(col, []))
        nranges = []
        for p in npos:
            if nranges and p == nranges[-1][1] + 1:
                nranges[-1] = (nranges[-1][0], p)
            else:
                nranges.append((p, p))
        out.append((name, muts, nranges))
    return out


def encode_vcf(vcf_path: str, out_path: str, append: bool = False) -> int:
    from .vcf import read_vcf_sites
    vcf = read_vcf_sites(vcf_path)
    encode(samples_from_vcf(vcf), out_path, append)
    return len(vcf.sample_ids)
