"""New samples of a day's batch, and the VCF a job or request reads.

A batch is made of clades shaped as the batch of UShER's own Quick Start
(test/new_samples.vcf onto the tree of test/global_phylo.nh): the members
of a clade descend from one node of the tree and share a ladder of novel
substitutions, member j carrying the first `clade_ladder[j]` of them, and
come one after another in the VCF.  On top, each sample gets private
substitutions and N calls, as many as the histograms `private_substitutions`
and `n_calls` draw (weights by count, from 0 up).  A clade's node is the
parent of a uniformly drawn leaf: the clades land where the tree's own
samples do.  (`chip_smoke.py::write_samples_vcf` at commit f18dcaca4b2a
draws a node's genotype with 2 new substitutions and 2 N calls.)  A sample
is a sparse genotype: sorted site columns and one-hot alleles, 15 for N.
"""

from __future__ import annotations

import numpy as np

from .mat import NIBBLES
from .pbwrite import CHROM

N_CALL = 15
CHARS = np.array(list("?AC?G???T??????N"))


def _counts(rng, weights, k: int) -> np.ndarray:
    w = np.asarray(weights, np.float64)
    return rng.choice(len(w), size=k, p=w / w.sum())


def node_states(mat: dict, nodes: np.ndarray) -> list[dict]:
    """Each node's genotype as {column: allele} at the sites where it
    differs from the reference."""
    parent, ptr = mat["parent"], mat["mut_ptr"]
    col, mut, ref = mat["mut_col"], mat["mut_mut"], mat["ref"]
    b_all, s_all, c_all, m_all = [], [], [], []
    cur = np.asarray(nodes, np.int64).copy()
    rows = np.arange(len(cur))
    step = 0
    while True:
        live = cur != 0
        if not live.any():
            break
        lo, hi = ptr[cur[live]], ptr[cur[live] + 1]
        for j in range(int((hi - lo).max())):
            ok = lo + j < hi
            k = (lo + j)[ok]
            b_all.append(rows[live][ok])
            s_all.append(np.full(len(k), step))
            c_all.append(col[k])
            m_all.append(mut[k])
        cur = np.where(live, parent[cur], 0)
        step += 1
    out = [dict() for _ in rows]
    if not b_all:
        return out
    b, s, c, m = (np.concatenate(a) for a in (b_all, s_all, c_all, m_all))
    order = np.lexsort((s, c, b))
    b, c, m = b[order], c[order], m[order]
    first = np.r_[True, (b[1:] != b[:-1]) | (c[1:] != c[:-1])]
    keep = first & (m != ref[c])
    for bi, ci, mi in zip(b[keep].tolist(), c[keep].tolist(),
                          m[keep].tolist()):
        out[bi][ci] = mi
    return out


def _substitute(rng, state: dict, ref, c: int) -> int:
    cur = state.get(c, int(ref[c]))
    i = (int(np.searchsorted(NIBBLES, cur)) + int(rng.integers(1, 4))) % 4
    return int(NIBBLES[i])


def _novel_sites(rng, P: int, k: int, taken: set) -> list:
    out = []
    while len(out) < k:
        c = int(rng.integers(0, P))
        if c not in taken:
            taken.add(c)
            out.append(c)
    return out


def draw_job(rng, mat: dict, t: dict, size: int, prefix: str) -> dict:
    """One job's samples: names, and the CSR (ptr, col, nuc) of their
    entries (non-reference alleles and N calls, sorted by column)."""
    ref = mat["ref"]
    P = len(ref)
    ladder = t["clade_ladder"]
    n_cl = -(-size // len(ladder))
    leaves = np.nonzero(mat["is_leaf"])[0]
    src = mat["parent"][rng.choice(leaves, size=n_cl)].astype(np.int64)
    n_priv = _counts(rng, t["private_substitutions"], size)
    n_n = _counts(rng, t["n_calls"], size)
    states = node_states(mat, src)
    ptr, cols, nucs, source, shared = [0], [], [], [], []
    for c in range(n_cl):
        taken: set = set()
        novel, g0 = [], dict(states[c])
        for s in _novel_sites(rng, P, max(ladder), taken):
            g0[s] = _substitute(rng, g0, ref, s)
            novel.append((s, g0[s]))
        for j, depth in enumerate(ladder):
            b = len(source)
            if b == size:
                break
            g = dict(states[c])
            g.update(novel[:depth])
            mine = set(taken)
            for s in _novel_sites(rng, P, int(n_priv[b]), mine):
                g[s] = _substitute(rng, g, ref, s)
            for s in _novel_sites(rng, P, int(n_n[b]), mine):
                g[s] = N_CALL
            ent = sorted((s, a) for s, a in g.items() if a != ref[s])
            cols.extend(s for s, _ in ent)
            nucs.extend(a for _, a in ent)
            ptr.append(len(cols))
            source.append(src[c])
            shared.append(depth)
    return dict(names=[f"{prefix}_{i}" for i in range(size)],
                ptr=np.array(ptr, np.int64), col=np.array(cols, np.int32),
                nuc=np.array(nucs, np.uint8), source=np.array(source),
                shared=np.array(shared), private=n_priv, missing=n_n)


def write_vcf(path: str, job: dict, mat: dict) -> int:
    """The job's VCF: every site where one of its samples differs from the
    reference, GT codes by allele in ACGT order, `.` for N.  Returns the
    number of sites."""
    ref, positions = mat["ref"], mat["positions"]
    B = len(job["names"])
    sample = np.repeat(np.arange(B), np.diff(job["ptr"]))
    sites, site_of = np.unique(job["col"], return_inverse=True)
    G = np.repeat(ref[sites][:, None], B, axis=1)
    G[site_of, sample] = job["nuc"]
    present = np.stack([(G == a).any(1) for a in NIBBLES], 1)
    present &= NIBBLES[None, :] != ref[sites][:, None]
    alt_rank = np.cumsum(present, 1)                 # code of each allele
    code = np.full(G.shape, ord("0"), np.uint8)
    for i, a in enumerate(NIBBLES):
        code[G == a] = ord("0") + alt_rank[:, i][np.nonzero(G == a)[0]]
    code[G == ref[sites][:, None]] = ord("0")
    code[G == N_CALL] = ord(".")
    line = np.full((len(sites), 2 * B), ord("\t"), np.uint8)
    line[:, 0::2] = code
    line[:, -1] = ord("\n")
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                "FILTER\tINFO\tFORMAT\t" + "\t".join(job["names"]) + "\n")
        for i, c in enumerate(sites.tolist()):
            alts = ",".join(CHARS[a] for a in NIBBLES[present[i]]) or "."
            f.write(f"{CHROM}\t{positions[c]}\t.\t{CHARS[ref[c]]}\t{alts}"
                    "\t.\t.\t.\tGT\t")
            f.write(line[i].tobytes().decode())
    return len(sites)
