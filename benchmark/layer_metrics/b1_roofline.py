"""Share of its roofline that B1 (`csrc/placement_sparse.cu`,
`score_entries_kernel`, the fused launch of `score_sparse_stp_T`) reaches:
the least time the bytes its launches' shapes need take at the card's
published bandwidth (`bounds.py`), over the profiler's device time of those
launches.  B1 is bound by its bytes at these shapes."""

from benchmark.bounds import HBM_BYTES_PER_S, b1_fused_bytes


def read(run):
    rec = run.rec
    shapes = rec.calls.get("b1", [])
    if rec.trace is None or not shapes:
        return None
    ops = rec.trace.launched_in("b1", "score_entries_kernel")
    if len(ops) != len(shapes):
        return None
    need = sum(b1_fused_bytes(N, P, B, K) for (N, P), (B, K) in shapes)
    took = sum(d for _, _, d, _ in ops) / 1e6
    return 100.0 * need / HBM_BYTES_PER_S / took
