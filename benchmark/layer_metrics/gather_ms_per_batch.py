"""Device milliseconds of the `stp = st[parent]` gather of a batch's
scoring call (`ops/placement.py::parent_states`, reached through
`ops/placement_sparse.py::score_sparse_T`), from the profiler's trace."""


def read(run):
    rec = run.rec
    calls = rec.count("gather")
    if rec.trace is None or not calls:
        return None
    ops = rec.trace.launched_in("gather")
    if not ops:
        return None
    return sum(d for _, _, d, _ in ops) / 1e3 / calls
