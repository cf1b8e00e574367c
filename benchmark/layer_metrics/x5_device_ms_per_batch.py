"""Device milliseconds a batch's scoring takes: every device operation
launched inside `BigMAT.place_arrays_begin` or `place_arrays_finish` (X5,
`ops/interval.py`), from the profiler's trace."""


def read(run):
    rec = run.rec
    batches = rec.count("scoring_begin")
    if rec.trace is None or not batches:
        return None
    ops = (rec.trace.launched_in("scoring_begin")
           + rec.trace.launched_in("scoring_finish"))
    if not ops:
        return None
    return sum(d for _, _, d, _ in ops) / 1e3 / batches
