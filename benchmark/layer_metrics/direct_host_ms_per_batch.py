"""Host milliseconds a batch spends in `DirectPlacer`'s corrections and
surgery (`_BatchState.resolve` and `apply_placement`), timed from outside."""


def read(run):
    rec = run.rec
    batches = rec.count("scoring_begin")
    if not batches or not {"resolve", "apply"} <= set(rec.spans):
        return None
    return (rec.seconds("resolve") + rec.seconds("apply")) * 1e3 / batches
