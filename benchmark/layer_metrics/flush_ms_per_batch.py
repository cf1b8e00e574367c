"""Host milliseconds a batch spends applying the previous batch's
placements to the BigMAT's arrays (`core/bigmat.py::BigMAT._flush`, called
at the top of each scoring call and before the writers), timed from
outside."""


def read(run):
    rec = run.rec
    batches = rec.count("scoring_begin")
    if not batches or "flush" not in rec.spans:
        return None
    return rec.seconds("flush") * 1e3 / batches
