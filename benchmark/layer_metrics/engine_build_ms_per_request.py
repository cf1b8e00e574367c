"""Milliseconds a request spends building its `PlacementEngine`
(`placement/driver.py`: the FlatMAT over the request's copy of the tree),
timed from outside."""


def read(run):
    rec = run.rec
    if not rec.units or "flat_build" not in rec.spans:
        return None
    return rec.seconds("flat_build") * 1e3 / len(rec.units)
