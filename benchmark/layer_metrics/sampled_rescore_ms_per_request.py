"""Milliseconds a request spends in the one-sample scoring calls that
`placement/sampled.py::place_batch` makes for its stale samples (whole-tree
`PlacementEngine.score_samples` calls of one sample inside place_batch),
timed from outside."""


def read(run):
    rec = run.rec
    calls = rec.calls.get("score")
    if not rec.units or not calls or "place_batch" not in rec.spans:
        return None
    ms = sum(s for n, inside, s in calls if n == 1 and inside) * 1e3
    return ms / len(rec.units)
