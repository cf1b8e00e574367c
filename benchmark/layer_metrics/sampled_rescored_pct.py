"""One-sample scoring calls that `placement/sampled.py::place_batch` makes
for its stale samples, as a share of the samples placed in the window:
100 x calls / samples (a sample scored again twice counts twice)."""


def read(run):
    rec = run.rec
    calls = rec.calls.get("score")
    if not rec.samples or not calls or "place_batch" not in rec.spans:
        return None
    n = sum(1 for k, inside, _ in calls if k == 1 and inside)
    return 100.0 * n / rec.samples
