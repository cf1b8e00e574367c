"""Milliseconds a request spends building the `PlacementEngine`'s FlatMAT:
the program's span `placement:flat_build` (`core/flat.py`)."""


def read(run):
    rec = run.rec
    spans = rec.program_spans.get("placement:flat_build")
    if not spans or not rec.units:
        return None
    return sum(spans) * 1e3 / len(rec.units)
