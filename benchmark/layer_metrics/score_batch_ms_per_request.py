"""Milliseconds a request spends in the engine's scoring calls, the
device's B1 and gather with the host's copy-back and tie-break: the
program's span `placement:score_batch` (`PlacementEngine.score_samples`)."""


def read(run):
    rec = run.rec
    spans = rec.program_spans.get("placement:score_batch")
    if not spans or not rec.units:
        return None
    return sum(spans) * 1e3 / len(rec.units)
