"""Milliseconds a sample spends in the Tree driver's host corrections and
surgery: the program's span `placement:apply_batch`
(`placement/driver.py::run_usher`)."""


def read(run):
    rec = run.rec
    spans = rec.program_spans.get("placement:apply_batch")
    if not spans or not rec.samples:
        return None
    return sum(spans) * 1e3 / rec.samples
