"""Milliseconds a request spends writing its outputs: the program's span
`placement:write_outputs` (`placement/driver.py::_write_outputs`)."""


def read(run):
    rec = run.rec
    spans = rec.program_spans.get("placement:write_outputs")
    if not spans or not rec.units:
        return None
    return sum(spans) * 1e3 / len(rec.units)
