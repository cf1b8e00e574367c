"""Milliseconds a request spends copying the loaded tree
(`core/tree.py::Tree.copy`, the daemon's stand-in for the reference's fork
per connection), timed from outside."""


def read(run):
    rec = run.rec
    if not rec.units or "copy" not in rec.spans:
        return None
    return rec.seconds("copy") * 1e3 / len(rec.units)
