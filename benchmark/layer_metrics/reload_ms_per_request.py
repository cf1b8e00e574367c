"""Milliseconds a request spends reloading the tree that the previous one
consumed (`MatStore._load`, `cli/usher_server_cli.py`), timed from
outside."""


def read(run):
    rec = run.rec
    if not rec.units or "load_pb" not in rec.spans:
        return None
    return rec.seconds("load_pb") * 1e3 / len(rec.units)
