"""Samples placed by the units the window finished, over the time from the
start of the window to the last finish."""


def read(run):
    rec = run.rec
    if not rec.units or rec.window_s <= 0:
        return None
    return rec.samples / rec.window_s
