"""Share of the traced window in which no operation ran on the device:
100 x (1 - the union of device activity / the window)."""


def read(run):
    rec = run.rec
    if rec.trace is None or rec.window_s <= 0 or not rec.trace.device:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s() / rec.window_s)
