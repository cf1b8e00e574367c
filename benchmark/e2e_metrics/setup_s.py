"""Seconds from process start to the start of the window: CUDA start,
the program's imports and builds (the native scanner, the CUDA kernels),
its set-up and the warm-up unit.  Making or loading the inputs is left
out; the run prints that time on an earlier line."""


def read(run):
    return run.setup_s
