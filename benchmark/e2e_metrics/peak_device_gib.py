"""torch.cuda.max_memory_allocated() over the whole run (reset at its
start), read once the window has closed, in GiB."""


def read(run):
    if not run.peak_bytes:
        return None
    return run.peak_bytes / (1 << 30)
