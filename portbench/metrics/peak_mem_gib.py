"""`torch.cuda.max_memory_allocated` over the window, reset at its start,
less the benchmark's own capture buffers (GiB)."""


def read(run):
    return run.rec.peak_bytes / 2 ** 30 if run.rec.peak_bytes else None
