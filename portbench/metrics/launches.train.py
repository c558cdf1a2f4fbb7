"""Kernels, copies and fills on the device per train step of the traced
window."""


def read(run):
    rec = run.rec
    if rec.kind != "train" or rec.trace is None or not rec.steps:
        return None
    return len(rec.trace.device) / rec.steps
