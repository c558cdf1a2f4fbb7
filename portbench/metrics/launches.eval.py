"""Kernels, copies and fills on the device per step of the traced window."""


def read(run):
    rec = run.rec
    if rec.kind != "eval" or rec.trace is None or not rec.steps:
        return None
    return len(rec.trace.device) / rec.steps
