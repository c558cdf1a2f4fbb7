"""100 x (1 - union of the device's busy intervals / traced window), over
train steps (%)."""


def read(run):
    rec = run.rec
    if rec.kind != "train" or rec.trace is None:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
