"""Window time over every train step completed in the window (s a step)."""


def read(run):
    rec = run.rec
    if rec.kind != "train" or not rec.steps:
        return None
    return rec.window_s / rec.steps
