"""Window time over every frame completed in the window, all streams
counted (ms a frame)."""


def read(run):
    rec = run.rec
    if rec.kind != "eval" or not rec.frames:
        return None
    return 1e3 * rec.window_s / rec.frames
