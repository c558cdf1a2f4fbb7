"""95th percentile (linear interpolation) of the latencies of every frame
of the window: from handing its points over to its labels in host memory
(ms)."""
import numpy as np


def read(run):
    rec = run.rec
    if rec.kind != "eval" or not rec.latencies_s:
        return None
    return 1e3 * float(np.percentile(rec.latencies_s, 95))
