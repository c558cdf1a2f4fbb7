"""Device time a train step spends in NCCL's kernels on rank 0 (ms): every
device interval of the traced window whose kernel name starts with
``nccl``, over the window's steps. None outside a traced data-parallel
run."""


def read(run):
    rec = run.rec
    if (rec.kind != "train" or rec.trace is None or not rec.steps
            or getattr(rec, "world", 1) < 2):
        return None
    busy = sum(b - a for a, b, name in rec.trace.device
               if name.lower().startswith("nccl"))
    return busy / 1e3 / rec.steps
