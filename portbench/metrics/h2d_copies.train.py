"""Tensors built on the host that the program copies to the device a train
step: the program's ``h2d.copies`` counter over its ``train.steps``
counter, both since the process started (set-up, warm-up and window steps
alike; on the card each copy is one pageable host-to-device copy). None
where the program keeps no such counters."""


def read(run):
    if run.rec.kind != "train":
        return None
    try:
        from streammos_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    counts = counters()
    if not counts.get("train.steps"):
        return None
    return counts.get("h2d.copies", 0) / counts["train.steps"]
