"""Device memory a train step holds for its backward (GiB): the program's
``train.saved_bytes`` counter (each step's bytes allocated by the forward
and the loss of its S windows and still held when the backward starts)
over its ``train.steps`` counter, both since the process started. None
where the program keeps no such counter, or ran off a card."""


def read(run):
    if run.rec.kind != "train":
        return None
    try:
        from streammos_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    counts = counters()
    if not counts.get("train.steps") or "train.saved_bytes" not in counts:
        return None
    return counts["train.saved_bytes"] / counts["train.steps"] / 2 ** 30
