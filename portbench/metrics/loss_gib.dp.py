"""Device memory the global-batch loss holds for the backward (GiB): the
program's ``train.loss_bytes`` counter (on a card, the bytes each window's
loss, over the gathered batch, allocates and still holds after its span)
over its ``train.steps`` counter, both since the process started, on rank
0. None where the program keeps no such counter, or ran off a card."""


def read(run):
    if run.rec.kind != "train":
        return None
    try:
        from streammos_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    counts = counters()
    if not counts.get("train.steps") or "train.loss_bytes" not in counts:
        return None
    return counts["train.loss_bytes"] / counts["train.steps"] / 2 ** 30
