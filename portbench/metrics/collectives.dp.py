"""Data-parallel collectives a train step issues on rank 0: the program's
``dp.collectives`` counter over the window (read at its start and end, so
set-up's broadcasts and the warm-up are left out), over the window's
steps. None outside a data-parallel run, or where the program keeps no
such counter."""


def read(run):
    rec = run.rec
    counts = getattr(rec, "counts", None)
    if rec.kind != "train" or not counts or not rec.steps:
        return None
    start, end = counts
    if "dp.collectives" not in end:
        return None
    return (end["dp.collectives"] - start.get("dp.collectives", 0)) / rec.steps
