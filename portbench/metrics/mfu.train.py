"""The train step's model FLOPs (`work.model_flops` of one window's forward
over the batch's rows, no TTA, x S windows, x 3 for the forward and the
backward) over the traced window's mean step time, as a share of the
card's dense peak in the compute dtype (%)."""
from portbench import work


def read(run):
    rec, cell = run.rec, run.cell
    if rec.kind != "train" or rec.trace is None or not rec.steps:
        return None
    m, t = cell.config["model"], cell.traffic
    forward = sum(f for _, f in work.model_flops(
        m, t["batch"], t["points"], cell.config["with_refine"]))
    flops = 3.0 * t["windows"] * forward
    step_s = rec.window_s / rec.steps
    return 100.0 * flops / step_s / work.PEAK_FLOP_PER_S[m["compute_dtype"]]
