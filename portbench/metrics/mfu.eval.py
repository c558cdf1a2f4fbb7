"""The model's forward FLOPs a step (`work.model_flops`: four TTA rows a
stream) over the traced window's mean step time, as a share of the card's
dense peak in the compute dtype (%)."""
from portbench import work


def read(run):
    rec, cell = run.rec, run.cell
    if rec.kind != "eval" or rec.trace is None or not rec.steps:
        return None
    m = cell.config["model"]
    rows = 4 * cell.traffic["streams"]
    flops = sum(f for _, f in work.model_flops(
        m, rows, cell.traffic["points"], cell.config["with_refine"]))
    step_s = rec.window_s / rec.steps
    return 100.0 * flops / step_s / work.PEAK_FLOP_PER_S[m["compute_dtype"]]
