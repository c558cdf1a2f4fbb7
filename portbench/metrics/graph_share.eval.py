"""Share of the eval steps replayed from CUDA graphs: the program's
``graph.replays`` counter over its ``smt.steps`` counter, both since the
process started (set-up, warm-up and window steps alike; the first step of
a stream runs eagerly). None where the program keeps no such counters or
has no CUDA graphs of its eval step (`streammos_tpu_torch/utils/graphs.py`)."""


def read(run):
    if run.rec.kind != "eval":
        return None
    try:
        from streammos_tpu_torch.utils import graphs  # noqa: F401
        from streammos_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    counts = counters()
    if not counts.get("smt.steps"):
        return None
    return counts.get("graph.replays", 0) / counts["smt.steps"]
