"""Mean host time of one `eval_step` call in the traced window, from call
to return, before any wait on the device (ms)."""


def read(run):
    spans = run.rec.host_spans_s
    if run.rec.kind != "eval" or not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
