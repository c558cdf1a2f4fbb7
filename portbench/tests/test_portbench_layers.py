"""`layers.py`: the traced window by layer of the eval step. On synthetic
Chrome traces (nested spans, correlated launches, overlapping intervals,
gaps across span edges) the buckets sum to the busy and the idle time
exactly; the program's spans leave `tracing.reduce` and the readers as
they were. On the card (``python -m pytest --noconftest -m cuda
portbench/tests``): one production-width eval step, traced."""
from __future__ import annotations

import json

import pytest

import tinycells  # noqa: F401  (the checkout's root on the path)
from portbench import layers, loops, manifest, tracing
from portbench.run import Run


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": float(ts),
         "dur": float(dur)}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


SPANS = [("smt.input", 2, 8), ("smt.step", 10, 90),
         ("smt.featurize", 12, 20), ("smt.scatter.rv0", 20, 40),
         ("smt.encoder.header", 45, 70), ("smt.attention", 50, 60)]
# (launch time, device start, device end, name); correlation = index + 1
LAUNCHED = [(3, 5, 15, "Memcpy HtoD (Pageable -> Device)"),  # hand-over
            (13, 12, 25, "k_featurize"),   # overlaps the copy by 3
            (30, 35, 50, "k_scatter"),     # runs past its span
            (55, 55, 58, "k_attention"),   # inside the header's span
            (65, 66, 75, "k_header"),
            (92, 95, 105, "k_after"),      # past the window's end
            (21, 26, 27, "Memcpy HtoD (Pageable -> Device)")]


def _events(spans=True):
    """A window [0, 100) us: SPANS, LAUNCHED, and one device interval
    [80, 82) whose launch the trace lacks."""
    ev = [_x("user_annotation", tracing.WINDOW, 0, 100)]
    if spans:
        ev += [_x("user_annotation", n, a, b - a) for n, a, b in SPANS]
    for i, (t, a, b, name) in enumerate(LAUNCHED):
        runtime = ("cudaMemcpyAsync" if name.startswith("Memcpy")
                   else "cudaLaunchKernel")
        ev.append(_x("cuda_runtime", runtime, t, 1, i + 1))
        ev.append(_x("gpu_memcpy" if name.startswith("Memcpy") else "kernel",
                     name, a, b - a, i + 1))
    ev.append(_x("kernel", "k_lost", 80, 2, 99))
    ev.append(_x("cpu_op", "aten::copy_", 84, 3))
    return ev


def test_flatten_labels_the_innermost_span():
    flat = layers.flatten([(a, b, n) for n, a, b in SPANS])
    assert flat == [(2, 8, "smt.input"), (10, 12, "smt.step"),
                    (12, 20, "smt.featurize"), (20, 40, "smt.scatter.rv0"),
                    (40, 45, "smt.step"), (45, 50, "smt.encoder.header"),
                    (50, 60, "smt.attention"), (60, 70, "smt.encoder.header"),
                    (70, 90, "smt.step")]
    # a child that outlasts its parent is cut at the parent's end
    assert layers.flatten([(0, 10, "smt.step"), (5, 11, "smt.heads")]) == [
        (0, 5, "smt.step"), (5, 10, "smt.heads")]
    assert [layers.bucket(n) for n in ("smt.step", "smt.input",
                                       "smt.heads.scores", "smt.gather.rv1",
                                       "other")] == [
        "loop", "loop", "heads", "gather", "loop"]


def test_attribution_sums_to_busy_and_idle():
    lay = layers.attribute(_events())
    s = tracing.reduce(_events())
    # busy: [5,25) [26,27) [35,50) [55,58) [66,75) [80,82) [95,100)
    assert s.busy_s == pytest.approx(55e-6)
    assert lay.device_us == pytest.approx({
        "smt.input": 10.0,             # the hand-over copy
        "loop": 7.0,                   # k_lost, k_after
        "smt.featurize": 10.0,         # k_featurize less its overlap
        "smt.scatter.rv0": 16.0,       # k_scatter and the copy it launched
        "smt.attention": 3.0, "smt.encoder.header": 9.0})
    assert lay.idle_us == pytest.approx({
        "smt.input": 3.0, "loop": 7.0, "smt.scatter.rv0": 9.0,
        "smt.attention": 7.0, "smt.encoder.header": 6.0, "smt.step": 13.0})
    assert sum(lay.device_us.values()) == pytest.approx(1e6 * s.busy_s)
    assert sum(lay.idle_us.values()) == pytest.approx(
        1e6 * (s.window_s - s.busy_s))
    assert lay.by_bucket(lay.device_us)["loop"] == pytest.approx(17.0)
    assert lay.by_bucket(lay.idle_us) == pytest.approx(dict(
        featurize=0.0, point_mlp=0.0, scatter=9.0, gather=0.0, encoder=6.0,
        attention=7.0, heads=0.0, loop=23.0))
    assert (lay.steps, lay.device_events, lay.unmatched) == (1, 8, 1)
    assert layers.launched_inside(lay, "smt.step", "Memcpy HtoD") == 1
    out = layers.summary(lay, 1)
    assert out["device_ms_sum"] == pytest.approx(55e-3)
    assert out["metrics"]["device_ms.scatter"] == pytest.approx(16e-3)
    assert set(out["metrics"]) == {f"{k}_ms.{b}" for k in ("device", "idle")
                                   for b in layers.BUCKETS}


def test_spans_leave_the_summary_and_readers_as_they_were():
    cell = manifest.resolve(manifest.load_manifest(), "seg_eval_1s")
    plain, marked = tracing.reduce(_events(False)), tracing.reduce(_events())
    assert marked.device == plain.device
    assert (marked.busy_s, marked.window_s) == (plain.busy_s, plain.window_s)
    assert [d for d, _ in marked.gaps] == [d for d, _ in plain.gaps]
    header = _x("kernel", "header_bf16_kernel", 60, 2)
    values = []
    for events in (_events(False), _events()):
        s = tracing.reduce(events + [header])
        rec = loops.Record("eval", frames=2, steps=2, window_s=1e-4,
                           host_spans_s=[3e-5, 4e-5], trace=s)
        run = Run(cell, rec, 1.0)
        values.append({m: manifest.reader(m)(run) for m in (
            "host_ms.eval", "launches.eval", "idle_share.eval", "mfu.eval",
            "header_roofline.bf16")})
    assert None not in values[0].values()
    assert values[1] == values[0]


def test_h2d_reader_reads_the_program_counters(monkeypatch):
    from streammos_tpu_torch.utils import profiling

    rec = loops.Record("eval")
    profiling.count("smt.steps", 2)
    profiling.count("h2d.copies", 62)
    counts = profiling.counters()
    assert manifest.reader("h2d_copies.eval")(Run(None, rec, 1.0)) == \
        pytest.approx(counts["h2d.copies"] / counts["smt.steps"])
    assert manifest.reader("h2d_copies.eval")(
        Run(None, loops.Record("train"), 1.0)) is None
    # a program without the counters (the parent commit's): nothing to read
    monkeypatch.delattr(profiling, "counters")
    assert manifest.reader("h2d_copies.eval")(Run(None, rec, 1.0)) is None


@pytest.mark.cuda
def test_one_production_step_by_layer(tmp_path):
    """One `eval_step` of the `seg_eval_1s` configuration on the card,
    traced: no device time left to the root span, at most 1% of the device
    intervals without their launch, and as many `h2d.copies` as host-to-
    device copies launched inside the step, 0 included (a step replayed
    from its CUDA graphs copies nothing from the host)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench import scans, sut
    from portbench import weights as wts
    from portbench.reference import streammos as ref
    from streammos_tpu_torch.utils import profiling

    cell = manifest.resolve(manifest.load_manifest(), "seg_eval_1s")
    dev = torch.device("cuda", 0)
    meta = ref.StreamMOS(cell.config["model"], cell.config["with_refine"]
                         ).to("meta")
    port = sut.Port()
    model = port.eval_model(cell.config, wts.draw_weights(meta, 5, dev), dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    xyzi = scans.scan_bank(gen, 1, cell.config["model"]["seq_num"],
                           cell.traffic["points"], dev)
    memory = port.initial_memory(model, 1)
    for n in range(3):
        _, _, memory = port.eval_step(model, xyzi, memory, n > 0)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(tracing.WINDOW):
            before = profiling.counters()
            port.eval_step(model, xyzi, memory, True)
            after = profiling.counters()
            torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    lay = layers.attribute(events)
    s = tracing.reduce(events)
    assert lay.steps == 1
    assert lay.device_us.get(layers.ROOT_SPAN, 0.0) == 0.0
    assert lay.unmatched <= 0.01 * lay.device_events
    assert sum(lay.device_us.values()) == pytest.approx(1e6 * s.busy_s)
    assert sum(lay.idle_us.values()) == pytest.approx(
        1e6 * (s.window_s - s.busy_s))
    copies = after.get("h2d.copies", 0) - before.get("h2d.copies", 0)
    assert layers.launched_inside(lay, layers.ROOT_SPAN,
                                  "Memcpy HtoD") == copies
