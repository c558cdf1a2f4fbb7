"""The metric arithmetic: whole-window rates, the tail, the idle share from
overlapping kernels, the header's work and the model's FLOPs."""
from __future__ import annotations

import pytest
import torch

from tinycells import tiny_cell
from portbench import loops, manifest, tracing, work
from portbench.run import Run


def _run(rec, cell=None, setup_s=12.5):
    return Run(cell, rec, setup_s)


def test_window_rates_and_tail():
    rec = loops.Record("eval", latencies_s=[0.01 * (i + 1) for i in range(100)],
                       frames=100, steps=100, window_s=2.0)
    assert manifest.reader("frame_ms")(_run(rec)) == pytest.approx(20.0)
    # linear interpolation between the 95th and 96th of 100 sorted values
    assert manifest.reader("frame_p95_ms")(_run(rec)) == pytest.approx(950.5)
    empty = loops.Record("eval", window_s=4.0)
    assert manifest.reader("frame_ms")(_run(empty)) is None
    assert manifest.reader("frame_p95_ms")(_run(empty)) is None
    assert manifest.reader("setup_s")(_run(rec)) == 12.5
    rec.peak_bytes = 3 * 2 ** 30
    assert manifest.reader("peak_mem_gib")(_run(rec)) == pytest.approx(3.0)


def _trace_events():
    """A window [100, 200) us; kernels overlapping on two streams."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW,
           "ts": 100.0, "dur": 100.0}]
    for ts, dur, name in ((90, 20, "k_early"), (120, 30, "k_a"),
                          (130, 10, "k_b"), (145, 15, "memcpy"),
                          (180, 5, "k_c"), (195, 10, "k_late")):
        cat = "gpu_memcpy" if name == "memcpy" else "kernel"
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": float(ts),
                   "dur": float(dur)})
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::nonzero",
               "ts": 160.0, "dur": 20.0})
    ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
               "ts": 165.0, "dur": 10.0})
    return ev


def test_idle_share_from_the_union_of_intervals():
    s = tracing.reduce(_trace_events())
    # busy: [100,110) + [120,160) + [180,185) + [195,200) = 60 us
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(60e-6)
    assert tracing.union_length([(0, 10), (5, 8), (9, 20), (30, 31)]) == 21
    rec = loops.Record("eval", steps=2, trace=s)
    assert manifest.reader("idle_share.eval")(_run(rec)) == pytest.approx(40.0)
    assert manifest.reader("launches.eval")(_run(rec)) == pytest.approx(3.0)
    assert manifest.reader("idle_share.eval")(_run(loops.Record("eval"))) is None
    # gaps [110,120) [160,180) [185,195); the middle one under the runtime call
    gaps = dict((name, dur) for dur, name in s.gaps)
    assert gaps["cudaMemcpyAsync"] == pytest.approx(20.0)
    b = tracing.breakdown(s)
    assert b["device_ops"][0] == ["k_a", pytest.approx(30e-6)]
    assert dict(map(tuple, b["idle_gaps"])) == {
        "cudaMemcpyAsync": pytest.approx(20e-6),
        "host between operators": pytest.approx(20e-6)}


def test_header_work_at_production_shape():
    nbytes, flops = work.header_work(1, 3, 256, 256, 64, 32, 2)
    assert round(nbytes / 1e6, 1) == 419.6
    assert round(flops / 1e9, 2) == 41.88
    assert work.header_bound_s(1, 3, 256, 256, 64, 32, 2) == pytest.approx(
        0.1252e-3, rel=1e-3)
    # four streams move four times the grid and output
    assert work.header_work(4, 3, 256, 256, 64, 32, 2)[1] == 4 * flops


def test_header_roofline_reads_the_kernel_from_the_trace():
    cell = manifest.resolve(manifest.load_manifest(), "seg_eval_1s")
    bound = work.header_bound_s(1, 3, 256, 256, 64, 32, 2)
    t = bound * 1e6 / 0.4  # a kernel at 40% of its bound
    s = tracing.Summary((0.0, 1000.0), [(10.0, 10.0 + t,
                                         "void header_bf16_kernel<32>(...)"),
                                        (500.0, 500.0 + t,
                                         "void header_bf16_kernel<32>(...)")])
    rec = loops.Record("eval", steps=2, trace=s)
    value = manifest.reader("header_roofline.bf16")(Run(cell, rec, 0.0))
    assert value == pytest.approx(40.0)
    s.device = [(10.0, 20.0, "other")]
    assert manifest.reader("header_roofline.bf16")(Run(cell, rec, 0.0)) is None


def test_model_flops_match_the_flop_counter_on_the_reference():
    from torch.utils.flop_counter import FlopCounterMode

    from portbench import weights
    from portbench.reference import streammos as ref

    m = tiny_cell("stream", "float32").config["model"]
    model = ref.StreamMOS(m, True)
    model.load_state_dict(weights.draw_weights(model, 1, "cpu"), strict=False)
    x = torch.randn(2, m["seq_num"], 500, 4) * 20
    with FlopCounterMode(display=False) as fc:
        ref.eval_frame(model, x, ref.memory_zeros(m, 8, "cpu"), True)
    layers = work.model_flops(m, 8, 500, True)
    assert work.matmul_flops(layers) == fc.get_total_flops()
    # by hand: the point MLP, 7 -> 64 -> 64 over 8 rows x 3 frames x 500
    assert dict(layers)["point_pre"] == 2 * 8 * 3 * 500 * (7 * 64 + 64 * 64)


def test_mfu_readers_at_production_shapes():
    cell = manifest.resolve(manifest.load_manifest(), "seg_eval_1s")
    flops = sum(f for _, f in work.model_flops(cell.config["model"], 4,
                                                160000, True))
    assert 500e9 < flops < 650e9
    s = tracing.Summary((0.0, 1e6), [])
    rec = loops.Record("eval", steps=20, window_s=1.0, trace=s)
    mfu = manifest.reader("mfu.eval")(Run(cell, rec, 0.0))
    assert mfu == pytest.approx(100 * flops * 20 / 989e12)
