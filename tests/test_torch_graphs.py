"""CUDA graphs of the carried eval step (`serve.step_graph`,
`utils/graphs.py`).

On the CPU: the graph path stays inert, and a capture cuts its segments at
span boundaries and marks, drops the empty ones, takes back the counts
taken while capturing and adds them again at each replay (against a
stand-in for `torch.cuda.CUDAGraph`).

On the card (skipped elsewhere): the replayed step is bit for bit the eager
step, logits included, at Bt = 1 and 2 with the fused header on and off;
its outputs outlive the next step; a new sequence starts eagerly and then
replays; a new point count captures a second key; weights loaded in place
show in the next replay; the hand kernels' launch counts tell the truth;
and a traced replay keeps every span of the step, in order, with device
time in every bucket of `portbench.layers`. This file imports neither jax
nor the JAX package:

    python -m pytest --noconftest tests/test_torch_graphs.py -q
"""
import dataclasses
import importlib.util
import json
import os
import warnings

import numpy as np
import pytest
import torch

from streammos_tpu_torch import serve
from streammos_tpu_torch.config import get_config
from streammos_tpu_torch.scans import skewed_scan_bank
from streammos_tpu_torch.tools.kernel_times import bn_launches
from streammos_tpu_torch.utils import graphs, profiling


def _by_path(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(__file__), f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


STEP_SPANS = _by_path("test_torch_profiling").STEP_SPANS


def _model(device, fused_header=True, dtype="bfloat16", seed=3):
    cfg = get_config("StreamMOS_tiny")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, fused_header=fused_header, compute_dtype=dtype))
    return serve.build_model(cfg, device=device, seed=seed)


def _xyzi(model, frames, bt, points, device, seed=7):
    """(frames, bt, T, N, 4) scans on `device`."""
    T = model.cfg.seq_num
    bank = skewed_scan_bank(np.random.default_rng(seed), frames * bt, T,
                            points)
    return torch.from_numpy(bank).to(device).reshape(frames, bt, T, points, 4)


def _counted(before, name):
    return profiling.counters().get(name, 0) - before.get(name, 0)


# ---- on the CPU ----------------------------------------------------------

def test_graphs_stay_inert_off_the_card():
    model = _model("cpu", dtype="float32")
    xyzi = _xyzi(model, 3, 1, 512, "cpu")
    frames = [{"xyzi": x[0], "seq_id": "00"} for x in xyzi]
    before = profiling.counters()
    list(serve.stream_eval(model, frames))
    assert _counted(before, "smt.steps") == 3
    assert _counted(before, "graph.captures") == 0
    assert _counted(before, "graph.replays") == 0
    assert model.step_graphs == {}


class _FakeGraph:
    """Stands in for `torch.cuda.CUDAGraph`: holds the `work` done between
    `capture_begin` and `capture_end`, warns as torch does when there was
    none, and does it again at `replay`."""

    work, replayed = [], []

    def capture_begin(self, pool=None):
        self.start = len(_FakeGraph.work)

    def capture_end(self):
        self.mine = _FakeGraph.work[self.start:]
        if not self.mine:
            warnings.warn("The CUDA Graph is empty. This usually means that "
                          "the graph was attempted to be captured on wrong "
                          "device or stream.")

    def replay(self):
        _FakeGraph.replayed.extend(self.mine)


def test_capture_cuts_at_spans_and_marks(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(_FakeGraph, "work", [])
    monkeypatch.setattr(_FakeGraph, "replayed", [])
    work = _FakeGraph.work.append
    before = profiling.counters()
    with warnings.catch_warnings():
        warnings.simplefilter("error")       # no empty segment warns
        with graphs.Capture() as cap:
            work("pre")
            with profiling.span("smt.outer"):
                work("a")
                profiling.count("kernel.test_graphs")
                with profiling.span("smt.empty"):
                    pass
                work("b")
                cap.mark()
                work("c")
            cap.mark()
    # capturing launches nothing: its counts are taken back
    assert _counted(before, "kernel.test_graphs") == 0
    program = cap.program()
    assert len(program.parts) == 3 and program.graphs == 4
    with profiling.trace(str(tmp_path)):
        for i in range(3):
            program.replay(i)
    assert _FakeGraph.replayed == ["pre", "a", "b", "c"]
    assert _counted(before, "kernel.test_graphs") == 1
    (name,) = os.listdir(tmp_path)
    events = json.loads((tmp_path / name).read_text())["traceEvents"]
    spans = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation"}
    (o0, o1), (e0, e1) = spans["smt.outer"], spans["smt.empty"]
    assert o0 <= e0 <= e1 <= o1


# ---- on the card ---------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs have no CPU mode)")
    return torch.device("cuda", 0)


def _eager(model, xyzi, memory, use_memory):
    with torch.inference_mode():
        return serve._step(model, model, xyzi, memory, use_memory)


def _stream(model, xyzi, step, fresh_at=(0,)):
    """Each frame's scores, refine scores, memory and logits (copies), the
    memory fresh at the frames `fresh_at`."""
    logits = []

    def hook(module, args, out):
        logits.append((out["pred"].clone(), out["bf_pred"].clone()))

    undo = model.register_forward_hook(hook).remove
    memory = serve.initial_memory(model, xyzi.shape[1])
    got = []
    try:
        for n in range(len(xyzi)):
            s, bf, memory = step(model, xyzi[n], memory, n not in fresh_at)
            got.append([s.clone(), bf.clone(), memory.clone()])
    finally:
        undo()
    return [g + list(lg) for g, lg in zip(got, logits)]


def _assert_bit_equal(a, b):
    assert len(a) == len(b)
    for n, (x, y) in enumerate(zip(a, b)):
        for i, (u, v) in enumerate(zip(x, y)):
            assert u.dtype == v.dtype and u.shape == v.shape, (n, i)
            assert torch.equal(u, v), (n, i, (u.float() - v.float()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("bt", [1, 2])
@pytest.mark.parametrize("fused_header", [True, False])
def test_replay_is_the_eager_step(cuda, bt, fused_header):
    model = _model(cuda, fused_header)
    xyzi = _xyzi(model, 5, bt, 4096, cuda)
    eager = _stream(model, xyzi, _eager)
    before = profiling.counters()
    replayed = _stream(model, xyzi, serve.eval_step)
    assert _counted(before, "graph.captures") == 1
    assert _counted(before, "graph.replays") == 4
    _assert_bit_equal(eager, replayed)


@pytest.mark.cuda
def test_outputs_outlive_the_next_step(cuda):
    model = _model(cuda)
    xyzi = _xyzi(model, 4, 1, 4096, cuda)
    memory = serve.initial_memory(model)
    kept = None
    for n in range(4):
        out = serve.eval_step(model, xyzi[n], memory, n > 0)
        if kept is not None:
            for t, copy in kept:
                assert torch.equal(t, copy)
        kept = [(t, t.clone()) for t in out]
        memory = out[2]
    assert len(model.step_graphs) == 1


@pytest.mark.cuda
def test_a_new_sequence_starts_eagerly(cuda):
    model = _model(cuda)
    xyzi = _xyzi(model, 5, 1, 4096, cuda)
    seqs = ["08", "08", "08", "09", "09"]
    before = profiling.counters()
    got = [(s.clone(), bf.clone()) for s, bf in serve.stream_eval(
        model, [{"xyzi": x[0], "seq_id": q} for x, q in zip(xyzi, seqs)])]
    assert _counted(before, "smt.steps") == 5
    assert _counted(before, "graph.captures") == 1
    assert _counted(before, "graph.replays") == 3
    eager = _stream(model, xyzi, _eager, fresh_at=(0, 3))
    _assert_bit_equal([(g[0][0], g[1][0]) for g in eager], got)


@pytest.mark.cuda
def test_a_new_point_count_captures_a_new_key(cuda):
    model = _model(cuda)
    for points, captures in ((4096, 1), (4096, 0), (3000, 1)):
        before = profiling.counters()
        _stream(model, _xyzi(model, 3, 1, points, cuda), serve.eval_step)
        assert _counted(before, "graph.captures") == captures
        assert _counted(before, "graph.replays") == 2
    assert len(model.step_graphs) == 2


@pytest.mark.cuda
def test_weights_loaded_in_place_show_in_the_next_replay(cuda):
    model = _model(cuda)
    xyzi = _xyzi(model, 3, 1, 4096, cuda)
    old = _stream(model, xyzi, serve.eval_step)
    model.load_state_dict(_model(cuda, seed=4).state_dict())
    before = profiling.counters()
    new = _stream(model, xyzi, serve.eval_step)
    assert _counted(before, "graph.captures") == 0
    assert _counted(before, "graph.replays") == 2
    assert not torch.equal(old[2][0], new[2][0])
    _assert_bit_equal(_stream(model, xyzi, _eager), new)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kernel_counts_under_replay(cuda, dtype):
    model = _model(cuda, dtype=dtype)
    name = ("kernel.fused_header.bf16" if dtype == "bfloat16"
            else "kernel.fused_header.f32")
    xyzi = _xyzi(model, 2, 1, 4096, cuda)
    memory = serve.initial_memory(model)
    _, _, memory = serve.eval_step(model, xyzi[0], memory, False)
    _, _, memory = serve.eval_step(model, xyzi[1], memory, True)
    for step in (serve.eval_step, _eager):
        before = profiling.counters()
        _, _, memory = step(model, xyzi[1], memory, True)
        assert _counted(before, name) == 1
        assert _counted(before, "kernel.bn_act") == bn_launches(model)
    assert _counted(before, "graph.replays") == 0


@pytest.mark.cuda
def test_a_traced_replay_keeps_its_spans(cuda, tmp_path):
    from portbench import layers, tracing

    model = _model(cuda)
    xyzi = _xyzi(model, 2, 1, 16384, cuda)
    memory = serve.initial_memory(model)
    for n in range(3):
        _, _, memory = serve.eval_step(model, xyzi[n % 2], memory, n > 0)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    before = profiling.counters()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(tracing.WINDOW):
            for n in range(3):
                _, _, memory = serve.eval_step(model, xyzi[n % 2], memory,
                                               True)
            torch.cuda.synchronize()
    assert _counted(before, "graph.replays") == 3
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("smt."))
    steps = [s for s in spans if s[2] == "smt.step"]
    assert len(steps) == 3
    for s0, s1, _ in steps:
        mine = [s for s in spans if s0 <= s[0] < s1 and s[2] != "smt.step"]
        assert [s[2] for s in mine] == (["smt.input"] + STEP_SPANS
                                        + ["smt.output"])
        assert all(s0 <= a and b <= s1 for a, b, _ in mine)
        assert all(b <= a for (_, b, _), (a, _, _) in zip(mine, mine[1:]))
    lay = layers.attribute(events)
    s = tracing.reduce(events)
    assert lay.steps == 3
    assert lay.unmatched <= 0.01 * lay.device_events
    assert lay.device_us.get(layers.ROOT_SPAN, 0.0) == 0.0
    device = lay.by_bucket(lay.device_us)
    assert all(device[b] > 0 for b in layers.BUCKETS), device
    assert sum(lay.device_us.values()) == pytest.approx(1e6 * s.busy_s)
    assert sum(lay.idle_us.values()) == pytest.approx(
        1e6 * (s.window_s - s.busy_s))
