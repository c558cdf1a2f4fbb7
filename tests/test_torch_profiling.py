"""`utils/profiling.py` on the CPU: `trace` writes a Chrome trace of the
block into its directory, the eval step's spans among its events, each
inside its parent; outside a profiler `span` is one shared no-op context;
the counters count eval steps and the host-built tensors copied to the
device: each of a step's constants once a process, on its first step,
and none after; every cached constant is bit for bit what its site
builds afresh."""
import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from streammos_tpu_torch import serve
from streammos_tpu_torch.config import get_config
from streammos_tpu_torch.scans import skewed_scan_bank
from streammos_tpu_torch.utils import profiling

# the spans inside one `smt.step`, in call order, none inside another
STEP_SPANS = [
    "smt.featurize", "smt.point_mlp", "smt.scatter.bev_full",
    "smt.encoder.header", "smt.gather.bev0", "smt.scatter.rv0",
    "smt.encoder.header_rv", "smt.gather.rv0", "smt.scatter.bev0",
    "smt.encoder.res1_bev", "smt.gather.bev1", "smt.scatter.rv1",
    "smt.encoder.res1_rv", "smt.gather.rv1", "smt.scatter.bev1",
    "smt.encoder.res2", "smt.attention", "smt.encoder.decoder",
    "smt.gather.point", "smt.heads", "smt.heads.scores"]


def _model(fused_header: bool, dtype: str = "float32"):
    cfg = get_config("StreamMOS_tiny")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, fused_header=fused_header, compute_dtype=dtype))
    return serve.build_model(cfg, device="cpu", seed=3)


def _frames(model, n: int):
    return [{"xyzi": f[0], "seq_id": "00"} for f in skewed_scan_bank(
        np.random.default_rng(7), n, model.cfg.seq_num, 1024)]


def _step_copies(model) -> int:
    """The host-built tensors of one eval step: a constant of the
    featurization (12), the TTA signs, a scale per grid axis at each of the
    5 scatter sites, two interpolation matrices per resize (2), and the
    attention's reference points and one normaliser per layer."""
    return 12 + 1 + 2 * 5 + 2 * 2 + 1 + model.cfg.n_attn_layers


def _step_constants(model) -> int:
    """The distinct ones among them, each a tensor of its own in the
    cache: the featurization's values (x and y share their range and step,
    and the distance's 1e-12 is the range view's), the TTA signs, the
    scatter scales 1, 1/2 and 1/4, one interpolation matrix per distinct
    (input, output) size of the two resizes, the reference points and one
    normaliser for every layer."""
    v = model.cfg.voxel
    values = []
    for d, rng in enumerate((v.range_x, v.range_y, v.range_z)):
        values += [rng[0], 1.0 / ((rng[1] - rng[0]) / v.bev_shape[d])]
    phi_hi = 180.0 * math.pi / 180.0
    th_lo, th_hi = (t * math.pi / 180.0 for t in v.rv_theta)
    values += [1e-12, phi_hi, 1.0 / ((phi_hi + phi_hi) / v.rv_shape[1]),
               th_hi, 1.0 / ((th_hi - th_lo) / v.rv_shape[0]), 1e-12]
    h0, w0 = v.bev_wl[0] // 2, v.bev_wl[1] // 2
    resizes = {(h0 // s, h0) for s in (2, 4)} | {(w0 // s, w0) for s in (2, 4)}
    return len({float(x).hex() for x in values}) + 1 + 3 + len(resizes) + 2


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


class _Fresh(dict):
    """A constant cache that keeps nothing, so every site builds its
    tensor afresh at every call; it records what was built, by key."""

    def __init__(self):
        super().__init__()
        self.built = []

    def get(self, key, default=None):
        return default

    def __setitem__(self, key, value):
        self.built.append((key, value))


def test_trace_writes_a_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)) as prof:
        x = torch.randn(64, 64)
        (x @ x).sum().item()
    files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    events = json.loads((log_dir / files[0]).read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
    assert any("matmul" in e.key for e in prof.key_averages())


def test_span_is_the_shared_no_op_outside_a_profiler(monkeypatch):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        inside = profiling.span("smt.step")
    assert isinstance(inside, torch.profiler.record_function)
    assert profiling.span("smt.step") is profiling.NO_SPAN
    assert profiling.span("smt.heads") is profiling.NO_SPAN

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) outside a profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    model = _model(True)
    list(serve.stream_eval(model, _frames(model, 2)))


@pytest.mark.parametrize("fused_header", [True, False])
def test_eval_step_spans_nest_once_a_step(tmp_path, fused_header):
    model = _model(fused_header)
    with profiling.trace(str(tmp_path)):
        list(serve.stream_eval(model, _frames(model, 2)))
    (name,) = os.listdir(tmp_path)
    events = json.loads((tmp_path / name).read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("smt."))
    steps = [s for s in spans if s[2] == "smt.step"]
    inputs = [s for s in spans if s[2] == "smt.input"]
    assert len(steps) == len(inputs) == 2
    # each frame's hand-over, then its step, apart
    for (i0, i1, _), (s0, s1, _) in zip(inputs, steps):
        assert i1 <= s0
    assert inputs[1][0] >= steps[0][1]
    inner = [s for s in spans if s[2] not in ("smt.step", "smt.input")]
    assert len(inner) == 2 * len(STEP_SPANS)
    for s0, s1, _ in steps:
        mine = [s for s in inner if s0 <= s[0] < s1]
        assert [s[2] for s in mine] == STEP_SPANS
        assert all(s0 <= a and b <= s1 for a, b, _ in mine)
        assert all(b <= a for (_, b, _), (a, _, _) in zip(mine, mine[1:]))


@pytest.mark.parametrize("fused_header", [True, False])
def test_h2d_copies_a_step(monkeypatch, fused_header):
    monkeypatch.setattr(profiling, "_CONSTANTS", {})
    model = _model(fused_header)
    frames = _frames(model, 3)
    memory = serve.initial_memory(model)
    per_step = []
    for n, frame in enumerate(frames):
        before = profiling.counters()
        xyzi = torch.as_tensor(frame["xyzi"])[None]
        _, _, memory = serve.eval_step(model, xyzi, memory, n > 0)
        after = profiling.counters()
        assert after["smt.steps"] - before.get("smt.steps", 0) == 1
        per_step.append(after["h2d.copies"] - before.get("h2d.copies", 0))
    # each constant once, on the first step; the 30 tensors it copied on
    # every step before hold fewer distinct values
    assert per_step == [_step_constants(model), 0, 0]
    assert _step_constants(model) < _step_copies(model)
    # the stream loop copies each frame besides, and nothing else
    before = profiling.counters()
    list(serve.stream_eval(model, frames))
    after = profiling.counters()
    assert after["h2d.copies"] - before["h2d.copies"] == 3
    assert after["smt.steps"] - before["smt.steps"] == 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cached_constants_are_the_sites_own(monkeypatch, dtype):
    """Every cached constant equals, bit for bit and in dtype, the tensor
    its site builds afresh at every call of a carried stream; one key
    never stands for two values."""
    model = _model(True, dtype)
    frames = _frames(model, 2)
    fresh = _Fresh()
    monkeypatch.setattr(profiling, "_CONSTANTS", fresh)
    list(serve.stream_eval(model, frames))
    monkeypatch.setattr(profiling, "_CONSTANTS", {})
    list(serve.stream_eval(model, frames))
    cached = profiling._CONSTANTS
    assert len(fresh.built) == 2 * _step_copies(model)
    assert {key for key, _ in fresh.built} == set(cached)
    assert len(cached) == _step_constants(model)
    for key, built in fresh.built:
        got = cached[key]
        assert (got.dtype, got.shape, got.device) == (
            built.dtype, built.shape, built.device)
        assert torch.equal(_bits(got), _bits(built)), key
    dtypes = {t.dtype for t in cached.values()}
    assert dtypes == ({torch.float32} if dtype == "float32"
                      else {torch.float32, torch.bfloat16})


def test_a_constant_built_in_inference_mode_serves_autograd(monkeypatch):
    monkeypatch.setattr(profiling, "_CONSTANTS", {})
    with torch.inference_mode():
        c = profiling.constant(list, (2.0, 4.0), device="cpu",
                               dtype=torch.float32)
    assert not c.is_inference()
    assert profiling.constant(list, (2.0, 4.0), device="cpu",
                              dtype=torch.float32) is c
    x = torch.ones(2, requires_grad=True)
    (x / c).sum().backward()
    assert torch.equal(x.grad, 1.0 / c)


def test_counters_and_to_device():
    before = profiling.counters()
    profiling.count("test.counted")
    profiling.count("test.counted", 2)
    got = profiling.counters()
    assert got["test.counted"] - before.get("test.counted", 0) == 3
    got["test.counted"] = -1  # a copy
    assert profiling.counters()["test.counted"] >= 3
    # the same tensors the sites built before, each counted once
    mat = np.linspace(0, 1, 12, dtype=np.float32).reshape(3, 4) / 3
    before = profiling.counters().get("h2d.copies", 0)
    cases = [
        (profiling.to_device(np.float32(0.25), "cpu"),
         torch.tensor(np.float32(0.25), device="cpu")),
        (profiling.to_device(0.1, "cpu", torch.float32),
         torch.tensor(0.1, dtype=torch.float32, device="cpu")),
        (profiling.to_device([64, 32], "cpu", torch.bfloat16),
         torch.tensor([64, 32], dtype=torch.bfloat16, device="cpu")),
        (profiling.to_device(mat, "cpu", torch.bfloat16),
         torch.from_numpy(mat).to("cpu", torch.bfloat16)),
        (profiling.to_device(torch.ones(3, dtype=torch.float64), "cpu",
                             torch.float32),
         torch.as_tensor(torch.ones(3, dtype=torch.float64),
                         dtype=torch.float32, device="cpu"))]
    for got, want in cases:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)
    assert profiling.counters()["h2d.copies"] - before == len(cases)
