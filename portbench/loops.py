"""The eval loops that a traffic file's ``loop`` names (run by
`modes/stream.py` and `modes/batched.py`), what they record, and the
`Record` and the measured window that every mode shares.

* ``stream``: one stream, closed loop, through `stream_eval`. A frame's
  latency runs on the host clock from the moment its points are handed
  over (the frame generator yields them) to the moment its per-point
  labels (argmax of the scores and of the refine head's scores) are in
  host memory; the next frame is handed over only then.
* ``batched``: `streams` independent streams, one `eval_step` of batch Bt =
  streams a step, each stream with its memory slot, carried; every
  stream's frame of a step has the step's latency.

Each loop runs set-up and warm-up, then a window of `seconds` (or, traced,
of `trace_steps` steps under the profiler), then hands back a `Record`.
Frames cycle through a bank of distinct frames drawn from the seed; the
memory is fresh on the first warm-up frame and carried after.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import scans, tracing


@dataclasses.dataclass
class Record:
    kind: str
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    frames: int = 0            # frames completed in the window (all streams)
    steps: int = 0             # steps completed in the window
    window_s: float = 0.0
    window_t0: float = 0.0     # perf_counter at the window's start
    peak_bytes: int = 0        # the program's peak in the window
    raw_peak_bytes: int = 0    # the process's, capture buffers included
    host_spans_s: List[float] = dataclasses.field(default_factory=list)
    trace: Optional[tracing.Summary] = None
    check: Dict = dataclasses.field(default_factory=dict)  # what `check` reads


class Recorder:
    """Wraps the system's step function: host spans of the calls in the
    window, and copies of the input memory, logits (read by a forward hook
    on the model) and outputs of two kinds of steps, for the comparison
    after the window: the chain, the first `chain` calls from the fresh
    start (warm-up steps, on the path the window takes), and a seeded
    reservoir of `k` window steps, copied into buffers allocated before
    the window."""

    def __init__(self, k: int, chain: int, seed: int):
        self.k, self.chain_len = k, chain
        self.rng = np.random.default_rng([seed, 0x5eed])
        self.in_window = False
        self.window_calls = 0
        self.spans: List[float] = []
        self.current: List[int] = []     # bank indices of the call's frames
        self.chain: List[Dict] = []
        self.slots: List[Dict] = []
        self.pending: Optional[Dict] = None
        self.bytes = 0

    @staticmethod
    def _put(slot: Dict, key: str, t: torch.Tensor) -> None:
        if key in slot:
            slot[key].copy_(t)
        else:
            slot[key] = t.detach().clone()

    def on_logits(self, pred: torch.Tensor, bf: Optional[torch.Tensor]):
        """The model's forward hook: its logits (V*Bt, N, classes)."""
        if self.pending is not None:
            self._put(self.pending, "logits", pred)
            if bf is not None:
                self._put(self.pending, "bf_logits", bf)

    def wrap(self, fn):
        def step(model, xyzi, memory, use_memory):
            first = not self.chain
            slot = None
            if len(self.chain) < self.chain_len and not self.in_window:
                slot = {}
                self.chain.append(slot)
            elif self.in_window:
                j = self.window_calls
                self.window_calls += 1
                r = j if j < self.k else int(self.rng.integers(0, j + 1))
                if r < self.k:
                    slot = self.slots[r]
            if slot is not None:
                self._put(slot, "memory_in", memory)
            self.pending = slot
            t0 = time.perf_counter()
            scores, bf, new_memory = fn(model, xyzi, memory, use_memory)
            t1 = time.perf_counter()
            self.pending = None
            if self.in_window:
                self.spans.append(t1 - t0)
            if slot is not None:
                self._put(slot, "scores", scores)
                self._put(slot, "memory_out", new_memory)
                if bf is not None:
                    self._put(slot, "bf_scores", bf)
                slot["frames"] = list(self.current)
                slot["use_memory"] = bool(use_memory)
            if first:
                tensors = {k: v for k, v in slot.items()
                           if isinstance(v, torch.Tensor)}
                self.slots = [{k: torch.empty_like(v) for k, v in
                               tensors.items()} for _ in range(self.k)]
                self.bytes = (self.k + self.chain_len) * sum(
                    v.numel() * v.element_size() for v in tensors.values())
            return scores, bf, new_memory
        return step

    def sample(self) -> List[Dict]:
        """The window's sampled steps (in no order)."""
        return [s for s in self.slots if "frames" in s]


def _labels_to_host(scores, bf):
    lab = scores.argmax(-1)
    if bf is not None:
        lab = torch.stack([lab, bf.argmax(-1)])
    return lab.cpu()


def host_bank(cell, seed: int, device) -> torch.Tensor:
    """(bank_frames, T, N, 4) float32 in host memory, drawn on `device`."""
    t = cell.traffic
    gen = torch.Generator(device=device).manual_seed(seed)
    return scans.scan_bank(gen, t["bank_frames"], cell.config["model"]["seq_num"],
                           t["points"], device).cpu()


@contextlib.contextmanager
def _window(rec: Record, recorder: Optional[Recorder], device, trace: bool):
    """Sync, reset the peak, start the profiler if traced, open the window;
    on exit sync and read the window's length and peak."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    prof = tracing.Profile() if trace else contextlib.nullcontext()
    with prof:
        if recorder is not None:
            recorder.in_window = True
        rec.window_t0 = time.perf_counter()
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        rec.window_s = time.perf_counter() - rec.window_t0
        if recorder is not None:
            recorder.in_window = False
    if device.type == "cuda":
        rec.raw_peak_bytes = torch.cuda.max_memory_allocated(device)
        rec.peak_bytes = rec.raw_peak_bytes - (
            recorder.bytes if recorder is not None else 0)
    if trace:
        rec.trace = prof.summary()


def _done(rec: Record, t: float, seconds: float, trace_steps: int,
          trace: bool) -> bool:
    if trace:
        return rec.steps >= trace_steps
    return t - rec.window_t0 >= seconds


def stream(sut, model, cell, seed, seconds, trace, device, recorder) -> Record:
    t = cell.traffic
    bank = host_bank(cell, seed, device)
    rec = Record("eval")
    warm = t["warmup_frames"]
    state = {"stop": False, "t_hand": 0.0}
    win = _window(rec, recorder, device, trace)

    def frames():
        n = 0
        while not state["stop"]:
            if n == warm:
                win.__enter__()
            idx = n % bank.shape[0]
            recorder.current = [idx]
            state["t_hand"] = time.perf_counter()
            yield {"xyzi": bank[idx], "seq_id": "08"}
            n += 1

    for n, (scores, bf) in enumerate(sut.stream_eval(model, frames())):
        _labels_to_host(scores, bf)
        done = time.perf_counter()
        if n >= warm:
            rec.latencies_s.append(done - state["t_hand"])
            rec.frames += 1
            rec.steps += 1
            if _done(rec, done, seconds, t["trace_steps"], trace):
                state["stop"] = True
    win.__exit__(None, None, None)
    rec.check["bank"] = bank
    return rec


def batched(sut, model, cell, seed, seconds, trace, device, recorder) -> Record:
    t = cell.traffic
    bt = t["streams"]
    bank = host_bank(cell, seed, device)
    nb = bank.shape[0]
    rec = Record("eval")
    memory = sut.initial_memory(model, bt)
    n = 0
    win = None
    while True:
        if n == t["warmup_frames"]:
            win = _window(rec, recorder, device, trace)
            win.__enter__()
        idx = [(s * (nb // bt) + n) % nb for s in range(bt)]
        recorder.current = idx
        t_hand = time.perf_counter()
        xyzi = torch.empty((bt,) + tuple(bank.shape[1:]), device=device)
        for s, i in enumerate(idx):
            xyzi[s].copy_(bank[i])
        scores, bf, memory = sut.eval_step(model, xyzi, memory, n > 0)
        _labels_to_host(scores, bf)
        done = time.perf_counter()
        n += 1
        if win is not None:
            rec.latencies_s += [done - t_hand] * bt
            rec.frames += bt
            rec.steps += 1
            if _done(rec, done, seconds, t["trace_steps"], trace):
                break
    win.__exit__(None, None, None)
    rec.check["bank"] = bank
    return rec

