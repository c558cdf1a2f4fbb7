"""Profiling: the eval and train steps' spans, the process's counters, and
the trace that holds the spans.

* :func:`span` — a named span (``smt.<bucket>[.<site>]``) at a call into a
  layer of the eval step, or a phase of the train step (``smt.train.step``
  around ``smt.train.window``, ``smt.train.loss``, ``smt.train.backward``
  and ``smt.train.optimizer``), or a data-parallel exchange
  (`parallel.py`: ``smt.dp.bn``, the BN sums' all-reduce forward and
  backward; ``smt.dp.gather``, the losses' all-gather and its backward
  all-reduce; ``smt.dp.grads``, the bucketed gradient all-reduce;
  ``smt.dp.replicate``, the set-up broadcast; each only while a process
  group is active): the profiler's own `record_function` while a
  `torch.profiler` session records, so the span is a ``user_annotation``
  event on the clock of the trace's device events; otherwise one shared
  no-op context, after a single check of the profiler's flag. While a
  CUDA graph of the eval step is captured (`utils/graphs.py`), the
  capture's own context, which cuts a graph segment at each boundary;
* :func:`count` / :func:`counters` — named counts, always on: the hand
  kernels' launches (``kernel.*``), eval steps (``smt.steps``), train
  steps (``train.steps``) and the bytes each holds for its backward on a
  card (``train.saved_bytes``; of them, those its windows' losses hold,
  ``train.loss_bytes``), the data-parallel collectives issued
  (``dp.collectives``) and the bytes this rank hands to them
  (``dp.bytes``), the host-built tensors copied to the device
  (``h2d.copies``), and the eval step's CUDA graphs (``graph.captures``,
  ``graph.replays``);
* :func:`to_device` — `torch.as_tensor` of host data, counted as one
  ``h2d.copies`` (on a card, one pageable host-to-device copy);
* :func:`constant` — a `to_device` tensor built once per value, dtype and
  device and shared after, so a step's constants are copied once a
  process and a CUDA graph can read them;
* :func:`trace` — a `torch.profiler` context over the host and, on a
  card, the device, writing a Chrome trace, spans included, that
  TensorBoard's profiler plugin and Perfetto load.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)

_profiler_enabled = torch._C._autograd._profiler_enabled
NO_SPAN = contextlib.nullcontext()
_COUNTS: Dict[str, int] = {}
_CONSTANTS: Dict[tuple, torch.Tensor] = {}
_span_hook: Optional[Callable] = None


def span(name: str):
    """A context that marks the block as span `name` in a recording
    profiler's trace; `NO_SPAN` when no profiler records; the hook's
    context inside `spans_to`."""
    if _span_hook is not None:
        return _span_hook(name)
    if _profiler_enabled():
        return record_function(name)
    return NO_SPAN


@contextlib.contextmanager
def spans_to(hook: Callable):
    """Inside the block, `span(name)` returns ``hook(name)``."""
    global _span_hook
    _span_hook = hook
    try:
        yield
    finally:
        _span_hook = None


def count(name: str, n: int = 1) -> None:
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> Dict[str, int]:
    """Every count since the process started (a copy)."""
    return dict(_COUNTS)


def to_device(data, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(data, dtype=dtype, device=device)``, counted as one
    ``h2d.copies`` unless `data` is a tensor on a device already."""
    if not (isinstance(data, torch.Tensor) and data.device.type != "cpu"):
        count("h2d.copies")
    return torch.as_tensor(data, dtype=dtype, device=device)


def constant(make: Callable, *args, device, dtype=None) -> torch.Tensor:
    """``to_device(make(*args), device, dtype)``, built on the first call
    for its (make, args, dtype, device) and the same tensor after: `args`
    must fix the value (they compare by ``==``), and no caller may write
    into the result. Built outside inference mode, so that a constant
    first built in an eval step serves training's autograd too."""
    key = (make, args, dtype, torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = _CONSTANTS[key] = to_device(make(*args), device, dtype)
    return t


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; on exit write ``<log_dir>/<host>_<pid>.<ts>.pt.
    trace.json``. Yields the `torch.profiler.profile` object (its
    `key_averages()` sum the block by operator and kernel)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
