"""Profiling: the eval step's spans, the process's counters, and the trace
that holds the spans.

* :func:`span` — a named span (``smt.<bucket>[.<site>]``) at a call into a
  layer of the eval step: the profiler's own `record_function` while a
  `torch.profiler` session records, so the span is a ``user_annotation``
  event on the clock of the trace's device events; otherwise one shared
  no-op context, after a single check of the profiler's flag;
* :func:`count` / :func:`counters` — named counts, always on: the hand
  kernels' launches (``kernel.*``), eval steps (``smt.steps``) and the
  host-built tensors the eval step copies to the device (``h2d.copies``);
* :func:`to_device` — `torch.as_tensor` of host data, counted as one
  ``h2d.copies`` (on a card, one pageable host-to-device copy);
* :func:`trace` — a `torch.profiler` context over the host and, on a
  card, the device, writing a Chrome trace, spans included, that
  TensorBoard's profiler plugin and Perfetto load.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)

_profiler_enabled = torch._C._autograd._profiler_enabled
NO_SPAN = contextlib.nullcontext()
_COUNTS: Dict[str, int] = {}


def span(name: str):
    """A context that marks the block as span `name` in a recording
    profiler's trace; `NO_SPAN` when no profiler records."""
    if _profiler_enabled():
        return record_function(name)
    return NO_SPAN


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
