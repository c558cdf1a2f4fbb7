"""Profiling and timing utilities.

Counterpart of `streammos_tpu/utils/profiling.py`:

* :func:`trace` — a `torch.profiler` context over the host and, on a
  card, the device, writing a Chrome trace that TensorBoard's profiler
  plugin and Perfetto load;
* :func:`measure_rtt` — the median round trip of a scalar ``.item()``;
* :func:`chained_time` — seconds per call of a step, from K chained calls
  whose carry forces the data dependence: timed with CUDA events when the
  carry lies on a card (kernels are launched asynchronously, so a host
  clock would time the launches), with ``perf_counter`` on the CPU.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
from torch.utils._pytree import tree_leaves


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


def measure_rtt(reps: int = 5, device="cuda") -> float:
    """Median seconds of a host <-> `device` scalar round trip: a sum
    launched and its value read back with ``.item()``."""
    z = torch.zeros((8, 8), device=device)
    z.sum().item()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        z.sum().item()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def chained_time(step: Callable, init, K: int = 4, reps: int = 3) -> float:
    """Median seconds per iteration of ``step`` (carry -> carry) over `reps`
    runs of K chained calls, after one untimed run. The chaining must be
    real: feed the step's output back as its input."""
    leaves = [x for x in tree_leaves(init) if isinstance(x, torch.Tensor)]
    on_card = any(x.is_cuda for x in leaves)

    def chained():
        c = init
        for _ in range(K):
            c = step(c)
        return c

    chained()
    ts = []
    for _ in range(reps):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            chained()
            end.record()
            torch.cuda.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            chained()
            ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) / K
