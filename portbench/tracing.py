"""The traced window: `torch.profiler` over host and device, reduced to
what the per-layer readers need.

The profiler's Chrome trace is written under the run's temporary
directory, read back and deleted. The window is the benchmark's own
``portbench.window`` annotation. Device activity is every kernel, copy and
fill; the busy time is the union of their intervals inside the window, so
work that overlaps counts once. An idle gap is a stretch of the window with
nothing on the device, named by the innermost host event that covers its
middle (an operator, a runtime call, or the benchmark's own annotation).
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


@dataclasses.dataclass
class Summary:
    window_us: Tuple[float, float]
    device: List[Tuple[float, float, str]]   # (start, end, name) in window

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return union_length([(a, b) for a, b, _ in self.device]) / 1e6

    def by_name(self) -> Dict[str, Tuple[float, int]]:
        """name -> (seconds, count)."""
        out: Dict[str, List] = collections.defaultdict(lambda: [0.0, 0])
        for a, b, name in self.device:
            out[name][0] += (b - a) / 1e6
            out[name][1] += 1
        return {k: (v[0], v[1]) for k, v in out.items()}

    gaps: List[Tuple[float, str]] = dataclasses.field(default_factory=list)


def union_length(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of [a, b) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def idle_gaps(device: List[Tuple[float, float]], window: Tuple[float, float]
              ) -> List[Tuple[float, float]]:
    """The stretches of `window` that no device interval covers."""
    gaps, at = [], window[0]
    for a, b in sorted(device):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if window[1] > at:
        gaps.append((at, window[1]))
    return gaps


def name_gaps(gaps: List[Tuple[float, float]],
              host: List[Tuple[float, float, str]]) -> List[Tuple[float, str]]:
    """Each gap's length (us) and the innermost host event covering its
    middle (the one that started last among the 64 host events that began
    before it), or "host between operators"."""
    host = sorted(host)
    starts = [h[0] for h in host]
    out = []
    for a, b in gaps:
        mid = (a + b) / 2
        name = "host between operators"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 64, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        out.append((b - a, name))
    return out


def reduce(events: List[Dict]) -> Summary:
    """A Chrome trace's events -> the window's device intervals and gaps."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise RuntimeError(f"trace holds {len(win)} {WINDOW} annotations")
    w0 = float(win[0]["ts"])
    window = (w0, w0 + float(win[0]["dur"]))
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            a, b = max(a, window[0]), min(b, window[1])
            if b > a:
                device.append((a, b, e["name"]))
        elif e.get("cat") in HOST_CATS and e["name"] != WINDOW:
            host.append((a, b, e["name"]))
    gaps = name_gaps(idle_gaps([(a, b) for a, b, _ in device], window), host)
    return Summary(window, device, gaps)


class Profile:
    """Context: profile host and device, annotate the window; `summary()`
    after exit."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.mark = record_function(WINDOW)
        self._summary: Optional[Summary] = None

    def __enter__(self):
        self.prof.__enter__()
        self.mark.__enter__()
        return self

    def __exit__(self, *exc):
        self.mark.__exit__(*exc)
        self.prof.__exit__(*exc)
        with tempfile.TemporaryDirectory(prefix="portbench-trace-") as d:
            path = os.path.join(d, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        self._summary = reduce(events)
        return False

    def summary(self) -> Summary:
        return self._summary


def breakdown(s: Summary, top: int = 10) -> Dict:
    """The costliest device operations by name and the longest idle gaps by
    what the host was doing, seconds each, at most `top` of each."""
    ops = sorted(s.by_name().items(), key=lambda kv: -kv[1][0])[:top]
    gaps: Dict[str, float] = collections.defaultdict(float)
    for dur, name in s.gaps:
        gaps[name] += dur / 1e6
    return {"device_ops": [[k[:120], v[0]] for k, v in ops],
            "idle_gaps": [[k[:120], v] for k, v in
                          sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]}
