"""The traced window by layer of the eval step, from the program's spans.

The program marks each call into a layer of its eval step with a span
(`streammos_tpu_torch/utils/profiling.py:span`, names ``smt.*``), which
`torch.profiler` records as a ``user_annotation`` event on the clock of
the device events. A span's bucket is the second dot-separated part of its
name (``smt.scatter.rv0`` -> ``scatter``); the root ``smt.step``, the
frame's hand-over ``smt.input`` and time outside every span are ``loop``.

* Device time: each device interval of the window (kernel, copy, fill;
  clipped to the window as `tracing.reduce` clips it) goes to the innermost
  span open when the host launched it, that is at the start of the runtime
  or driver call that carries the interval's ``correlation``. Where
  intervals overlap, the overlap goes to the one that started first, so
  the buckets sum to the union of the intervals: the window's busy time.
* Idle time: the span tree is flattened into disjoint host intervals, each
  labelled with its innermost span, and each idle gap of the window is
  split across them by overlap; what no span covers goes to ``loop``. The
  buckets sum to the window less its busy time.

`attribute` works on the events of a Chrome trace; `tracing.reduce` keeps
none of them, so the benchmark's readers cannot call it yet. Run as

    python3 -m portbench.layers --workload <cell> --seed <n>

it runs the cell traced, as ``run.py --trace 1`` does, keeps the trace's
events, and prints one JSON line: the result line of ``run.py --trace 1``
with ``layers`` added (ms a step by bucket and by span, and the sums
beside the window's busy time).
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

from portbench import tracing

PREFIX = "smt."
ROOT_SPAN = "smt.step"
LOOP = "loop"
BUCKETS = ("featurize", "point_mlp", "scatter", "gather", "encoder",
           "attention", "heads", LOOP)
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def bucket(name: str) -> str:
    """``smt.<bucket>[.<site>]`` -> its bucket; `loop` for the root, the
    hand-over and anything that is not a span."""
    parts = name.split(".")
    if len(parts) > 1 and parts[0] + "." == PREFIX and parts[1] in BUCKETS:
        return parts[1]
    return LOOP


def flatten(spans: List[Tuple[float, float, str]]
            ) -> List[Tuple[float, float, str]]:
    """Properly nested spans (start, end, name) -> disjoint intervals in
    time order, each labelled with the innermost span covering it; stretches
    no span covers are left out. A child that outlasts its parent (the
    trace rounds to the nanosecond) is cut at the parent's end."""
    out: List[Tuple[float, float, str]] = []
    stack: List[Tuple[float, str]] = []   # (end, name), innermost last
    at = 0.0

    def emit(a, b, name):
        if b > a:
            out.append((a, b, name))

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= a:
            end, inner = stack.pop()
            emit(at, end, inner)
            at = end
        if stack:
            emit(at, a, stack[-1][1])
            b = min(b, stack[-1][0])
        stack.append((b, name))
        at = a
    while stack:
        end, inner = stack.pop()
        emit(at, end, inner)
        at = end
    return out


class _Labels:
    """The innermost span at a time, from `flatten`'s intervals."""

    def __init__(self, flat: List[Tuple[float, float, str]]):
        self.flat = flat
        self.starts = [f[0] for f in flat]

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.flat[i][1]:
            return self.flat[i][2]
        return LOOP


@dataclasses.dataclass
class Layers:
    window_us: Tuple[float, float]
    device_us: Dict[str, float]   # by innermost span name (or "loop")
    idle_us: Dict[str, float]
    steps: int                    # `smt.step` spans that start in the window
    device_events: int
    unmatched: int                # device intervals with no launch found
    spans: List[Tuple[float, float, str]]
    launched: List[Tuple[float, float, str, Optional[float]]]
    # (start, end, name, launch time) of each device interval in the window

    def by_bucket(self, per_name: Dict[str, float]) -> Dict[str, float]:
        out = dict.fromkeys(BUCKETS, 0.0)
        for name, us in per_name.items():
            out[bucket(name)] += us
        return out


def attribute(events: List[Dict]) -> Layers:
    """A Chrome trace's events -> device and idle time of the window (the
    benchmark's ``portbench.window`` annotation) by innermost span."""
    win = [e for e in events if e.get("name") == tracing.WINDOW
           and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise RuntimeError(f"trace holds {len(win)} {tracing.WINDOW} "
                           "annotations")
    w0 = float(win[0]["ts"])
    window = (w0, w0 + float(win[0]["dur"]))
    launch_at: Dict[int, float] = {}
    device, spans = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        cat = e.get("cat")
        corr = (e.get("args") or {}).get("correlation")
        if cat in tracing.DEVICE_CATS:
            a, b = max(a, window[0]), min(b, window[1])
            if b > a:
                device.append((a, b, e["name"], corr))
        elif cat in LAUNCH_CATS and corr is not None:
            launch_at[corr] = a
        elif cat == "user_annotation" and e["name"].startswith(PREFIX):
            spans.append((a, b, e["name"]))
    labels = _Labels(flatten(spans))
    device_us: Dict[str, float] = collections.defaultdict(float)
    launched = []
    unmatched = 0
    covered = window[0]
    for a, b, name, corr in sorted(device, key=lambda d: (d[0], d[1])):
        t = launch_at.get(corr)
        if t is None:
            unmatched += 1
        launched.append((a, b, name, t))
        new = b - max(a, covered)
        if new > 0:
            device_us[LOOP if t is None else labels.at(t)] += new
        covered = max(covered, b)
    idle_us: Dict[str, float] = collections.defaultdict(float)
    for g0, g1 in tracing.idle_gaps([(a, b) for a, b, _, _ in device], window):
        left = g1 - g0
        i = max(bisect.bisect_right(labels.starts, g0) - 1, 0)
        for a, b, name in labels.flat[i:]:
            if a >= g1:
                break
            part = min(b, g1) - max(a, g0)
            if part > 0:
                idle_us[name] += part
                left -= part
        idle_us[LOOP] += left
    steps = sum(1 for a, _, name in spans
                if name == ROOT_SPAN and window[0] <= a < window[1])
    return Layers(window, dict(device_us), dict(idle_us), steps, len(device),
                  unmatched, spans, launched)


def launched_inside(lay: Layers, span_name: str, device_name: str) -> int:
    """Device intervals whose name holds `device_name` and whose launch lies
    inside a span named `span_name`."""
    inside = sorted((a, b) for a, b, n in lay.spans if n == span_name)
    starts = [s[0] for s in inside]
    count = 0
    for _, _, name, t in lay.launched:
        if t is None or device_name not in name:
            continue
        i = bisect.bisect_right(starts, t) - 1
        count += i >= 0 and t <= inside[i][1]
    return count


def summary(lay: Layers, steps: int) -> Dict:
    """ms a step by bucket (``device_ms.<b>``, ``idle_ms.<b>``) and by span,
    the sums, and the device intervals with no launch found."""
    ms = lambda d: {k: v / 1e3 / steps for k, v in sorted(d.items())}
    out = {}
    for b, v in ms(lay.by_bucket(lay.device_us)).items():
        out[f"device_ms.{b}"] = v
    for b, v in ms(lay.by_bucket(lay.idle_us)).items():
        out[f"idle_ms.{b}"] = v
    return {"metrics": out, "device_ms_by_span": ms(lay.device_us),
            "idle_ms_by_span": ms(lay.idle_us),
            "device_ms_sum": sum(lay.device_us.values()) / 1e3 / steps,
            "idle_ms_sum": sum(lay.idle_us.values()) / 1e3 / steps,
            "window_ms": (lay.window_us[1] - lay.window_us[0]) / 1e3 / steps,
            "steps": steps, "smt_step_spans": lay.steps,
            "device_events": lay.device_events, "unmatched": lay.unmatched}


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    import torch

    from portbench import manifest, run, sut

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    cell = manifest.resolve(manifest.load_manifest(), args.workload)
    if not torch.cuda.is_available():
        print("portbench.layers: needs a CUDA card", file=sys.stderr)
        return 2
    kept = []
    reduce = tracing.reduce

    def keep(events):
        kept.append(events)
        return reduce(events)

    tracing.reduce = keep
    try:
        result, numbers, failed = run.run_cell(
            cell, args.seed, 0.0, True, torch.device("cuda", 0), sut.Port())
    finally:
        tracing.reduce = reduce
    out = run.result(result, numbers, failed, True, cell.chips)
    lay = attribute(kept[0])
    out["layers"] = summary(lay, result.rec.steps)
    out["layers"]["busy_ms"] = 1e3 * result.rec.trace.busy_s / result.rec.steps
    out["layers"]["card"] = run.card_line()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
