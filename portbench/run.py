"""Run one cell of the benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``python3 -m portbench.run`` works too). It
draws the weights and the traffic from the seed, warms up the cell's own
shapes, measures for `--seconds` (traced: `trace_steps` steps under the
profiler), checks what the timed path produced against the plain
reference, prints each compared number beside its limit on standard error
and one JSON line on standard output, and exits. It needs as many CUDA
cards as the cell asks for, and exits 2 without a result otherwise.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# run as a script, the script's own folder comes first on the path: put the
# checkout's root there instead, so `portbench` is a package
sys.path = [str(ROOT)] + [p for p in sys.path
                          if Path(p or ".").resolve() != ROOT / "portbench"]

import torch  # noqa: E402

from portbench import check, guard, manifest, modes, sut, tracing  # noqa: E402


class Run:
    """What the metric readers read: the cell, the window's record, the
    set-up time; and the seconds the comparison took."""

    def __init__(self, cell, rec, setup_s, check_s=0.0):
        self.cell, self.rec, self.setup_s = cell, rec, setup_s
        self.check_s = check_s


def seeds(seed: int):
    """Independent streams for the weights and the traffic."""
    return 2 * seed + 1, 2 * seed + 2


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             system, t_start: float = T_START, here: Path = manifest.HERE):
    """Set-up, window, readers, comparison, in the mode of the cell's loop
    (`modes/<loop>.py`). Returns (run, numbers, steps that failed)."""
    w_seed, t_seed = seeds(seed)
    mode = modes.load(cell.traffic["loop"], here)
    rec, compare = mode.run(system, cell, w_seed, t_seed, seconds, trace,
                            device)
    t_check = time.perf_counter()
    numbers, compared = compare()
    t_check = time.perf_counter() - t_check
    failed = 0 if check.verdict(numbers, cell.limits) else compared
    return Run(cell, rec, rec.window_t0 - t_start, t_check), numbers, failed


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out.splitlines()[0] if out else "nvidia-smi: no reading"


def result(run, numbers, failed, trace: bool, chips: int) -> dict:
    cell, rec = run.cell, run.rec
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = manifest.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": int(rec.raw_peak_bytes)}
    out = {"correct": check.verdict(numbers, cell.limits),
           "attempted": rec.frames,
           "failed": failed, "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = rec.trace.busy_s
        device["window_s"] = rec.trace.window_s
        out["breakdown"] = tracing.breakdown(rec.trace)
    out["checks"] = {k: {"value": numbers[k], "limit": v}
                     for k, v in cell.limits.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = manifest.resolve(manifest.load_manifest(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    bad = guard.reference_violations()
    if bad:
        print(f"portbench: the reference imports {bad}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    run, numbers, failed = run_cell(cell, args.seed, args.seconds,
                                    bool(args.trace), device, sut.Port())
    loaded = guard.forbidden_loaded()
    if loaded:
        print(f"portbench: the run loaded {loaded}", file=sys.stderr)
        return 4
    out = result(run, numbers, failed, bool(args.trace), cell.chips)
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    print(f"portbench: {args.workload} seed {args.seed} on {card_line()}; "
          f"peak with the comparison {peak:.2f} GiB; "
          f"{numbers.get('steps_checked', cell.traffic.get('check_steps'))} "
          f"steps checked in {run.check_s:.1f} s; other readings "
          + json.dumps({k: v for k, v in numbers.items()
                        if k not in cell.limits}), file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']:.6g} limit {v['limit']:.6g}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
