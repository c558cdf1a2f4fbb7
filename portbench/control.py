"""The readings the output limits are set from, on the card, in one
process: the compared numbers of the measured package over many seeds
(the lower readings), of the control (the plain reference in the
program's place, computed in float8 e4m3: one precision below the
configuration's bfloat16) and of each fault the cell's mode plants
(`modes/<loop>.py`'s ``FAULTS``): the upper readings. One JSON line a run.
``--dtype`` runs the measured package in another compute dtype than the
configuration's (a witness: float32 beside bfloat16).

    python3 portbench/control.py --workload <name> --seeds 1-12 \
        --control-seeds 101-103 [--fault-seeds 201-203] --seconds 3 \
        [--dtype float32]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# run as a script, the script's own folder comes first on the path: put the
# checkout's root there instead, so `portbench` is a package
sys.path = [str(ROOT)] + [p for p in sys.path
                          if Path(p or ".").resolve() != ROOT / "portbench"]

import torch  # noqa: E402

from portbench import manifest, modes, sut  # noqa: E402
from portbench.reference import streammos as ref  # noqa: E402
from portbench.run import run_cell  # noqa: E402


def seed_list(text: str):
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def reading(cell, seed, seconds, device, system, what):
    t0 = time.perf_counter()
    run, numbers, _ = run_cell(cell, seed, seconds, False, device, system, t0)
    torch.cuda.empty_cache()
    rec = run.rec
    line = {"what": what, "seed": seed, "numbers": numbers,
            "steps": rec.steps, "frames": rec.frames,
            "window_s": rec.window_s, "setup_s": run.setup_s,
            "wall_s": time.perf_counter() - t0}
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--dtype", default=None)
    args = ap.parse_args(argv)
    cell = manifest.resolve(manifest.load_manifest(), args.workload)
    if args.dtype:
        cell.config["model"]["compute_dtype"] = args.dtype
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in seed_list(args.seeds):
        reading(cell, seed, args.seconds, device, sut.Port(), "program")
    for seed in seed_list(args.control_seeds):
        reading(cell, seed, args.seconds, device, sut.Reference(ref.FP8()),
                "control_fp8")
    for name, fault in modes.load(cell.traffic["loop"]).FAULTS.items():
        for seed in seed_list(args.fault_seeds):
            with fault():
                reading(cell, seed, args.seconds, device, sut.Port(),
                        f"fault_{name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
