"""Time the fused TTA header of this checkout against another checkout's,
on one CUDA card, in turns:

    git archive <commit> | tar -x -C build/other
    python3 streammos_tpu_torch/tools/header_ab.py build/other

Each run is a process of its own that imports `streammos_tpu_torch` from
one checkout and calls that checkout's `fused_header_tta` (so its own
wrapper and its own kernels, built from its sources into its `build/`),
in the order other, this, this, other. Only the wrapper's public contract
is used, so any two commits of the port compare. The inputs are drawn
from one seed on the CPU at StreamMOS_seg's production shape (G (3, 4,
258, 256, 256), C = 64, Cout = 32), made and timed by this checkout's
`tools/kernel_times.py`. A run checks its float32 output against its own
plain version (rtol = atol = 1e-4, TF32 off) and times both dtypes
eagerly with CUDA events. Prints the card's name and power limit, each run's
times, whether the bf16 outputs of the two checkouts are bit-equal, the
float32 outputs' largest difference, and, as its last line, one JSON
object of all of it. Exits non-zero if a run fails or misses the float32
tolerance.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPS = 20
THIS_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run(root: str, out: str) -> None:
    """One run: `root`'s header at the production shape, both dtypes, on
    the inputs and with the timing of this checkout's `kernel_times.py`;
    writes the outputs and times to `out`."""
    sys.path[0] = root  # the checkout's package, not this file's folder
    import importlib.util

    import torch

    from streammos_tpu_torch.config import get_config
    from streammos_tpu_torch.ops import fused_header as fh

    spec = importlib.util.spec_from_file_location("kernel_times", os.path.join(
        THIS_ROOT, "streammos_tpu_torch", "tools", "kernel_times.py"))
    kt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kt)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    T, C, Cout, Hh, Wh = kt.header_shape(get_config("StreamMOS_seg"))
    res = {"root": root, "module": fh.__file__}
    for dtype, key in ((torch.bfloat16, "bfloat16"),
                       (torch.float32, "float32")):
        args = kt.header_inputs(torch.Generator().manual_seed(kt.SEED),
                                "cuda", 1, T, C, Cout, Hh, Wh, dtype)
        got = fh.fused_header_tta(*args, T)
        res[key + "_ms"] = kt.time_ms(lambda: fh.fused_header_tta(*args, T),
                                      REPS)
        res[key + "_out"] = got.cpu()
        if dtype == torch.float32:
            want = fh.fused_header_reference(*args, T)
            diff = (got - want).abs()
            res["float32_err"] = float(diff.max())
            res["float32_excess"] = float(
                (diff - kt.F32_TOL * (1 + want.abs())).max())
        del args, got
    torch.save(res, out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--run", nargs=2, metavar=("ROOT", "OUT"),
                    help=argparse.SUPPRESS)  # one run, in its own process
    args = ap.parse_args(argv)
    if args.run:
        run(*args.run)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("header_ab: no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    roots = {"other": os.path.abspath(args.other), "this": THIS_ROOT}
    runs = []
    os.makedirs(os.path.join(THIS_ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(
            prefix="header_ab_", dir=os.path.join(THIS_ROOT, "build")) as tmp:
        for i, who in enumerate(("other", "this", "this", "other")):
            out = os.path.join(tmp, f"{i}.pt")
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), args.other,
                 "--run", roots[who], out], capture_output=True, text=True)
            if proc.returncode != 0:
                print(f"header_ab: the {who} run failed:\n"
                      f"{proc.stderr[-4000:]}", file=sys.stderr)
                return 1
            runs.append((who, torch.load(out)))
    first = {}
    for who, res in runs:
        first.setdefault(who, res)
    bf16_equal = all(torch.equal(res["bfloat16_out"],
                                 first["this"]["bfloat16_out"])
                     for _, res in runs)
    f32_diff = float((first["other"]["float32_out"]
                      - first["this"]["float32_out"]).abs().max())
    summary = {
        "order": [who for who, _ in runs],
        "roots": roots,
        "bfloat16_ms": [res["bfloat16_ms"] for _, res in runs],
        "float32_ms": [res["float32_ms"] for _, res in runs],
        "float32_err_vs_plain": [res["float32_err"] for _, res in runs],
        "bfloat16_bit_equal": bf16_equal,
        "float32_max_abs_diff_between": f32_diff,
    }
    for who, res in runs:
        print(f"{who}: bf16 {res['bfloat16_ms']:.4f} ms, float32 "
              f"{res['float32_ms']:.4f} ms (max abs err vs plain "
              f"{res['float32_err']:.3e}, tolerance 1e-4 + 1e-4*|ref|)")
    print(f"bf16 outputs bit-equal across the runs: {bf16_equal}; float32 "
          f"outputs differ by at most {f32_diff:.3e}")
    print(json.dumps(summary))
    ok = all(res["float32_excess"] <= 0 for _, res in runs)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
