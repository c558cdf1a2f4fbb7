"""Production-config dress rehearsal: the two training stages, the
streaming eval and the voting, run in one working directory as a user runs
them, at the production configs, on a synthetic production-size
SemanticKITTI tree (125k-point scans; `tools/synthetic.py`):

  1. tools.train  --config StreamMOS      (stage 1: 130k points, copy-paste
     on, a few optimizer steps, epoch-end checkpoint, in-train val of 08)
  2. tools.train  --config StreamMOS_seg  (stage 2: grafts the stage-1
     checkpoint, trains only the refine head)
  3. tools.val    --config StreamMOS_seg  (streaming eval, TTA x4, 160k
     points, `.label` and bf-label files)
  4. tools.voting --instance              (voxel and instance voting, then
     the IoU of the refined labels)

Counterpart of `tools/dress_rehearsal.py` of the JAX package, with its
phases, defaults, assertions and JSON lines: one line a phase (wall
seconds) and a `dress_rehearsal` summary. Each phase runs the port's CLI
as ``python -m streammos_tpu_torch.tools.<name>`` on the CUDA card. The
labels are synthetic: the rehearsal finds faults of shape, memory and IO
in the assembled system, and claims no accuracy.

    python -m streammos_tpu_torch.tools.dress_rehearsal [--root DIR]
        [--steps 20] [--steps2 8] [--frames 24] [--val-frames 8]
        [--batch-size 1] [--keep]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _run(tag, module, args, cwd):
    """Run ``python -m streammos_tpu_torch.tools.<module> <args>``; print
    its phase line; exit with its output on failure."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-m", f"streammos_tpu_torch.tools.{module}", *args]
    t0 = time.time()
    res = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                         text=True)
    dt = time.time() - t0
    if res.returncode != 0:
        print(res.stdout[-4000:], file=sys.stderr)
        print(res.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"[{tag}] FAILED after {dt:.1f}s: {' '.join(cmd)}")
    print(json.dumps({"phase": tag, "wall_s": round(dt, 1)}), flush=True)
    return res.stdout


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None,
                    help="working dir (default: a temp dir, removed unless "
                         "--keep)")
    ap.add_argument("--steps", type=int, default=20,
                    help="stage-1 optimizer steps")
    ap.add_argument("--steps2", type=int, default=8,
                    help="stage-2 optimizer steps")
    ap.add_argument("--frames", type=int, default=24,
                    help="train-sequence frames (>= steps + history margin)")
    ap.add_argument("--val-frames", type=int, default=8)
    ap.add_argument("--points-on-disk", type=int, default=125000,
                    help="synthetic scan size (real sequence-08 scans hold "
                         "about 120-125k in-range points)")
    ap.add_argument("--batch-size", type=int, default=1,
                    help="train batch (1 = the production pick; 3 = the "
                         "reference's batch a GPU)")
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args(argv)

    from streammos_tpu_torch.config import get_config
    from streammos_tpu_torch.tools.synthetic import make_bank, make_big_sequence

    root = args.root or tempfile.mkdtemp(prefix="smtorch_rehearsal_")
    os.makedirs(root, exist_ok=True)
    data = os.path.join(root, "sequences")
    # the train CLI looks for the config's copy-paste bank beside --data
    bank = os.path.join(root,
                        get_config("StreamMOS").train.copy_paste.obj_bank_dir)
    rng = np.random.default_rng(0)

    t0 = time.time()
    if not os.path.isdir(os.path.join(data, "00")):
        make_big_sequence(data, "00", n_frames=args.frames,
                          n_points=args.points_on_disk)
        make_big_sequence(data, "08", n_frames=args.val_frames,
                          n_points=args.points_on_disk, seed=1)
        make_bank(bank, rng)
    print(json.dumps({"phase": "make_data", "wall_s": round(
        time.time() - t0, 1), "frames": args.frames + args.val_frames,
        "points": args.points_on_disk}), flush=True)

    total0 = time.time()
    _run("stage1_train", "train",
         ["--config", "StreamMOS", "--tag", "rehearsal", "--data", data,
          "--epochs", "1", "--max-steps", str(args.steps),
          "--batch-size", str(args.batch_size), "--start-val-epoch", "0"],
         cwd=root)
    exp1 = os.path.join(root, "experiments", "StreamMOS", "rehearsal")
    ckpt1 = os.path.join(exp1, "checkpoint")
    assert os.path.isfile(os.path.join(ckpt1, "0000", "state.pt")), \
        "stage-1 ckpt missing"
    with open(os.path.join(exp1, "record_0.txt")) as f:
        assert "moving_iou" in f.read(), "in-train val metric missing"

    _run("stage2_train", "train",
         ["--config", "StreamMOS_seg", "--tag", "rehearsal", "--data", data,
          "--epochs", "1", "--max-steps", str(args.steps2),
          "--batch-size", str(args.batch_size),
          "--checkpoint", ckpt1, "--ckpt-epoch", "0", "--no-val"],
         cwd=root)

    _run("streaming_eval", "val",
         ["--config", "StreamMOS_seg", "--tag", "rehearsal", "--data", data],
         cwd=root)
    exp2 = os.path.join(root, "experiments", "StreamMOS_seg", "rehearsal")
    preds = os.path.join(exp2, "val_results", "sequences", "08",
                         "predictions")
    n_preds = len(os.listdir(preds))
    assert n_preds == args.val_frames, f"eval wrote {n_preds} labels"
    bf = os.path.join(exp2, "val_bf_results", "sequences", "08",
                      "predictions")
    assert os.path.isdir(bf) and len(os.listdir(bf)) == args.val_frames, \
        "stage-2 bf labels missing"

    vote_out = _run("voting_instance", "voting",
                    ["--config", "StreamMOS_seg", "--tag", "rehearsal",
                     "--data", data, "--instance", "--workers", "4"],
                    cwd=root)
    refined = os.path.join(exp2, "refine_val_results", "sequences", "08",
                           "predictions")
    n_refined = len(os.listdir(refined))
    assert n_refined == args.val_frames, f"voting wrote {n_refined} labels"

    with open(os.path.join(exp2, "record_0.txt")) as f:
        record = f.read()
    total = time.time() - total0
    print(json.dumps({
        "metric": "dress_rehearsal",
        "ok": True,
        "total_wall_s": round(total, 1),
        "stage1_steps": args.steps,
        "stage2_steps": args.steps2,
        "batch_size_per_device": args.batch_size,
        "val_frames": args.val_frames,
        "refined_frames": n_refined,
        "artifacts": {
            "stage1_ckpt": ckpt1,
            "val_labels": preds,
            "bf_labels": bf,
            "refined_labels": refined,
        },
        "record_tail": record.strip().splitlines()[-1][:200]
        if record.strip() else "",
        "voting_tail": vote_out.strip().splitlines()[-1][:200]
        if vote_out.strip() else "",
    }), flush=True)

    if not args.keep and args.root is None:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
