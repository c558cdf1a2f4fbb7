"""Long-term-memory refinement CLI: voxel voting (and, with ``--instance``,
instance voting) over saved prediction files, then the IoU of the refined
labels.

    python -m streammos_tpu_torch.tools.voting --config StreamMOS_seg \
        --tag base --data /path/sequences --instance [--vote numpy]
        [--device cpu]

Counterpart of `tools/voting.py` of the JAX package, with the same flags
and the same output tree. Reads
`experiments/<cfg>/<tag>/<split>_results/sequences/<seq>/predictions/*.label`
(and `<split>_bf_results/...` for instance voting), writes
`experiments/<cfg>/<tag>/refine_<split>_results/sequences/<seq>/predictions/`,
and on the val split prints the refined IoU.

Backends (``--vote``): ``numpy`` votes in a process pool of spawned
workers, which import numpy and scipy only (a forked child of a process
that holds a CUDA context dies); ``device`` votes with torch on
``--device`` (default cuda; ``cpu`` runs the same torch code on the CPU),
its frames sharing one CUDA context through a thread pool. ``auto``
follows `resolve_vote_backend`. Without CUDA, a device vote raises unless
``--device cpu`` is given; it never falls back to numpy.
"""
from __future__ import annotations

import argparse
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

from streammos_tpu_torch import host_geometry
from streammos_tpu_torch.data import semantic_kitti as sk
from streammos_tpu_torch.postprocess.voting import (crop_mask, gather_history,
                                                    instance_vote, voxel_vote,
                                                    voxel_vote_device)


def _load_pred(path: str) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.uint32)
    return sk.relabel((raw & 0xFFFF).astype(np.int64), sk.LEARNING_MAP)


def _frame(data_dir: str, pred_dir: str, fid: str):
    pts = np.fromfile(os.path.join(data_dir, fid + ".bin"),
                      dtype=np.float32).reshape(-1, 4)
    pred = _load_pred(os.path.join(pred_dir, fid + ".label"))
    return pts, pred


def process_frame(task):
    """Refine one frame and write its label file. ``device`` is None for
    the numpy vote, else the torch device of `voxel_vote_device`."""
    (data_dir, pred_dir, bf_dir, save_dir, fids, fid_idx, poses, voxel,
     use_instance, device) = task
    fid = fids[fid_idx]
    cur_pts, cur_pred = _frame(data_dir, pred_dir, fid)
    inv = np.linalg.inv(poses[fid_idx])

    hist_pts, hist_pred = [], []
    for hid in gather_history(fid_idx, len(fids)):
        pts, pred = _frame(data_dir, pred_dir, fids[hid])
        pts = host_geometry.np_transform(pts, inv @ poses[hid])
        hist_pts.append(pts)
        hist_pred.append(pred)
    if hist_pts:
        hist_pts = np.concatenate(hist_pts)
        hist_pred = np.concatenate(hist_pred)
    else:
        # 1-frame sequence: no history — vote on the current frame alone
        hist_pts = np.zeros((0, cur_pts.shape[1]), cur_pts.dtype)
        hist_pred = np.zeros((0,), cur_pred.dtype)

    hmask = crop_mask(hist_pts, voxel)
    cmask = crop_mask(cur_pts, voxel)
    local_pts = np.concatenate([hist_pts[hmask], cur_pts[cmask]])
    local_pred = np.concatenate([hist_pred[hmask], cur_pred[cmask]])

    args = (local_pts[:, :3], local_pred, cur_pts[cmask][:, :3],
            cur_pred[cmask], voxel)
    refined = (voxel_vote(*args) if device is None
               else voxel_vote_device(*args, device=device))
    out = cur_pred.copy()
    out[cmask] = refined

    if use_instance and bf_dir is not None:
        bf = np.fromfile(os.path.join(bf_dir, fid + ".label"),
                         dtype=np.uint32).astype(np.int64)
        out = instance_vote(cur_pts[:, :3], out, bf, local_pts[:, :3],
                            local_pred)

    os.makedirs(save_dir, exist_ok=True)
    inv_lut = sk.label_lut(sk.LEARNING_MAP_INV)
    inv_lut[out].astype(np.uint32).tofile(os.path.join(save_dir, fid + ".label"))
    return fid


def run_metric(data_root: str, refined_root: str, seq: str = "08"):
    from streammos_tpu_torch.metrics import MultiClassMetric

    label_dir = os.path.join(data_root, seq, "labels")
    pred_dir = os.path.join(refined_root, seq, "predictions")
    metric = MultiClassMetric(["static", "moving"])
    for name in sorted(os.listdir(label_dir)):
        fid = name.split(".")[0]
        raw = np.fromfile(os.path.join(label_dir, name), dtype=np.uint32)
        gt = sk.relabel((raw & 0xFFFF).astype(np.int64), sk.LEARNING_MAP)
        pred = _load_pred(os.path.join(pred_dir, fid + ".label"))
        scores = np.eye(3, dtype=np.float32)[pred]
        metric.add_batch(gt, scores)
    result = metric.get_metric()
    print("; ".join(f"{k}: {v}" for k, v in result.items()))
    return result


def resolve_vote_backend(vote: str) -> bool:
    """Map the --vote choice to use_device (True: the torch vote on
    --device). 'auto' resolves to the device.

    The rule follows the H100's own measurement (`chip_smoke.py`'s voting
    phase, NVIDIA H100 80GB HBM3, 700.00 W, a host of 8 cores): the voting
    CLI with --instance over 12 frames of 125k-point scans, 8 workers,
    took 0.0636 s/frame on the device against 0.2398 in numpy (pool
    start-up included; 0.0283 against 0.0578 after the first frame), and
    one production-size vote (9 scans, 1,081,610 local-map points, the
    (512, 512, 30) grid) 70.6 ms against 260.3 ms of host wall. The JAX
    package's 'auto' takes numpy from a TPU v5e measurement of its own
    (its `tools/voting.py`), which does not carry over. Without CUDA,
    'auto' raises as 'device' does unless --device cpu is given."""
    return vote in ("auto", "device")


def split_sequences(split: str):
    """Sequence dirs per split, zero-padded like the dataset paths."""
    return (["08"] if split == "val"
            else [str(i).rjust(2, "0") for i in range(11, 22)])


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="voxel / instance voting "
                                             "(PyTorch port)")
    ap.add_argument("--config", default="StreamMOS")
    ap.add_argument("--tag", default="base")
    ap.add_argument("--data", required=True, help="sequences dir")
    ap.add_argument("--split", default="val", choices=["val", "test"])
    ap.add_argument("--instance", action="store_true")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--vote", default="auto",
                    choices=["auto", "numpy", "device"],
                    help="voxel-vote backend: 'numpy' votes in a pool of "
                         "spawned processes; 'device' votes with torch on "
                         "--device, frames sharing one CUDA context through "
                         "a thread pool; 'auto' follows "
                         "resolve_vote_backend")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the 'device' backend (default "
                         "cuda; cpu runs the same torch code on the CPU)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from streammos_tpu_torch.config import get_config

    device = None
    if resolve_vote_backend(args.vote):
        from streammos_tpu_torch.serve import resolve_device

        device = str(resolve_device(args.device))  # raises without CUDA

    cfg = get_config(args.config)
    voxel = cfg.model.voxel
    save_path = os.path.join("experiments", cfg.name, args.tag)
    pred_root = os.path.join(save_path, f"{args.split}_results", "sequences")
    bf_root = os.path.join(save_path, f"{args.split}_bf_results", "sequences")
    refined_root = os.path.join(save_path, f"refine_{args.split}_results",
                                "sequences")

    for seq in split_sequences(args.split):
        data_dir = os.path.join(args.data, seq, "velodyne")
        pred_dir = os.path.join(pred_root, seq, "predictions")
        if not os.path.isdir(pred_dir):
            continue
        calib = host_geometry.parse_calibration(
            os.path.join(args.data, seq, "calib.txt"))
        poses = host_geometry.parse_poses(
            os.path.join(args.data, seq, "poses.txt"), calib)
        fids = sorted(f.split(".")[0] for f in os.listdir(data_dir))
        bf_dir = os.path.join(bf_root, seq, "predictions")
        save_dir = os.path.join(refined_root, seq, "predictions")
        tasks = [(data_dir, pred_dir,
                  bf_dir if os.path.isdir(bf_dir) else None, save_dir, fids, i,
                  poses, voxel, args.instance, device)
                 for i in range(len(fids))]
        # the device vote shares one CUDA context -> threads; the numpy
        # vote -> spawned processes (a forked child of a CUDA process dies)
        if device is None:
            pool = ProcessPoolExecutor(
                max_workers=args.workers,
                mp_context=multiprocessing.get_context("spawn"))
        else:
            pool = ThreadPoolExecutor(max_workers=args.workers)
        t0, first = time.perf_counter(), float("nan")
        with pool:
            for i, _ in enumerate(pool.map(process_frame, tasks)):
                if i == 0:
                    first = time.perf_counter() - t0
                if i % 200 == 0:
                    print(f"seq {seq}: {i}/{len(tasks)}", flush=True)
        wall = time.perf_counter() - t0
        print(f"seq {seq}: voted {len(tasks)} frames in {wall:.3f} s, the "
              f"first after {first:.3f} s ("
              f"{'numpy' if device is None else 'device ' + device}, "
              f"{args.workers} workers)", flush=True)

    if args.split == "val":
        run_metric(args.data, refined_root)


if __name__ == "__main__":
    main()
