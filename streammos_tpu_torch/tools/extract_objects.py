"""Build the copy-paste object bank from SemanticKITTI instance labels.

Counterpart of `tools/extract_objects.py` of the JAX package. The
reference ships a pre-built `object_bank_semkitti` directory whose
per-instance `.npz` layout `data/copy_paste.py:SequenceCutPaste` reads
(keys: pcds, cate, cate_id, center, size, yaw). This tool scans the
training sequences, groups points by (semantic class, instance id), fits
an oriented footprint box (PCA yaw), and writes one `.npz` per instance
observation:

    python -m streammos_tpu_torch.tools.extract_objects \
        --data /path/sequences --out object_bank_semkitti --min-points 40
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from streammos_tpu_torch.data import semantic_kitti as sk

CATE_BY_RAW = {
    10: "car",
    11: "bicycle",
    13: "other-vehicle",  # bus mapped to other-vehicle in the taxonomy
    15: "motorcycle",
    16: "other-vehicle",  # on-rails
    18: "truck",
    20: "other-vehicle",
    30: "person",
    31: "bicyclist",
    32: "motorcyclist",
}


def fit_box(points: np.ndarray):
    """Oriented footprint box via 2D PCA; returns (center, size, yaw)."""
    xy = points[:, :2]
    mean = xy.mean(axis=0)
    cov = np.cov((xy - mean).T) + np.eye(2) * 1e-9
    evals, evecs = np.linalg.eigh(cov)
    major = evecs[:, int(np.argmax(evals))]
    yaw = float(np.arctan2(major[1], major[0]))
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, s], [-s, c]])
    local = (xy - mean) @ rot.T
    l = float(local[:, 0].max() - local[:, 0].min())
    w = float(local[:, 1].max() - local[:, 1].min())
    z0, z1 = float(points[:, 2].min()), float(points[:, 2].max())
    cx, cy = mean + rot.T @ np.array(
        [(local[:, 0].max() + local[:, 0].min()) / 2,
         (local[:, 1].max() + local[:, 1].min()) / 2])
    center = np.array([cx, cy, (z0 + z1) / 2])
    size = np.array([max(l, 0.1), max(w, 0.1), max(z1 - z0, 0.1)])
    return center, size, yaw


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True)
    ap.add_argument("--out", default="object_bank_semkitti")
    ap.add_argument("--min-points", type=int, default=40)
    ap.add_argument("--stride", type=int, default=5,
                    help="sample every k-th frame")
    args = ap.parse_args(argv)

    count = 0
    for seq in sk.SPLITS["train"]:
        seq_id = str(seq).rjust(2, "0")
        vel = os.path.join(args.data, seq_id, "velodyne")
        lab = os.path.join(args.data, seq_id, "labels")
        if not os.path.isdir(vel):
            continue
        files = sorted(os.listdir(vel))[::args.stride]
        for fname in files:
            fid = fname.split(".")[0]
            pts = np.fromfile(os.path.join(vel, fname),
                              dtype=np.float32).reshape(-1, 4)
            raw = np.fromfile(os.path.join(lab, fid + ".label"),
                              dtype=np.uint32)
            sem, inst = sk.split_label(raw)
            sem_base = np.where(sem >= 252, sem - 242, sem)  # moving -> base
            for raw_id, cate in CATE_BY_RAW.items():
                cls_mask = sem_base == raw_id
                if not cls_mask.any():
                    continue
                for iid in np.unique(inst[cls_mask]):
                    m = cls_mask & (inst == iid)
                    if m.sum() < args.min_points:
                        continue
                    obj = pts[m]
                    center, size, yaw = fit_box(obj)
                    out_dir = os.path.join(args.out, cate)
                    os.makedirs(out_dir, exist_ok=True)
                    np.savez(os.path.join(
                        out_dir, f"{seq_id}_{fid}_{iid}.npz"),
                        pcds=obj, cate=cate, cate_id=raw_id,
                        center=center, size=size, yaw=yaw)
                    count += 1
        print(f"seq {seq_id} done ({count} instances so far)")
    print(f"wrote {count} instances to {args.out}")


if __name__ == "__main__":
    main()
