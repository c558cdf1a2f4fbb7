"""Production-size synthetic SemanticKITTI sequences, in the real file
formats (`.bin` float32 xyzi scans, `.label` uint32 labels, `calib.txt`,
`poses.txt`), and a synthetic copy-paste object bank: the data of the
dress rehearsal (`tools/dress_rehearsal.py`), on a machine that holds no
real dataset.

`make_big_sequence` is a copy of `tools/bench_pipeline.py:make_big_sequence`
of the JAX package (the same draws from the same seed): a third of each scan
is road (raw class 40), the rest scattered points, 1% of them moving cars
(252); the ego moves 1 m a frame along x. Numpy only.
"""
from __future__ import annotations

import os

import numpy as np


def make_big_sequence(root: str, seq_id: str, n_frames: int, n_points: int,
                      seed: int = 0) -> None:
    """Write `<root>/<seq_id>/` with `n_frames` scans of `n_points` points."""
    rng = np.random.default_rng(seed)
    seq = os.path.join(root, seq_id)
    os.makedirs(os.path.join(seq, "velodyne"), exist_ok=True)
    os.makedirs(os.path.join(seq, "labels"), exist_ok=True)
    with open(os.path.join(seq, "calib.txt"), "w") as f:
        f.write("P0: 1 0 0 0 0 1 0 0 0 0 1 0\nTr: 1 0 0 0 0 1 0 0 0 0 1 0\n")
    with open(os.path.join(seq, "poses.txt"), "w") as f:
        f.write("\n".join(f"1 0 0 {i * 1.0} 0 1 0 0 0 0 1 0"
                          for i in range(n_frames)) + "\n")
    n_road = n_points // 3
    for i in range(n_frames):
        pts = np.concatenate([
            np.stack([rng.uniform(-45, 45, n_road),
                      rng.uniform(-45, 45, n_road),
                      rng.uniform(-1.8, -1.6, n_road),
                      rng.uniform(0, 1, n_road)], -1),
            np.stack([rng.uniform(-45, 45, n_points - n_road),
                      rng.uniform(-45, 45, n_points - n_road),
                      rng.uniform(-1.5, 2.5, n_points - n_road),
                      rng.uniform(0, 1, n_points - n_road)], -1),
        ]).astype(np.float32)
        sem = np.concatenate([
            np.full(n_road, 40, np.uint32),
            np.where(rng.random(n_points - n_road) < 0.01, 252, 50
                     ).astype(np.uint32)])
        pts.tofile(os.path.join(seq, "velodyne", f"{i:06d}.bin"))
        sem.tofile(os.path.join(seq, "labels", f"{i:06d}.label"))


def make_bank(bank_dir: str, rng: np.random.Generator, n_objs: int = 8
              ) -> None:
    """A synthetic copy-paste object bank of `n_objs` cars, in the layout
    `tools/extract_objects.py` writes (`<bank>/car/00_<k>.npz`)."""
    cate_dir = os.path.join(bank_dir, "car")
    os.makedirs(cate_dir, exist_ok=True)
    for k in range(n_objs):
        cx, cy = rng.uniform(6, 20), rng.uniform(-3, 3)
        pcds = np.stack([
            rng.uniform(cx - 1.2, cx + 1.2, 300),
            rng.uniform(cy - 0.9, cy + 0.9, 300),
            rng.uniform(-1.5, -0.4, 300),
            rng.uniform(0, 1, 300)], axis=-1).astype(np.float32)
        np.savez(os.path.join(cate_dir, f"00_{k:04d}.npz"), pcds=pcds,
                 cate="car", cate_id=10,
                 center=np.array([cx, cy, -1.0]),
                 size=np.array([2.5, 2.0, 1.2]), yaw=0.0)
