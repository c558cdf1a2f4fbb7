"""Sequence-consistent copy-paste augmentation.

A copy of `streammos_tpu/data/copy_paste.py` (numpy only): paste object
instances from a pre-extracted bank into *all* frames of a history window
with a synthesized rigid trajectory, so the pasted object carries a
physically consistent motion label. The draws are taken from the generator
in the same order, so the same seed gives the same arrays.

* object bank: per-instance `.npz` files (keys pcds / cate / cate_id /
  center / size / yaw) grouped by category directory; sequence-08
  instances are excluded at load (08 is the validation sequence);
* a random signed speed is drawn per object, which slides along its yaw
  by ``v * 0.1 s`` per history frame; motion label from |v|: >= 1 m/s ->
  moving (2), < 0.3 -> static (1), else 0 (unlabeled);
* placement: try 20 global rotations (multiples of 18 deg, shuffled);
  accept when the object footprint has local road support (more than 5
  road points inside the box footprint; the object is dropped onto their
  mean height) and its angular wedge is compact (u-range < 8 m,
  phi/theta range < 1 rad) and almost free of existing foreground in
  EVERY frame (< 3 points of raw label 10-32 / 252-259);
* occlusion-consistent insertion: all scene points inside the object's
  (phi, theta) wedge are removed before appending the object; pasted
  points get raw label 30 so later pastes see them as foreground; movable
  ("bf") labels are kept alongside the MOS labels.
"""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

CATEGORIES = ("other-vehicle", "truck", "car", "motorcyclist", "motorcycle",
              "person", "bicycle", "bicyclist")

VELO_RANGES = {
    "other-vehicle": (-15.0, 15.0),
    "truck": (-15.0, 15.0),
    "car": (-15.0, 15.0),
    "motorcyclist": (-8.0, 8.0),
    "motorcycle": (-8.0, 8.0),
    "person": (-3.0, 3.0),
    "bicycle": (-8.0, 8.0),
    "bicyclist": (-8.0, 8.0),
}

PASTED_RAW_LABEL = 30  # raw semantic id given to pasted points


def box_corners_2d(center, size, yaw) -> np.ndarray:
    """(4, 2) footprint corners of an oriented box."""
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s], [s, c]])
    l, w = size[0] / 2.0, size[1] / 2.0
    local = np.array([[l, w], [l, -w], [-l, -w], [-l, w]])
    return local @ rot.T + np.asarray(center[:2])


def points_in_quad(points_2d: np.ndarray, quad: np.ndarray) -> np.ndarray:
    """Vectorized convex-quad membership (replaces per-attempt Delaunay)."""
    inside = np.ones(points_2d.shape[0], dtype=bool)
    # ensure consistent winding
    area = 0.0
    for i in range(4):
        a, b = quad[i], quad[(i + 1) % 4]
        area += a[0] * b[1] - b[0] * a[1]
    sign = 1.0 if area > 0 else -1.0
    for i in range(4):
        a, b = quad[i], quad[(i + 1) % 4]
        cross = ((b[0] - a[0]) * (points_2d[:, 1] - a[1])
                 - (b[1] - a[1]) * (points_2d[:, 0] - a[0]))
        inside &= sign * cross >= 0
    return inside


def _rotate_z(arr: np.ndarray, theta_deg: float) -> np.ndarray:
    t = np.deg2rad(theta_deg)
    rot = np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]],
                   dtype=arr.dtype)
    out = arr.copy()
    out[:, :2] = arr[:, :2] @ rot
    return out


def _angles(pcds: np.ndarray):
    x, y, z = pcds[:, 0], pcds[:, 1], pcds[:, 2]
    d = np.sqrt(x * x + y * y + z * z) + 1e-12
    u = np.sqrt(x * x + y * y) + 1e-12
    phi = np.arctan2(x, y)
    theta = np.arcsin(z / d)
    return u, phi, theta


class SequenceCutPaste:
    def __init__(self, object_dir: str, paste_max_obj_num: int = 20,
                 exclude_seq: str = "08"):
        self.object_dir = object_dir
        self.paste_max_obj_num = paste_max_obj_num
        self.bank = {}
        for cate in CATEGORIES:
            fpath = os.path.join(object_dir, cate)
            if not os.path.isdir(fpath):
                continue
            files = [os.path.join(fpath, x) for x in sorted(os.listdir(fpath))
                     if x.endswith(".npz") and x.split("_")[0] != exclude_seq]
            if files:
                self.bank[cate] = files

    def _make_trajectory(self, fname: str, seq_num: int,
                         rng: np.random.Generator):
        npkl = np.load(fname)
        pcds_obj = np.asarray(npkl["pcds"], dtype=np.float32)
        cate = str(npkl["cate"])
        center = np.asarray(npkl["center"], dtype=np.float64)
        size = np.asarray(npkl["size"], dtype=np.float64) * 1.05
        yaw = float(npkl["yaw"])

        lo, hi = VELO_RANGES[cate]
        velo = float(rng.uniform(lo, hi))
        velo_x = -velo * np.sin(yaw)
        velo_y = velo * np.cos(yaw)

        corners = box_corners_2d(center, size, yaw)
        frames = []
        for t in range(seq_num):
            obj = pcds_obj.copy()
            obj[:, 0] -= velo_x * t * 0.1
            obj[:, 1] -= velo_y * t * 0.1
            obj[:, :3] += rng.normal(0, 0.001, size=(obj.shape[0], 3))
            cor = corners.copy()
            cor[:, 0] -= velo_x * t * 0.1
            cor[:, 1] -= velo_y * t * 0.1
            frames.append((obj, cor))
        return frames, abs(velo)

    @staticmethod
    def _wedge(pcds_obj: np.ndarray):
        u, phi, theta = _angles(pcds_obj)
        return ((u.min(), u.max()), (phi.min(), phi.max()),
                (theta.min(), theta.max()))

    @staticmethod
    def _valid_position(pcds, raw_labels, pcds_obj, scan_angles=None):
        """(ok, wedge_mask): the object's angular wedge must be compact and
        nearly free of existing foreground in this frame.

        ``scan_angles``: optional precomputed (phi, theta) of ``pcds`` — the
        scan is unchanged across the ~20 rotation attempts x frames of a
        paste, so its angles are computed once."""
        (u0, u1), (p0, p1), (t0, t1) = SequenceCutPaste._wedge(pcds_obj)
        if not (abs(u1 - u0) < 8 and abs(p1 - p0) < 1 and abs(t1 - t0) < 1):
            return False, None
        if scan_angles is None:
            _, phi, theta = _angles(pcds)
        else:
            phi, theta = scan_angles
        mask = ((phi >= p0) & (phi < p1) & (theta >= t0) & (theta < t1))
        raw_in = raw_labels[mask]
        n_fg = (((raw_in >= 10) & (raw_in < 33))
                | ((raw_in >= 252) & (raw_in < 260))).sum()
        return bool(n_fg < 3), mask

    def _paste_one(self, scans, labels, bf_labels, roads, raw_labels,
                   rng: np.random.Generator, angle_cache=None) -> bool:
        cates = sorted(self.bank)
        cate = cates[int(rng.integers(len(cates)))]
        fname = self.bank[cate][int(rng.integers(len(self.bank[cate])))]
        frames, velo = self._make_trajectory(fname, len(scans), rng)
        if len(frames[0][0]) < 10:
            return False

        if velo >= 1:
            motion_label = 2
        elif velo < 0.3:
            motion_label = 1
        else:
            motion_label = 0

        thetas = np.arange(0, 360, 18).astype(np.float64)
        rng.shuffle(thetas)
        for theta in thetas:
            aug = [( _rotate_z(obj, theta), _rotate_z(cor, theta))
                   for obj, cor in frames]

            road = roads[0]
            if road.shape[0] == 0:
                return False
            support = points_in_quad(road[:, :2], aug[0][1][:4])
            local_road = road[support]
            if local_road.shape[0] <= 5:
                continue
            height = float(local_road[:, 2].mean())
            for obj, _cor in aug:
                obj[:, 2] += height - obj[:, 2].min()

            checks = []
            for t in range(len(aug)):
                angles = None
                if angle_cache is not None:
                    if angle_cache[t] is None:
                        # (named s_* so they can't shadow the rotation angle
                        # `theta` from the enclosing loop)
                        _, s_phi, s_theta = _angles(scans[t])
                        angle_cache[t] = (s_phi, s_theta)
                    angles = angle_cache[t]
                checks.append(self._valid_position(scans[t], raw_labels[t],
                                                   aug[t][0], angles))
            if not all(ok for ok, _ in checks):
                continue

            for t in range(len(aug)):
                mask = checks[t][1]
                keep = ~mask
                obj = aug[t][0]
                n_obj = obj.shape[0]
                scans[t] = np.concatenate([scans[t][keep], obj])
                labels[t] = np.concatenate(
                    [labels[t][keep],
                     np.full(n_obj, motion_label, labels[t].dtype)])
                bf_labels[t] = np.concatenate(
                    [bf_labels[t][keep],
                     np.full(n_obj, 2, bf_labels[t].dtype)])  # movable fg
                raw_labels[t] = np.concatenate(
                    [raw_labels[t][keep],
                     np.full(n_obj, PASTED_RAW_LABEL, raw_labels[t].dtype)])
                if angle_cache is not None:
                    angle_cache[t] = None  # scan changed — invalidate
            return True
        return False

    def __call__(self, scans: List[np.ndarray], labels: List[np.ndarray],
                 bf_labels: List[np.ndarray], roads: List[np.ndarray],
                 raw_labels: List[np.ndarray], rng: np.random.Generator
                 ) -> Tuple[List[np.ndarray], List[np.ndarray], List[np.ndarray]]:
        if not self.bank:
            return scans, labels, bf_labels
        scans = [s.copy() for s in scans]
        labels = [l.copy() for l in labels]
        bf_labels = [b.copy() for b in bf_labels]
        raw_labels = [r.copy() for r in raw_labels]
        n = int(rng.integers(0, self.paste_max_obj_num + 1))
        angle_cache = [None] * len(scans)
        for _ in range(n):
            self._paste_one(scans, labels, bf_labels, roads, raw_labels, rng,
                            angle_cache)
        return scans, labels, bf_labels
