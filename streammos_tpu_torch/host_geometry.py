"""Host-side geometry of the input pipeline, in numpy: the rigid transform
and range crop of a scan, its spherical (range-view) projection, and the
KITTI calibration and pose files.

A copy of `streammos_tpu/geometry.py:np_transform`, `np_filter_mask`,
`np_sphere_quantize`, `parse_calibration` and `parse_poses` (importing that
module imports jax).
The arithmetic is the same, so the same files give the same arrays bit for
bit. No torch here: the dataset workers import this module.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def np_transform(pcds: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """Rigid/homogeneous transform of the xyz channels: pcds (..., C>=3),
    mat (4, 4); the other channels pass through unchanged."""
    xyz_h = pcds[..., :3] @ np.swapaxes(mat[:3, :3], -1, -2) + mat[:3, 3]
    return np.concatenate((xyz_h, pcds[..., 3:]), axis=-1)


def np_filter_mask(pcds: np.ndarray, range_x, range_y, range_z) -> np.ndarray:
    """In-range crop mask: min-inclusive, max-exclusive on each axis."""
    vx = (pcds[..., 0] >= range_x[0]) & (pcds[..., 0] < range_x[1])
    vy = (pcds[..., 1] >= range_y[0]) & (pcds[..., 1] < range_y[1])
    vz = (pcds[..., 2] >= range_z[0]) & (pcds[..., 2] < range_z[1])
    return vx & vy & vz


def np_sphere_quantize(pcds: np.ndarray, phi_range, theta_range, size
                       ) -> np.ndarray:
    """Cartesian -> fractional range-view coords (..., 2): row 0 the
    vertical (theta) coordinate, row 1 the horizontal (phi), both as
    fractional indices into an (H, W) range image."""
    H, W = size
    phi_lo, phi_hi = (phi_range[0] * np.pi / 180.0, phi_range[1] * np.pi / 180.0)
    th_lo, th_hi = (theta_range[0] * np.pi / 180.0, theta_range[1] * np.pi / 180.0)
    dphi = (phi_hi - phi_lo) / W
    dtheta = (th_hi - th_lo) / H

    x = pcds[..., 0]
    y = pcds[..., 1]
    z = pcds[..., 2]
    d = np.sqrt(x * x + y * y + z * z) + 1e-12

    phi = phi_hi - np.arctan2(x, y)
    phi_quan = phi / dphi
    theta = th_hi - np.arcsin(z / d)
    theta_quan = theta / dtheta
    return np.stack((theta_quan, phi_quan), axis=-1)


def _read_3x4(values) -> np.ndarray:
    pose = np.zeros((4, 4))
    pose[0, :4] = values[0:4]
    pose[1, :4] = values[4:8]
    pose[2, :4] = values[8:12]
    pose[3, 3] = 1.0
    return pose


def parse_calibration(filename: str) -> Dict[str, np.ndarray]:
    """Read a KITTI calib.txt into {key: 4x4}."""
    calib = {}
    with open(filename, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            key, content = line.split(":", 1)
            calib[key] = _read_3x4([float(v) for v in content.strip().split()])
    return calib


def parse_poses(filename: str, calibration: Dict[str, np.ndarray]
                ) -> List[np.ndarray]:
    """Per-scan poses in the LiDAR frame: Tr^-1 . P . Tr."""
    Tr = calibration["Tr"]
    Tr_inv = np.linalg.inv(Tr)
    poses = []
    with open(filename, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            pose = _read_3x4([float(v) for v in line.split()])
            poses.append(Tr_inv @ pose @ Tr)
    return poses
