"""Synthetic LiDAR frames for driving the eval path at production size.

A copy of `bench.py:skewed_scan_bank` (numpy only): the same protocol
feeds the port's card tests, its kernel timing and its trace.
"""
from __future__ import annotations

import numpy as np


def skewed_scan_bank(rng: np.random.Generator, bank: int, T: int,
                     N: int) -> np.ndarray:
    """(bank, 1, T, N, 4) float32 xyzi: 64-beam-like scans over the RV
    elevation range, uniform azimuth, near-heavy range clipped to the BEV
    extent, ~5% of points beyond the crop."""
    shape = (bank, 1, T, N)
    az = rng.uniform(-np.pi, np.pi, shape)
    elev = np.deg2rad(rng.uniform(-25.0, 3.0, shape))
    r = np.minimum(2.5 + rng.exponential(9.0, shape), 69.0)
    far = rng.uniform(0, 1, shape) < 0.04
    r = np.where(far, rng.uniform(55.0, 80.0, shape), r)
    x = r * np.cos(elev) * np.cos(az)
    y = r * np.cos(elev) * np.sin(az)
    z = np.clip(r * np.sin(elev), -3.9, 1.9) + rng.normal(0, 0.05, shape)
    i = rng.uniform(0, 1, shape)
    return np.stack([x, y, z, i], axis=-1).astype(np.float32)
