"""Point-cloud augmentation with shared random draws.

A copy of `streammos_tpu/data/augment.py`: one sample's windows and frames
share a single draw of shift / scale / flips / rotation (`AugParams`),
while Gaussian noise is redrawn per call. Order of operations: noise ->
shift -> scale -> flips -> rotate. The draws are taken from the generator
in the same order, so the same seed gives the same arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from streammos_tpu_torch.config import AugConfig


@dataclasses.dataclass
class AugParams:
    shift_xyz: Tuple[float, float, float]
    scale: float
    h_flip: bool
    v_flip: bool
    theta_z_deg: float


def draw_params(rng: np.random.Generator, cfg: AugConfig) -> AugParams:
    def uni(r):
        return float(rng.uniform(r[0], r[1]))

    return AugParams(
        shift_xyz=(uni(cfg.shift_range[0]), uni(cfg.shift_range[1]),
                   uni(cfg.shift_range[2])),
        scale=uni(cfg.size_range),
        h_flip=bool(rng.random() < 0.5),
        v_flip=bool(rng.random() < 0.5),
        theta_z_deg=uni(cfg.theta_range),
    )


def apply(pcds: np.ndarray, params: AugParams, cfg: AugConfig,
          rng: np.random.Generator) -> np.ndarray:
    """pcds (N, C>=3); returns a new array with xyz augmented."""
    out = pcds.copy()
    if cfg.noise_std > 0:
        out[:, :3] += rng.normal(cfg.noise_mean, cfg.noise_std,
                                 size=(out.shape[0], 3))
    out[:, 0] += params.shift_xyz[0]
    out[:, 1] += params.shift_xyz[1]
    out[:, 2] += params.shift_xyz[2]
    out[:, :3] *= params.scale
    if params.v_flip:
        out[:, 0] *= -1
    if params.h_flip:
        out[:, 1] *= -1
    t = np.deg2rad(params.theta_z_deg)
    rot = np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]],
                   dtype=out.dtype)
    out[:, :2] = out[:, :2] @ rot
    return out
