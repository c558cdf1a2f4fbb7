"""Point-cloud geometry on torch tensors: BEV quantization, spherical
(range-view) projection and the 7-channel point feature.

Counterpart of `streammos_tpu/geometry.py:_quantize`, `_sphere_quantize` and
`_make_point_feat`. The arithmetic is float32 in the same order as there:
the cell ids downstream are truncation casts of these coordinates, so a
reordered or re-rounded formula moves points near a cell boundary into the
neighbouring cell. XLA compiles a division by a constant into a multiply by
its float32 reciprocal, so the port multiplies by that reciprocal too; with
it `quantize` agrees bit for bit with the jitted JAX function. Python
constants enter as tensors of the input's dtype on its device, built once
(`profiling.constant`).

`sphere_quantize` cannot agree bit for bit: XLA:CPU's float32 sqrt-of-sum and
asin differ from torch's in the last place for a few percent of points, so a
range-view cell id can differ for a point within one ulp of a cell boundary.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from streammos_tpu_torch.utils.profiling import constant


def _const(x: torch.Tensor, value: float) -> torch.Tensor:
    # keyed by the exact double (0.0 and -0.0 compare equal)
    return constant(float.fromhex, float(value).hex(), device=x.device,
                    dtype=x.dtype)


def quantize(pcds: torch.Tensor, range_x: Sequence[float],
             range_y: Sequence[float], range_z: Sequence[float],
             size: Sequence[int]) -> torch.Tensor:
    """Cartesian (..., >=3) -> fractional BEV grid coords (..., 3)."""
    outs = []
    for d, rng in enumerate((range_x, range_y, range_z)):
        step = (rng[1] - rng[0]) / size[d]
        outs.append((pcds[..., d] - _const(pcds, rng[0]))
                    * _const(pcds, 1.0 / step))
    return torch.stack(outs, dim=-1)


def sphere_quantize(pcds: torch.Tensor, phi_range: Sequence[float],
                    theta_range: Sequence[float],
                    size: Sequence[int]) -> torch.Tensor:
    """Cartesian -> fractional range-view coords (..., 2) as (theta row,
    phi column) indices into an (H, W) range image."""
    H, W = size
    phi_lo, phi_hi = (phi_range[0] * math.pi / 180.0, phi_range[1] * math.pi / 180.0)
    th_lo, th_hi = (theta_range[0] * math.pi / 180.0, theta_range[1] * math.pi / 180.0)
    dphi = (phi_hi - phi_lo) / W
    dtheta = (th_hi - th_lo) / H
    x, y, z = pcds[..., 0], pcds[..., 1], pcds[..., 2]
    d = torch.sqrt(x * x + y * y + z * z) + _const(pcds, 1e-12)
    phi = _const(pcds, phi_hi) - torch.atan2(x, y)
    phi_quan = phi * _const(pcds, 1.0 / dphi)
    theta = _const(pcds, th_hi) - torch.asin(z / d)
    theta_quan = theta * _const(pcds, 1.0 / dtheta)
    return torch.stack((theta_quan, phi_quan), dim=-1)


def make_point_feat(pcds_xyzi: torch.Tensor,
                    pcds_coord: torch.Tensor) -> torch.Tensor:
    """(x, y, z, intensity, dist, diff_x, diff_y): diff_* are the fractional
    parts of the BEV grid coordinates."""
    x, y, z = pcds_xyzi[..., 0], pcds_xyzi[..., 1], pcds_xyzi[..., 2]
    intensity = pcds_xyzi[..., 3]
    dist = torch.sqrt(x * x + y * y + z * z) + _const(pcds_xyzi, 1e-12)
    diff_x = pcds_coord[..., 0] - torch.floor(pcds_coord[..., 0])
    diff_y = pcds_coord[..., 1] - torch.floor(pcds_coord[..., 1])
    return torch.stack((x, y, z, intensity, dist, diff_x, diff_y), dim=-1)
