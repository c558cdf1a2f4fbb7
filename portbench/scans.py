"""The traffic generator: seeded LiDAR scans.

The scan model is the measured package's `scans.skewed_scan_bank` (itself
a copy of the earlier benchmark's), drawn here with torch on the device so
that a bank of full-size scans costs a few milliseconds: 64-beam-like
scans over the range view's elevation band (-25 to 3 degrees), uniform
azimuth, a near-heavy range (2.5 m plus an exponential of mean 9 m, capped
at 69 m) with 4% of the points far (55 to 80 m, about 5% beyond the crop),
heights clipped to the BEV's z range with 5 cm of noise, and a uniform
intensity. Every frame of a bank is drawn independently, so frames differ.
"""
from __future__ import annotations

import math

import torch


def scan_bank(gen: torch.Generator, frames: int, T: int, N: int,
              device) -> torch.Tensor:
    """(frames, T, N, 4) float32 xyzi on `device`."""
    shape = (frames, T, N)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(shape, generator=gen,
                                                    device=device)
    az = u(-math.pi, math.pi)
    elev = u(-25.0, 3.0) * (math.pi / 180.0)
    exp = -torch.log1p(-torch.rand(shape, generator=gen, device=device)) * 9.0
    r = torch.clamp(2.5 + exp, max=69.0)
    far = torch.rand(shape, generator=gen, device=device) < 0.04
    r = torch.where(far, u(55.0, 80.0), r)
    x = r * torch.cos(elev) * torch.cos(az)
    y = r * torch.cos(elev) * torch.sin(az)
    z = torch.clamp(r * torch.sin(elev), -3.9, 1.9) + 0.05 * torch.randn(
        shape, generator=gen, device=device)
    return torch.stack([x, y, z, u(0.0, 1.0)], dim=-1).float()

