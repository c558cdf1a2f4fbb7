"""Grid -> point bilinear gather, `F.grid_sample(align_corners=True,
padding_mode='zeros')` at ``p = coord * scale_rate`` in pixel space.

Counterpart of `streammos_tpu/ops/sample.py:grid_to_point` (plain XLA
there), as four masked row gathers and a weighted sum.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def bilinear_at_pixels(grid: torch.Tensor, py: torch.Tensor,
                       px: torch.Tensor) -> torch.Tensor:
    """Sample grid (B, H, W, C) at pixel coords py/px (B, N) -> (B, N, C).
    A tap outside [0, H-1] x [0, W-1] contributes 0."""
    B, H, W, C = grid.shape
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    fy = (py - y0).to(grid.dtype)
    fx = (px - x0).to(grid.dtype)
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)
    flat = grid.reshape(B * H * W, C)
    base = (torch.arange(B, device=grid.device) * (H * W))[:, None]
    out = None
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            y = y0i + dy
            x = x0i + dx
            ok = (y >= 0) & (y < H) & (x >= 0) & (x < W)
            idx = base + y.clamp(0, H - 1) * W + x.clamp(0, W - 1)
            rows = flat.index_select(0, idx.reshape(-1)).reshape(B, -1, C)
            w = (wy * wx * ok).to(grid.dtype)
            term = rows * w[..., None]
            out = term if out is None else out + term
    return out


def grid_to_point(grid: torch.Tensor, coords: torch.Tensor,
                  scale_rate: Sequence[float]) -> torch.Tensor:
    """grid (B, H, W, C); coords (B, N, 2) as (row, col) in unscaled grid
    units. Returns (B, N, C). The positions are the coords scaled in
    float32, as `grid_to_point_tta` forms them; only the tap weights take
    the grid's dtype. A deliberate difference from the JAX op, which rounds
    the coords to the grid's dtype before scaling: in bfloat16 that moves a
    position in [256, 512) by up to 2 cells."""
    py = coords[..., 0].float() * float(np.float32(scale_rate[0]))
    px = coords[..., 1].float() * float(np.float32(scale_rate[1]))
    return bilinear_at_pixels(grid, py, px)


def grid_to_point_ref(grid: np.ndarray, coords: np.ndarray,
                      scale_rate: Sequence[float]) -> np.ndarray:
    """NumPy reference implementation for parity tests."""
    B, H, W, C = grid.shape
    N = coords.shape[1]
    out = np.zeros((B, N, C), dtype=grid.dtype)
    for b in range(B):
        for n in range(N):
            py = coords[b, n, 0] * scale_rate[0]
            px = coords[b, n, 1] * scale_rate[1]
            y0 = int(np.floor(py))
            x0 = int(np.floor(px))
            fy = py - y0
            fx = px - x0
            acc = np.zeros(C, dtype=np.float64)
            for dy, wy in ((0, 1 - fy), (1, fy)):
                for dx, wx in ((0, 1 - fx), (1, fx)):
                    yy, xx = y0 + dy, x0 + dx
                    if 0 <= yy < H and 0 <= xx < W:
                        acc += wy * wx * grid[b, yy, xx]
            out[b, n] = acc.astype(grid.dtype)
    return out
