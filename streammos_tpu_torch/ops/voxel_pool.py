"""Scatter voxel max-pooling, forward only.

Counterpart of `streammos_tpu/ops/voxel_pool.py:voxel_max_pool` (there an
XLA scatter, not a Pallas kernel), in plain torch: linearize the cell ids,
route invalid points to a sentinel row, `scatter_reduce_(..., "amax")`, drop
the sentinel row.

Semantics: per point and grid dim, ``cell_d = int(float32(ind_d) *
float32(scale_d))`` truncated toward zero; a point is valid iff every cell_d
lies in [0, out_size_d). Empty cells are 0; an occupied cell holds the max
over its points, negative or not.

No backward: torch's "amax" reduction splits a tied cell's gradient among
the ties, while the JAX op gives every tie the full gradient.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

PhaseSplit = Union[bool, str]


def _cell_ids(inds: torch.Tensor, out_size: Sequence[int],
              scale_rate: Sequence[float], phase_split: PhaseSplit = False,
              row_pad: int = 0) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Flattened cell id per point, validity mask and cell count.

    inds (..., N, D) fractional grid coords. Returns (flat (..., N) int64
    with invalid points at ``num_cells``, valid (..., N) bool, num_cells).

    phase_split=True (D == 2): ``((cx>>1 + row_pad)*(W/2) + (cy>>1))*4 +
    (cx&1)*2 + (cy&1)``, the (rows, W/2, 4) space-to-depth layout.
    phase_split="outer": ``(phase*rows + (cx>>1) + row_pad)*(W/2) + (cy>>1)``
    with phase = 2*(cx&1) + (cy&1), the (4, rows, W/2) layout the fused
    header reads. ``rows = H/2 + 2*row_pad``: row_pad always-empty half-res
    rows above and below each plane.
    """
    D = len(out_size)
    cells = []
    valid = torch.ones(inds.shape[:-1], dtype=torch.bool, device=inds.device)
    for d in range(D):
        scale = torch.tensor(np.float32(scale_rate[d]), device=inds.device)
        cell = (inds[..., d].to(torch.float32) * scale).to(torch.int32)
        valid &= (cell >= 0) & (cell < out_size[d])
        cells.append(cell.to(torch.int64))
    if phase_split:
        if D != 2 or out_size[0] % 2 or out_size[1] % 2:
            raise ValueError(f"phase_split needs an even 2-D grid, got {out_size}")
        cx, cy = cells
        rows = out_size[0] // 2 + 2 * row_pad
        wh = out_size[1] // 2
        if phase_split == "outer":
            phase = (cx & 1) * 2 + (cy & 1)
            flat = (phase * rows + (cx >> 1) + row_pad) * wh + (cy >> 1)
        elif phase_split is True:
            flat = ((((cx >> 1) + row_pad) * wh + (cy >> 1)) * 4
                    + (cx & 1) * 2 + (cy & 1))
        else:
            raise ValueError(f"unknown phase_split {phase_split!r}")
        num_cells = rows * wh * 4
    else:
        num_cells = int(np.prod(out_size))
        flat = torch.zeros_like(cells[0])
        stride = num_cells
        for d in range(D):
            stride //= int(out_size[d])
            flat = flat + cells[d] * stride
    flat = torch.where(valid, flat, torch.full_like(flat, num_cells))
    return flat, valid, num_cells


def grid_shape(out_size: Sequence[int], phase_split: PhaseSplit = False,
               row_pad: int = 0) -> Tuple[int, ...]:
    """Per-batch dense output shape (without channels) of a layout."""
    if not phase_split:
        return tuple(int(s) for s in out_size)
    H, W = out_size
    rows = H // 2 + 2 * row_pad
    if phase_split == "outer":
        return (4, rows, W // 2)
    return (rows, W // 2, 4)


def voxel_max_pool(feat: torch.Tensor, inds: torch.Tensor,
                   out_size: Sequence[int], scale_rate: Sequence[float],
                   nonneg: bool = False, phase_split: PhaseSplit = False,
                   row_pad: int = 0) -> torch.Tensor:
    """Scatter-max (B, N, C) point features into a dense grid.

    inds (B, N, D) fractional grid coords. Returns (B, *out_size, C), or the
    phase layouts of `_cell_ids` / `grid_shape`.

    nonneg: the caller promises feat >= 0, and the grid is a zero grid that
    the points max into (the JAX op's zero-fill scatter). Otherwise empty
    cells are 0 and an occupied cell takes only its points' max, so a
    negative max is kept.
    """
    B, N, C = feat.shape
    flat, valid, num_cells = _cell_ids(inds, out_size, scale_rate,
                                       phase_split, row_pad)
    offsets = torch.arange(B, device=feat.device, dtype=torch.int64)[:, None]
    flat_global = torch.where(valid, flat + offsets * num_cells,
                              torch.full_like(flat, B * num_cells))
    # one extra sentinel row takes the invalid points and is dropped
    pooled = torch.zeros((B * num_cells + 1, C), dtype=feat.dtype,
                         device=feat.device)
    idx = flat_global.reshape(-1, 1).expand(-1, C)
    pooled.scatter_reduce_(0, idx, feat.reshape(-1, C), "amax",
                           include_self=nonneg)
    out_shape = (B,) + grid_shape(out_size, phase_split, row_pad) + (C,)
    return pooled[:-1].reshape(out_shape)


def voxel_max_pool_ref(feat: np.ndarray, inds: np.ndarray,
                       out_size: Sequence[int],
                       scale_rate: Sequence[float]) -> np.ndarray:
    """Slow, obviously-correct NumPy reference (plain layout)."""
    B, N, C = feat.shape
    out = np.zeros((B,) + tuple(out_size) + (C,), dtype=feat.dtype)
    filled = np.zeros((B,) + tuple(out_size), dtype=bool)
    D = len(out_size)
    for b in range(B):
        for n in range(N):
            cell = []
            for d in range(D):
                c = int(np.float32(inds[b, n, d]) * np.float32(scale_rate[d]))
                if not 0 <= c < out_size[d]:
                    break
                cell.append(c)
            else:
                idx = (b,) + tuple(cell)
                if filled[idx]:
                    out[idx] = np.maximum(out[idx], feat[b, n])
                else:
                    out[idx] = feat[b, n]
                    filled[idx] = True
    return out
