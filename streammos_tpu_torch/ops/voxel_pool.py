"""Scatter voxel max-pooling, forward and backward.

Counterpart of `streammos_tpu/ops/voxel_pool.py:voxel_max_pool`: linearize
the cell ids, then one of the same `impl`s as the JAX op:

- "auto" and "xla": plain torch, the counterpart of JAX's XLA scatter:
  route invalid points to a sentinel row, `scatter_reduce_(..., "amax")`,
  drop the sentinel row. The main path takes it.
- "pallas": the sorted scatter (`ops/pallas_scatter.py`, CUDA kernel
  `csrc/sorted_scatter.cu`) over the batch-global cell ids. Unlike JAX, which
  takes the XLA path when B*num_cells is not a multiple of its 1024-cell
  tile, the kernel takes any cell count.
- "vmem": the one-grid scatter (`ops/pallas_scatter_vmem.py`, CUDA kernel
  `csrc/scatter_grid.cu`) over the per-batch cell ids. As in JAX it needs
  ``nonneg=True`` and a grid `fits_vmem` accepts, else ValueError. Unlike
  JAX, which raises off the TPU, a CPU tensor runs the plain version.

On CPU tensors every impl runs plain torch; on CUDA tensors "pallas" and
"vmem" launch their kernels or raise.

Semantics: per point and grid dim, ``cell_d = int(float32(ind_d) *
float32(scale_d))`` truncated toward zero; a point is valid iff every cell_d
lies in [0, out_size_d). Empty cells are 0; an occupied cell holds the max
over its points, negative or not.

Backward (JAX's `_bwd`, for every impl): each valid point whose value equals
its cell's max gets the cell's full gradient, ties included; invalid points
get 0. torch's own "amax" backward would split a tied cell's gradient among
the ties, so the op is a `torch.autograd.Function`.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from streammos_tpu_torch.ops import pallas_scatter, pallas_scatter_vmem
from streammos_tpu_torch.utils.profiling import constant

IMPLS = ("auto", "xla", "pallas", "vmem")

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
        scale = constant(np.float32, scale_rate[d], device=inds.device)
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


def _scatter(feat: torch.Tensor, flat: torch.Tensor, valid: torch.Tensor,
             num_cells: int, nonneg: bool, impl: str) -> torch.Tensor:
    """(B, N, C) rows, per-batch cell ids -> (B, num_cells, C)."""
    B, N, C = feat.shape
    if impl == "vmem":
        return pallas_scatter_vmem.scatter_max_vmem(
            feat.contiguous(), flat.to(torch.int32), num_cells)
    offsets = torch.arange(B, device=feat.device, dtype=torch.int64)[:, None]
    flat_global = torch.where(valid, flat + offsets * num_cells,
                              torch.full_like(flat, B * num_cells))
    if impl == "pallas":
        return pallas_scatter.scatter_max_pallas(
            feat.reshape(-1, C), flat_global.reshape(-1),
            B * num_cells).reshape(B, num_cells, C)
    # one extra sentinel row takes the invalid points and is dropped
    pooled = torch.zeros((B * num_cells + 1, C), dtype=feat.dtype,
                         device=feat.device)
    idx = flat_global.reshape(-1, 1).expand(-1, C)
    pooled.scatter_reduce_(0, idx, feat.reshape(-1, C), "amax",
                           include_self=nonneg)
    return pooled[:-1].reshape(B, num_cells, C)


class _VoxelMaxPool(torch.autograd.Function):
    """Forward: `_scatter`. Backward: JAX's `_bwd`, gradients to every point
    equal to its cell's max."""

    @staticmethod
    def forward(ctx, feat, flat, valid, num_cells, nonneg, impl):
        out = _scatter(feat, flat, valid, num_cells, nonneg, impl)
        ctx.save_for_backward(feat, flat, valid, out)
        return out

    @staticmethod
    def backward(ctx, g):
        feat, flat, valid, out = ctx.saved_tensors
        C = feat.shape[-1]
        num_cells = out.shape[1]
        safe = flat.clamp(max=num_cells - 1)[..., None].expand(-1, -1, C)
        cell_max = torch.gather(out, 1, safe)
        cell_grad = torch.gather(g.to(out.dtype), 1, safe)
        is_max = valid[..., None] & (feat == cell_max)
        grad = torch.where(is_max, cell_grad, 0)
        return grad.to(feat.dtype), None, None, None, None, None


def voxel_max_pool(feat: torch.Tensor, inds: torch.Tensor,
                   out_size: Sequence[int], scale_rate: Sequence[float],
                   nonneg: bool = False, phase_split: PhaseSplit = False,
                   row_pad: int = 0, *, impl: str = "auto") -> torch.Tensor:
    """Scatter-max (B, N, C) point features into a dense grid.

    inds (B, N, D) fractional grid coords. Returns (B, *out_size, C), or the
    phase layouts of `_cell_ids` / `grid_shape`. Differentiable in feat.

    nonneg: the caller promises feat >= 0, and the grid is a zero grid that
    the points max into (the JAX op's zero-fill scatter). Otherwise empty
    cells are 0 and an occupied cell takes only its points' max, so a
    negative max is kept.

    impl: "auto" / "xla" (plain torch), "pallas" (sorted scatter kernel) or
    "vmem" (one-grid scatter kernel, needs nonneg and `fits_vmem`); see the
    module docstring.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    B, N, C = feat.shape
    flat, valid, num_cells = _cell_ids(inds, out_size, scale_rate,
                                       phase_split, row_pad)
    if impl == "vmem" and not nonneg:
        raise ValueError("impl='vmem' requires nonneg=True (the kernel "
                         "max-es into a zeroed grid)")
    out = _VoxelMaxPool.apply(feat, flat, valid, num_cells, nonneg, impl)
    return out.reshape((B,) + grid_shape(out_size, phase_split, row_pad) + (C,))


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
