"""Folded test-time augmentation: the four (x, y) sign-flip variants share
one scatter / gather index structure and ride the channel axis.

Counterpart of `streammos_tpu/ops/tta_fold.py` (plain XLA there). The flips
are bijections of the grid index space: a BEV flip reverses an axis; on the
range view a flip of x reverses the phi column, a flip of y reverses and
rolls it by W/2, a flip of both rolls it by W/2; theta rows never move. So
the port scatters once with the variant-0 cell ids and the variants'
features side by side on channels, then orients each variant's grid; the
gather aligns each variant's grid back to canonical coordinates and reads
all variants' bilinear taps in one row per tap.

`voxel_max_pool_tta` and `grid_to_point_tta` launch the hand-written CUDA
kernels `csrc/scatter_tta.cu` and `csrc/grid_gather_tta.cu` for CUDA tensors
(they replace no TPU kernel: JAX's ops are plain XLA) and run the plain
versions `voxel_max_pool_tta_reference` and `grid_to_point_tta_reference`
for CPU tensors. There is no other path: a CUDA tensor a kernel cannot take
raises. Neither kernel has a backward: the folded layout is eval only.

Variant order: (+x,+y), (+x,-y), (-x,+y), (-x,-y).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from streammos_tpu_torch.build import load_library
from streammos_tpu_torch.ops.voxel_pool import voxel_max_pool
from streammos_tpu_torch.utils import profiling

V_TTA = 4

# per-variant (axis-1, axis-2) transforms in variant order; BEV axes are
# (x_cell, y_cell), RV axes (theta_row, phi_col)
_BEV_TRANSFORMS = (("id", "id"), ("id", "rev"), ("rev", "id"), ("rev", "rev"))
_RV_TRANSFORMS = (("id", "id"), ("id", "revroll"), ("id", "rev"), ("id", "roll"))


def _transforms(kind: str):
    if kind == "bev":
        return _BEV_TRANSFORMS
    if kind == "rv":
        return _RV_TRANSFORMS
    raise ValueError(f"unknown grid kind {kind!r}")


def _orient_axis(grid: torch.Tensor, tr: str, axis: int) -> torch.Tensor:
    """out[..., i, ...] = grid[..., T(i), ...] for the involution T:
    rev i -> size-1-i, roll i -> (i + size/2) % size,
    revroll i -> (size/2 - 1 - i) % size."""
    size = grid.shape[axis]
    if tr == "id":
        return grid
    if tr == "rev":
        return torch.flip(grid, (axis,))
    if tr == "roll":
        return torch.roll(grid, size // 2, dims=axis)
    if tr == "revroll":
        return torch.roll(torch.flip(grid, (axis,)), size // 2, dims=axis)
    raise ValueError(tr)


def orient_grid(grid: torch.Tensor, v: int, kind: str,
                axes: Tuple[int, int]) -> torch.Tensor:
    """Map a canonical-cell grid to variant v's orientation (or back: the
    permutations are involutions)."""
    for axis, tr in zip(axes, _transforms(kind)[v]):
        grid = _orient_axis(grid, tr, axis)
    return grid


LAYOUTS = ("variants", "phase_outer")


def _check_layout(layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; expected one of "
                         f"{LAYOUTS}")


def voxel_max_pool_tta_reference(feat: torch.Tensor, coords0: torch.Tensor,
                                 out_size: Tuple[int, int],
                                 scale_rate: Sequence[float], kind: str,
                                 nonneg: bool = False,
                                 layout: str = "variants") -> torch.Tensor:
    """Plain version of `voxel_max_pool_tta`: one `voxel_max_pool` over the
    variant-0 cell ids with the variants side by side on channels; for
    "variants", then each variant's grid oriented and the four stacked."""
    _check_layout(layout)
    _transforms(kind)  # raises on an unknown kind
    if layout == "phase_outer":
        return voxel_max_pool(feat, coords0[..., :2], out_size, scale_rate,
                              nonneg, phase_split="outer", row_pad=1)
    B, N, VC = feat.shape
    if VC % V_TTA:
        raise ValueError(f"folded width {VC} is not a multiple of {V_TTA}")
    C = VC // V_TTA
    H, W = out_size
    grid = voxel_max_pool(feat, coords0[..., :2], out_size, scale_rate, nonneg)
    grid = grid.reshape(B, H, W, V_TTA, C)
    return torch.stack([orient_grid(grid[..., v, :], v, kind, (1, 2))
                        for v in range(V_TTA)])


@functools.lru_cache(maxsize=None)
def _scatter_library():
    lib = load_library("scatter_tta")
    fn = lib.streammos_scatter_tta
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 2 + [ctypes.c_float] * 2
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return lib


def voxel_max_pool_tta(feat: torch.Tensor, coords0: torch.Tensor,
                       out_size: Tuple[int, int],
                       scale_rate: Sequence[float], kind: str,
                       nonneg: bool = False,
                       layout: str = "variants") -> torch.Tensor:
    """Scatter all variants in one max-pool.

    feat (B, N, V*C) variants folded as v-major channel blocks; coords0
    (B, N, >=2) variant-0 fractional coords. Returns, for layout
    "variants", (V, B, H, W, C), each variant's grid in its own
    orientation; for "phase_outer", (B, 4, H/2 + 2, W/2, V*C), the
    canonical grid in `voxel_max_pool(..., phase_split="outer",
    row_pad=1)`'s layout, which the fused header reads. CPU tensors run
    `voxel_max_pool_tta_reference`. CUDA tensors launch the kernel:
    nonneg=True, float32 or bfloat16 features whose C channels fill whole
    16-byte slices (channels innermost, rows 16-byte aligned), float32
    coordinates, an even grid; anything else raises. The kernel's output
    carries no gradient."""
    _check_layout(layout)
    _transforms(kind)  # raises on an unknown kind
    if feat.dim() != 3 or feat.shape[2] % V_TTA:
        raise ValueError(f"need feat (B, N, {V_TTA} * C), got "
                         f"{tuple(feat.shape)}")
    B, N, VC = feat.shape
    if (coords0.dim() != 3 or coords0.shape[:2] != feat.shape[:2]
            or coords0.shape[2] < 2):
        raise ValueError(f"need coords0 ({B}, {N}, >=2), got "
                         f"{tuple(coords0.shape)}")
    if feat.device.type == "cpu" and coords0.device.type == "cpu":
        return voxel_max_pool_tta_reference(feat, coords0, out_size,
                                            scale_rate, kind, nonneg, layout)
    if not feat.is_cuda or coords0.device != feat.device:
        raise ValueError(f"no TTA scatter for devices {feat.device}, "
                         f"{coords0.device}")
    if not nonneg:
        raise ValueError("the TTA scatter kernel needs nonneg=True (it maxes "
                         "into a zeroed grid)")
    if feat.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"TTA scatter kernel takes float32 or bfloat16 "
                        f"features, got {feat.dtype}")
    if coords0.dtype != torch.float32:
        raise TypeError(f"TTA scatter kernel takes float32 coordinates, got "
                        f"{coords0.dtype}")
    H, W = (int(s) for s in out_size)
    if H < 2 or W < 2 or H % 2 or W % 2:
        raise ValueError(f"TTA scatter kernel needs an even grid, got "
                         f"{tuple(out_size)}")
    C, item = VC // V_TTA, feat.element_size()
    strides = feat.stride()
    if (C * item % 16 or strides[2] != 1 or feat.data_ptr() % 16
            or any(s * item % 16 for s in strides[:2])):
        raise ValueError(f"TTA scatter kernel needs C * itemsize a multiple "
                         f"of 16 bytes and the channels innermost, rows "
                         f"16-byte aligned: C={C}, {feat.dtype}, strides "
                         f"{strides}")
    outer = layout == "phase_outer"
    shape = ((B, 4, H // 2 + 2, W // 2, VC) if outer
             else (V_TTA, B, H, W, C))
    dev = feat.device
    out = torch.empty(shape, dtype=feat.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _scatter_library().streammos_scatter_tta(
            feat.data_ptr(), coords0.data_ptr(), out.data_ptr(), B, N, H, W,
            C, (ctypes.c_longlong * 3)(*strides),
            (ctypes.c_longlong * 3)(*coords0.stride()),
            float(np.float32(scale_rate[0])), float(np.float32(scale_rate[1])),
            int(kind == "rv"), int(outer), int(feat.dtype == torch.bfloat16),
            stream)
    if err != 0:
        raise RuntimeError(f"TTA scatter kernel launch failed: CUDA error "
                           f"{err}")
    profiling.count("kernel.scatter_tta")
    return out


def _ext_table(grid: torch.Tensor, tr: str, axis: int) -> torch.Tensor:
    """Extended tap table along `axis` (size + 2 slots): slot j holds the
    variant's value at canonical position (j - 1) + s, where s = -1 for the
    reversed transforms and 0 otherwise; out-of-range slots are zero."""
    size = grid.shape[axis]
    zshape = list(grid.shape)
    zshape[axis] = 1
    zero = grid.new_zeros(zshape)
    if tr == "id":
        return torch.cat([zero, grid, zero], dim=axis)
    if tr == "rev":
        return torch.cat([zero, zero, torch.flip(grid, (axis,))], dim=axis)
    if tr == "roll":
        r = torch.roll(grid, 1 - size // 2, dims=axis)
        return torch.cat([r, r.narrow(axis, 0, 2)], dim=axis)
    if tr == "revroll":
        r = torch.roll(torch.flip(grid, (axis,)), 2 - size // 2, dims=axis)
        return torch.cat([r, r.narrow(axis, 0, 2)], dim=axis)
    raise ValueError(tr)


def _axis_weights(transform: str, size: int, p: torch.Tensor, dtype):
    """The two bilinear tap weights of one axis of one variant at canonical
    pixel coord p, with the zero-padding validity of the variant's true tap
    folded in, including the wrap seam of rolled axes: the taps sit at
    offsets (0, 1) for id/roll and (-1, 0) for rev/revroll."""
    x0 = torch.floor(p)
    f = (p - x0).to(dtype)
    x0i = x0.to(torch.int64)
    inb = (x0i >= 0) & (x0i <= size - 1)
    if transform == "id":
        return ((1 - f) * inb.to(dtype),
                f * ((x0i >= -1) & (x0i <= size - 2)).to(dtype))
    if transform == "rev":
        return ((1 - f) * ((x0i >= 1) & (x0i <= size)).to(dtype),
                f * inb.to(dtype))
    if transform == "revroll":
        return ((1 - f) * (inb & (x0i != size // 2)).to(dtype),
                f * inb.to(dtype))
    if transform == "roll":
        return ((1 - f) * inb.to(dtype),
                f * (inb & (x0i != size // 2 - 1)).to(dtype))
    raise ValueError(transform)


def grid_to_point_tta_reference(grids: torch.Tensor, coords0: torch.Tensor,
                                scale_rate: Sequence[float],
                                kind: str) -> torch.Tensor:
    """Plain version: bilinear-sample all variants with one row gather per
    tap from a stack of extended tables, one a variant, aligned to canonical
    coordinates."""
    V, B, H, W, C = grids.shape
    if V != V_TTA:
        raise ValueError(f"expected {V_TTA} variants, got {V}")
    dt = grids.dtype
    trs = _transforms(kind)
    py = coords0[..., 0].to(torch.float32) * float(np.float32(scale_rate[0]))
    px = coords0[..., 1].to(torch.float32) * float(np.float32(scale_rate[1]))

    # align every variant to canonical coordinates over the extended window,
    # pre-shifted by its tap base, so all variants' taps share slots
    aligned = [_ext_table(_ext_table(grids[v], trs[v][0], 1), trs[v][1], 2)
               for v in range(V)]
    Hp, Wp = H + 2, W + 2
    table = torch.stack(aligned, dim=-2).reshape(B * Hp * Wp, V * C)

    y0 = torch.floor(py).to(torch.int64)
    x0 = torch.floor(px).to(torch.int64)
    yc = y0.clamp(-1, H) + 1
    xc = x0.clamp(-1, W) + 1
    base = (yc * Wp + xc
            + (torch.arange(B, device=grids.device) * Hp * Wp)[:, None])
    last = B * Hp * Wp - 1
    # a point far outside the grid: the clamp moved its window, kill it
    guard = ((yc - 1 == y0) & (xc - 1 == x0)).to(dt)

    wy = [_axis_weights(trs[v][0], H, py, dt) for v in range(V)]
    wx = [_axis_weights(trs[v][1], W, px, dt) for v in range(V)]
    out = None
    for dy in range(2):
        for dx in range(2):
            idx = (base + (dy * Wp + dx)).clamp(max=last)
            t = table.index_select(0, idx.reshape(-1)).reshape(B, -1, V, C)
            wk = torch.stack([wy[v][dy] * wx[v][dx] for v in range(V)],
                             dim=-1)  # (B, N, V)
            term = t * wk[..., None]
            out = term if out is None else out + term
    return (out * guard[..., None, None]).reshape(B, -1, V * C)


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("grid_gather_tta")
    fn = lib.streammos_grid_gather_tta
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 2 + [ctypes.c_float] * 2
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    return lib


def grid_to_point_tta(grids: torch.Tensor, coords0: torch.Tensor,
                      scale_rate: Sequence[float], kind: str) -> torch.Tensor:
    """Bilinear-sample all variants at the points.

    grids (V, B, H, W, C) per-variant grids in their own orientations;
    coords0 (B, N, 2) variant-0 coords in unscaled grid units. Returns
    (B, N, V*C), the per-variant samples folded as v-major channel blocks.
    CPU tensors run `grid_to_point_tta_reference`. CUDA tensors launch the
    kernel: float32 or bfloat16 grids whose C channels fill whole 32-byte
    runs and whose channels (16-byte aligned) or columns are the innermost
    axis, and float32 coordinates; anything else raises."""
    if grids.dim() != 5 or grids.shape[0] != V_TTA:
        raise ValueError(f"need grids ({V_TTA}, B, H, W, C), got "
                         f"{tuple(grids.shape)}")
    V, B, H, W, C = grids.shape
    if (coords0.dim() != 3 or coords0.shape[0] != B
            or coords0.shape[2] < 2):
        raise ValueError(f"need coords0 ({B}, N, 2), got "
                         f"{tuple(coords0.shape)}")
    _transforms(kind)  # raises on an unknown kind
    if grids.device.type == "cpu" and coords0.device.type == "cpu":
        return grid_to_point_tta_reference(grids, coords0, scale_rate, kind)
    if not grids.is_cuda or coords0.device != grids.device:
        raise ValueError(f"no TTA gather for devices {grids.device}, "
                         f"{coords0.device}")
    if grids.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"TTA gather kernel takes float32 or bfloat16 grids, "
                        f"got {grids.dtype}")
    if coords0.dtype != torch.float32:
        raise TypeError(f"TTA gather kernel takes float32 coordinates, got "
                        f"{coords0.dtype}")
    item = grids.element_size()
    strides = grids.stride()
    if strides[4] == 1:
        aligned = (grids.data_ptr() % 16 == 0
                   and all(s * item % 16 == 0 for s in strides[:4]))
    else:
        aligned = strides[3] == 1
    if C * item % 32 or not aligned:
        raise ValueError(f"TTA gather kernel needs C * itemsize a multiple of "
                         f"32 bytes and the channels (16-byte aligned) or the "
                         f"columns innermost: C={C}, {grids.dtype}, strides "
                         f"{strides}")
    N = coords0.shape[1]
    dev = grids.device
    out = torch.empty((B, N, V * C), dtype=grids.dtype, device=dev)
    scratch = (None if strides[4] == 1 else
               torch.empty((V, B, H, W, C), dtype=grids.dtype, device=dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().streammos_grid_gather_tta(
            grids.data_ptr(), coords0.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), B, N, H, W, C,
            (ctypes.c_longlong * 5)(*strides),
            (ctypes.c_longlong * 3)(*coords0.stride()),
            float(np.float32(scale_rate[0])), float(np.float32(scale_rate[1])),
            int(kind == "rv"), int(grids.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"TTA gather kernel launch failed: CUDA error {err}")
    profiling.count("kernel.grid_gather_tta")
    return out
