"""Scatter-max of non-negative rows into a zeroed grid:
`voxel_max_pool(impl="vmem")`.

Counterpart of `streammos_tpu/ops/pallas_scatter_vmem.py` (the module keeps
that name so a reader finds the counterpart). `scatter_max_vmem` launches
the hand-written CUDA kernel `csrc/scatter_grid.cu` for CUDA tensors (it
replaces the TPU kernel `_kernel` there) and runs the plain version
`scatter_max_vmem_reference` for CPU tensors. There is no other path: a
CUDA tensor the kernel cannot take raises.

The kernel maxes the rows straight into the one output grid with atomics
that the card's L2 resolves; the TPU kernel's K copies of the grid are not
kept. Semantics are `voxel_max_pool(..., nonneg=True)`: a zero grid the
points max into; ids outside [0, num_cells), of either sign, go to the
sentinel row and are dropped.

`fits_vmem` and `_num_copies` are JAX's, constants included, so both
packages accept and reject the same shapes; the constants describe the
TPU's VMEM budget, not the card, and K sizes no buffer here.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from streammos_tpu_torch.build import load_library
from streammos_tpu_torch.utils import profiling

BN = 1024  # points per grid step of the TPU kernel (in the copy budget)
VMEM_TOTAL = 127 * 1024 * 1024
SPILL_ALLOWANCE = 52 * 1024 * 1024
MAX_COPIES = 8


def _num_copies(cells_pad: int, C: int, itemsize: int) -> int:
    """K: grid copies inside the TPU kernel's budget, a power of two."""
    grid_bytes = cells_pad * C * itemsize
    budget = (VMEM_TOTAL - SPILL_ALLOWANCE - grid_bytes
              - 4 * BN * C * itemsize)
    k = budget // grid_bytes
    k = int(max(0, min(MAX_COPIES, k)))
    return 1 << (k.bit_length() - 1) if k else 0


def _cells_pad(num_cells: int) -> int:
    return -(-(num_cells + 1) // 8) * 8


def fits_vmem(num_cells: int, C: int, itemsize: int) -> bool:
    return C % 128 == 0 and _num_copies(_cells_pad(num_cells), C, itemsize) >= 2


def scatter_max_vmem_reference(feat: torch.Tensor, ids: torch.Tensor,
                               num_cells: int) -> torch.Tensor:
    """Plain version: route out-of-range ids to a sentinel row, max every
    row into a zero grid (B, num_cells + 1, C), drop the sentinel row."""
    B, N, C = feat.shape
    ids = ids.to(torch.int64)
    ids = torch.where((ids < 0) | (ids > num_cells), num_cells, ids)
    out = feat.new_zeros((B, num_cells + 1, C))
    out.scatter_reduce_(1, ids[..., None].expand(B, N, C), feat, "amax",
                        include_self=True)
    return out[:, :num_cells]


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("scatter_grid")
    lib.streammos_scatter_grid_plan.restype = ctypes.c_int
    lib.streammos_scatter_grid_plan.argtypes = [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn = lib.streammos_scatter_max_grid
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return lib


def launch_plan(points: int, C: int, itemsize: int) -> dict:
    """The kernel's launch shape for `points` (B * N) points of C channels:
    the grid copies it keeps, the points a thread takes and the threads of
    its update pass. Builds the kernel if it is not built yet."""
    info = (ctypes.c_longlong * 3)()
    if _library().streammos_scatter_grid_plan(points, C, itemsize, info) != 0:
        raise ValueError(f"no plan for {points} points x {C} channels of "
                         f"{itemsize} bytes")
    return {"copies": info[0], "points_per_thread": info[1],
            "threads": info[2]}


def scatter_max_vmem(feat: torch.Tensor, ids: torch.Tensor,
                     num_cells: int) -> torch.Tensor:
    """Scatter-max (B, N, C) non-negative rows into (B, num_cells, C).

    ids (B, N) int32 cell ids; ids outside [0, num_cells) (num_cells is the
    sentinel of invalid points) are dropped. Empty cells are 0. Takes the
    shapes `fits_vmem` accepts, on either device. CUDA tensors launch the
    kernel; CPU tensors run `scatter_max_vmem_reference`."""
    if feat.dim() != 3 or ids.shape != feat.shape[:2]:
        raise ValueError(f"need feat (B, N, C) and ids (B, N), got "
                         f"{tuple(feat.shape)} and {tuple(ids.shape)}")
    B, N, C = feat.shape
    if not fits_vmem(num_cells, C, feat.element_size()):
        raise ValueError(f"grid ({num_cells} cells x {C} ch, itemsize "
                         f"{feat.element_size()}) fails fits_vmem: needs "
                         f"C % 128 == 0 and >= 2 of the TPU kernel's grid copies")
    if feat.device.type == "cpu":
        return scatter_max_vmem_reference(feat, ids, num_cells)
    if not feat.is_cuda or ids.device != feat.device:
        raise ValueError(f"no grid scatter for devices {feat.device}, "
                         f"{ids.device}")
    if feat.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"grid scatter kernel takes float32 or bfloat16, "
                        f"got {feat.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"grid scatter kernel takes int32 ids, got {ids.dtype}")
    if not (feat.is_contiguous() and ids.is_contiguous()):
        raise ValueError("feat and ids must be contiguous")
    dev = feat.device
    out = torch.empty((B, num_cells, C), dtype=feat.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().streammos_scatter_max_grid(
            feat.data_ptr(), ids.data_ptr(), out.data_ptr(), B, N, num_cells,
            C, int(feat.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"grid scatter kernel launch failed: CUDA error "
                           f"{err}")
    profiling.count("kernel.scatter_grid")
    return out
