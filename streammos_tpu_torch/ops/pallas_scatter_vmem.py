"""Scatter-max of non-negative rows into K interleaved copies of a zeroed
grid: `voxel_max_pool(impl="vmem")`.

Counterpart of `streammos_tpu/ops/pallas_scatter_vmem.py` (the module keeps
that name so a reader finds the counterpart). `scatter_max_vmem` launches
the hand-written CUDA kernel `csrc/scatter_copies.cu` for CUDA tensors (it
replaces the TPU kernel `_kernel` there) and runs the plain version
`scatter_max_vmem_reference` for CPU tensors. There is no other path: a
CUDA tensor the kernel cannot take raises.

Point i of a batch updates copy i mod K, and one max merges the copies.
Semantics are `voxel_max_pool(..., nonneg=True)`: a zero grid the points
max into; ids outside [0, num_cells), of either sign, go to the sentinel
row and are dropped.

`fits_vmem` and `_num_copies` are JAX's, constants included, so both
packages accept and reject the same shapes and use the same K; the
constants describe the TPU's VMEM budget, not the card.
"""
from __future__ import annotations

import ctypes

import torch

from streammos_tpu_torch.build import load_library

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
                         f"C % 128 == 0 and >= 2 grid copies")
    if feat.device.type == "cpu":
        return scatter_max_vmem_reference(feat, ids, num_cells)
    if not feat.is_cuda or ids.device != feat.device:
        raise ValueError(f"no copy scatter for devices {feat.device}, "
                         f"{ids.device}")
    if feat.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"copy scatter kernel takes float32 or bfloat16, "
                        f"got {feat.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"copy scatter kernel takes int32 ids, got {ids.dtype}")
    if not (feat.is_contiguous() and ids.is_contiguous()):
        raise ValueError("feat and ids must be contiguous")
    K = _num_copies(_cells_pad(num_cells), C, feat.element_size())
    dev = feat.device
    copies = torch.empty((B, K, num_cells, C), dtype=feat.dtype, device=dev)
    out = torch.empty((B, num_cells, C), dtype=feat.dtype, device=dev)
    fn = load_library("scatter_copies").streammos_scatter_max_copies
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(feat.data_ptr(), ids.data_ptr(), copies.data_ptr(),
                 out.data_ptr(), B, N, num_cells, C, K,
                 int(feat.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"copy scatter kernel launch failed: CUDA error "
                           f"{err}")
    scatter_max_vmem.launches += 1
    return out


scatter_max_vmem.launches = 0
