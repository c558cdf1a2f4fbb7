"""Scatter-max of rows sorted by cell id: `voxel_max_pool(impl="pallas")`.

Counterpart of `streammos_tpu/ops/pallas_scatter.py` (the module keeps that
name so a reader finds the counterpart). `sorted_scatter_max` launches the
hand-written CUDA kernel `csrc/sorted_scatter.cu` for CUDA tensors (it
replaces the TPU kernel built by `_make_kernel` there) and runs the plain
version `sorted_scatter_max_reference` for CPU tensors. There is no other
path: a CUDA tensor the kernel cannot take raises.

The front end stays outside the kernel, as in JAX: `scatter_max_pallas`
sorts the ids, gathers the rows into that order, and `sorted_scatter_max`
finds each tile's row range with `searchsorted`. The kernel starts from
the sorted rows. Empty cells are 0; an occupied cell holds the max of its
rows, negative or not. Ids outside [0, n_cells) are dropped (n_cells is
the sentinel of invalid points).
"""
from __future__ import annotations

import ctypes

import torch

from streammos_tpu_torch.build import load_library

# Cells a tile. One tile is walked by the threads of one row of channels;
# 16 cells gives the smallest in-model grid (the stage-1 range view, 8192
# cells) 512 tiles, enough to fill 132 SMs (the TPU kernel's 1024 would give
# 8). Any cell count works: the last tile may be partial.
TILE_CELLS = 16


def sorted_scatter_max_reference(feats_sorted: torch.Tensor,
                                 ids_sorted: torch.Tensor,
                                 n_cells: int) -> torch.Tensor:
    """Plain version: a segmented max over the sorted rows (a log-step
    max-scan within runs of equal ids), each run's last row placed in its
    cell. feats_sorted (P, C), ids_sorted (P,) ascending. Returns
    (n_cells, C) in feats_sorted's dtype; empty cells 0."""
    P, C = feats_sorted.shape
    ids = ids_sorted.to(torch.int64)
    v = feats_sorted
    s = 1
    while s < P:
        same = (ids[s:] == ids[:-s])[:, None]
        v = torch.cat([v[:s], torch.where(same, torch.maximum(v[s:], v[:-s]),
                                          v[s:])])
        s *= 2
    run_end = torch.ones(P, dtype=torch.bool, device=ids.device)
    run_end[:-1] = ids[1:] != ids[:-1]
    run_end &= (ids >= 0) & (ids < n_cells)
    out = feats_sorted.new_zeros((n_cells, C))
    out[ids[run_end]] = v[run_end]
    return out


def _check(feats_sorted, ids_sorted, n_cells) -> None:
    if feats_sorted.dim() != 2 or ids_sorted.shape != feats_sorted.shape[:1]:
        raise ValueError(f"need feats (P, C) and ids (P,), got "
                         f"{tuple(feats_sorted.shape)} and "
                         f"{tuple(ids_sorted.shape)}")
    if not 1 <= n_cells < 2 ** 31 - TILE_CELLS:
        raise ValueError(f"n_cells {n_cells} out of the int32 range")


def sorted_scatter_max(feats_sorted: torch.Tensor, ids_sorted: torch.Tensor,
                       n_cells: int) -> torch.Tensor:
    """feats_sorted (P, C) rows sorted by cell id, ids_sorted (P,) int32
    ascending in [0, n_cells] (n_cells = invalid sentinel, sorted to the
    end). Returns (n_cells, C) per-cell maxima, empty cells 0. CUDA tensors
    launch the kernel; CPU tensors run `sorted_scatter_max_reference`."""
    _check(feats_sorted, ids_sorted, n_cells)
    if feats_sorted.device.type == "cpu":
        return sorted_scatter_max_reference(feats_sorted, ids_sorted, n_cells)
    if not feats_sorted.is_cuda or ids_sorted.device != feats_sorted.device:
        raise ValueError(f"no sorted scatter for devices {feats_sorted.device}"
                         f", {ids_sorted.device}")
    if feats_sorted.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"sorted scatter kernel takes float32 or bfloat16, "
                        f"got {feats_sorted.dtype}")
    if ids_sorted.dtype != torch.int32:
        raise TypeError(f"sorted scatter kernel takes int32 ids, got "
                        f"{ids_sorted.dtype}")
    if not (feats_sorted.is_contiguous() and ids_sorted.is_contiguous()):
        raise ValueError("feats_sorted and ids_sorted must be contiguous")
    P, C = feats_sorted.shape
    dev = feats_sorted.device
    n_tiles = -(-n_cells // TILE_CELLS)
    bounds = (torch.arange(n_tiles + 1, device=dev, dtype=torch.int32)
              * TILE_CELLS).clamp_(max=n_cells)
    starts = torch.searchsorted(ids_sorted, bounds).to(torch.int32)
    out = torch.empty((n_cells, C), dtype=feats_sorted.dtype, device=dev)
    fn = load_library("sorted_scatter").streammos_sorted_scatter_max
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(feats_sorted.data_ptr(), ids_sorted.data_ptr(),
                 starts.data_ptr(), out.data_ptr(), n_cells, C, TILE_CELLS,
                 int(feats_sorted.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"sorted scatter kernel launch failed: CUDA error "
                           f"{err}")
    sorted_scatter_max.launches += 1
    return out


sorted_scatter_max.launches = 0


def scatter_max_pallas(feat: torch.Tensor, flat_ids: torch.Tensor,
                       n_cells_total: int) -> torch.Tensor:
    """Front end: feat (R, C) unsorted rows, flat_ids (R,) in
    [0, n_cells_total] (the sentinel marks invalid rows). Sorts, gathers the
    rows into that order, runs `sorted_scatter_max`; returns
    (n_cells_total, C)."""
    ids_sorted, perm = torch.sort(flat_ids.to(torch.int32))
    return sorted_scatter_max(feat.index_select(0, perm), ids_sorted,
                              n_cells_total)
