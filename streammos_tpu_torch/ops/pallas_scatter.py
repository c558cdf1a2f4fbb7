"""Scatter-max of rows sorted by cell id: `voxel_max_pool(impl="pallas")`.

Counterpart of `streammos_tpu/ops/pallas_scatter.py` (the module keeps that
name so a reader finds the counterpart). `sorted_scatter_max` launches the
hand-written CUDA kernel `csrc/sorted_scatter.cu` for CUDA tensors (it
replaces the TPU kernel built by `_make_kernel` there) and runs the plain
version `sorted_scatter_max_reference` for CPU tensors. There is no other
path: a CUDA tensor the kernel cannot take raises.

The front end stays outside the kernel, as in JAX: `scatter_max_pallas`
sorts the ids and gathers the rows into that order. The kernel starts from
the sorted rows and cuts them into chunks of rows, so its work follows the
row count whatever the skew (the design is in the source's header). Empty
cells are 0; an occupied cell holds the max of its rows, negative or not.
Ids outside [0, n_cells) are dropped (n_cells is the sentinel of invalid
points).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from streammos_tpu_torch.build import load_library
from streammos_tpu_torch.utils import profiling


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
    if not 1 <= n_cells < 2 ** 31:
        raise ValueError(f"n_cells {n_cells} out of the int32 range")
    if feats_sorted.shape[0] >= 2 ** 31:
        raise ValueError(f"{feats_sorted.shape[0]} rows: out of the int32 "
                         f"range")


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("sorted_scatter")
    lib.streammos_sorted_scatter_plan.restype = ctypes.c_longlong
    lib.streammos_sorted_scatter_plan.argtypes = [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn = lib.streammos_sorted_scatter_max
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_void_p])
    return lib


@functools.lru_cache(maxsize=256)
def launch_plan(P: int, n_cells: int, C: int, itemsize: int) -> dict:
    """The kernel's launch shape for P rows of C channels into n_cells
    cells: levels, the first level's chunks, threads (16-byte path) and
    rows a chunk, and the workspace bytes. Builds the kernel if it is not
    built yet."""
    info = (ctypes.c_int * 4)()
    nbytes = _library().streammos_sorted_scatter_plan(P, n_cells, C, itemsize,
                                                      info)
    if nbytes < 0:
        raise ValueError(f"no plan for {P} rows x {C} into {n_cells} cells")
    return {"levels": info[0], "chunks": info[1], "threads": info[2],
            "rows_per_chunk": info[3], "workspace_bytes": nbytes}


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
    plan = launch_plan(P, n_cells, C, feats_sorted.element_size())
    work = torch.empty(plan["workspace_bytes"], dtype=torch.uint8, device=dev)
    out = torch.empty((n_cells, C), dtype=feats_sorted.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().streammos_sorted_scatter_max(
            feats_sorted.data_ptr(), ids_sorted.data_ptr(), P, out.data_ptr(),
            n_cells, C, work.data_ptr(),
            int(feats_sorted.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"sorted scatter kernel launch failed: CUDA error "
                           f"{err}")
    profiling.count("kernel.sorted_scatter")
    return out


def scatter_max_pallas(feat: torch.Tensor, flat_ids: torch.Tensor,
                       n_cells_total: int) -> torch.Tensor:
    """Front end: feat (R, C) unsorted rows, flat_ids (R,) in
    [0, n_cells_total] (the sentinel marks invalid rows). Sorts, gathers the
    rows into that order, runs `sorted_scatter_max`; returns
    (n_cells_total, C)."""
    ids_sorted, perm = torch.sort(flat_ids.to(torch.int32))
    return sorted_scatter_max(feat.index_select(0, perm), ids_sorted,
                              n_cells_total)
