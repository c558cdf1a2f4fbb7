"""ctypes bindings of the native loader (`loader.cpp`).

Each function mirrors a numpy-path operation of `data/dataset.py` with the
same semantics (see the header of loader.cpp). The library builds at the
first call (`native/build.py`); a failed build raises, and the datasets
take the numpy path only when asked (``native=False``).
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Sequence, Tuple

import numpy as np

from streammos_tpu_torch.native import build as build_lib

# the most points one scan may hold (loader.cpp's CAP in
# smt_assemble_eval_frame)
SCAN_CAP = 1 << 21


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_lib.build()))
    i64, u64 = ctypes.c_int64, ctypes.c_uint64
    fp = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    dp = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.smt_load_scan.restype = i64
    lib.smt_load_scan.argtypes = [ctypes.c_char_p, fp, i64]
    lib.smt_load_labels.restype = i64
    lib.smt_load_labels.argtypes = [ctypes.c_char_p, u32p, i64]
    lib.smt_transform.restype = None
    lib.smt_transform.argtypes = [fp, i64, dp]
    lib.smt_filter.restype = i64
    lib.smt_filter.argtypes = [fp, i64, fp, fp, u8p]
    lib.smt_resample_indices.restype = None
    lib.smt_resample_indices.argtypes = [i64, i64, u64, i32p]
    lib.smt_assemble_eval_frame.restype = i64
    lib.smt_assemble_eval_frame.argtypes = [ctypes.c_char_p, dp, fp, i64, fp,
                                            u8p, i64,
                                            ctypes.POINTER(ctypes.c_int64)]
    return lib


def _count(path: str, item_bytes: int) -> int:
    """Whole items in the file, at most SCAN_CAP (raises if it is absent)."""
    return min(os.path.getsize(path) // item_bytes, SCAN_CAP)


def _points(pts: np.ndarray) -> np.ndarray:
    pts = np.ascontiguousarray(pts, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 4:
        raise ValueError(f"points must be (n, 4), got {pts.shape}")
    return pts


def _matrix(mat: np.ndarray) -> np.ndarray:
    mat = np.ascontiguousarray(mat, np.float64)
    if mat.shape != (4, 4):
        raise ValueError(f"transform must be 4x4, got {mat.shape}")
    return mat


def _lims(lims: Sequence[float]) -> np.ndarray:
    lims = np.asarray(lims, np.float32)
    if lims.shape != (6,):
        raise ValueError("lims must be (xmin, xmax, ymin, ymax, zmin, zmax)")
    return lims


def load_scan(path: str) -> np.ndarray:
    """A KITTI .bin scan as (n, 4) float32 xyzi."""
    cap = _count(path, 16)
    buf = np.empty((cap, 4), np.float32)
    n = _lib().smt_load_scan(path.encode(), buf, cap)
    if n < 0:
        raise IOError(f"cannot read {path}")
    return buf[:n]


def load_labels(path: str) -> np.ndarray:
    """A KITTI .label file as (n,) uint32."""
    cap = _count(path, 4)
    buf = np.empty(cap, np.uint32)
    n = _lib().smt_load_labels(path.encode(), buf, cap)
    if n < 0:
        raise IOError(f"cannot read {path}")
    return buf[:n]


def transform(pts: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """xyz' = R xyz + t in float64, rounded to float32; a new array."""
    out = _points(pts).copy()
    _lib().smt_transform(out, out.shape[0], _matrix(mat))
    return out


def filter_points(pts: np.ndarray, lims) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (compacted points, bool mask over the input)."""
    pts = _points(pts)
    out = np.empty_like(pts)
    mask = np.empty(pts.shape[0], np.uint8)
    m = _lib().smt_filter(pts, pts.shape[0], _lims(lims), out, mask)
    return out[:m], mask.astype(bool)


def resample_indices(n: int, n_out: int, seed: int) -> np.ndarray:
    """`n_out` uniform draws from [0, n) with replacement (xoshiro256**)."""
    if n <= 0 or n_out < 0:
        raise ValueError(f"cannot draw {n_out} indices from {n}")
    idx = np.empty(n_out, np.int32)
    _lib().smt_resample_indices(n, n_out, seed & 0xFFFFFFFFFFFFFFFF, idx)
    return idx


def assemble_eval_frame(path: str, mat: np.ndarray, lims, n_out: int
                        ) -> Tuple[np.ndarray, int, np.ndarray]:
    """Fused load + transform + crop + sentinel padding. Returns (frame
    (n_out, 4), n_valid, valid mask over the raw scan)."""
    out = np.empty((n_out, 4), np.float32)
    cap = _count(path, 16)
    mask = np.empty(cap, np.uint8)
    n_raw = ctypes.c_int64(0)
    n = _lib().smt_assemble_eval_frame(
        path.encode(), _matrix(mat), _lims(lims), n_out, out, mask, cap,
        ctypes.byref(n_raw))
    if n == -1:
        raise IOError(f"cannot read {path}")
    if n == -2:
        raise ValueError(f"{path}: more in-range points than "
                         f"frame_point_num={n_out}; raise "
                         f"DatasetConfig.frame_point_num (CLI: --points)")
    if n < 0:
        raise RuntimeError(f"native loader error {n} on {path}")
    return out, int(n), mask[:n_raw.value].astype(bool)
