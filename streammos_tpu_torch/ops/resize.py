"""align_corners=True bilinear resize as two small matmuls, counterpart of
`streammos_tpu/ops/resize.py` (plain XLA there)."""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from streammos_tpu_torch.utils.profiling import constant


@functools.lru_cache(maxsize=None)
def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) align_corners=True linear interpolation operator."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    if n_in == 1:
        return np.ones((n_out, 1), dtype=np.float32)
    pos = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    lo = np.minimum(np.floor(pos).astype(np.int64), n_in - 2)
    frac = pos - lo
    mat = np.zeros((n_out, n_in), dtype=np.float32)
    mat[np.arange(n_out), lo] = (1.0 - frac).astype(np.float32)
    mat[np.arange(n_out), lo + 1] = frac.astype(np.float32)
    return mat


def resize_bilinear_align_corners(x: torch.Tensor,
                                  out_hw: Tuple[int, int]) -> torch.Tensor:
    """x (B, h, w, C) -> (B, H, W, C), in x's dtype."""
    B, h, w, C = x.shape
    H, W = out_hw
    if (h, w) == (H, W):
        return x
    mh = constant(_interp_matrix, h, H, device=x.device, dtype=x.dtype)
    mw = constant(_interp_matrix, w, W, device=x.device, dtype=x.dtype)
    x = torch.einsum("Hh,bhwc->bHwc", mh, x)
    return torch.einsum("Ww,bhwc->bhWc", mw, x)
