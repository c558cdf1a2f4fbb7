"""Single-level deformable-attention sampling, counterpart of
`streammos_tpu/ops/deform_attn.py:deform_attn_sample` (plain XLA there).

grid_sample semantics with ``align_corners=False`` and zero padding: pixel
coords ``px = loc_x * W - 0.5``, ``py = loc_y * H - 0.5``; a tap outside the
map contributes 0; per (query, head) the P samples are mixed by the
attention weights, and heads are concatenated.
"""
from __future__ import annotations

import numpy as np
import torch


def deform_attn_sample(value: torch.Tensor, loc: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """value (B, H, W, M, Dh); loc (B, Lq, M, P, 2) in [0, 1] as (x, y);
    weights (B, Lq, M, P). Returns (B, Lq, M * Dh)."""
    B, H, W, M, Dh = value.shape
    _, Lq, _, P, _ = loc.shape
    px = loc[..., 0] * W - 0.5
    py = loc[..., 1] * H - 0.5
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    fy = (py - y0).to(value.dtype)
    fx = (px - x0).to(value.dtype)
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)
    # one (H*W, Dh) table per (batch, head)
    table = value.permute(0, 3, 1, 2, 4).reshape(B * M * H * W, Dh)
    base = (torch.arange(B, device=value.device)[:, None, None, None] * M
            + torch.arange(M, device=value.device)[None, None, :, None]) * (H * W)
    wts = weights.to(value.dtype)
    out = None
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            y = y0i + dy
            x = x0i + dx
            ok = (y >= 0) & (y < H) & (x >= 0) & (x < W)
            idx = base + y.clamp(0, H - 1) * W + x.clamp(0, W - 1)
            rows = table.index_select(0, idx.reshape(-1)).reshape(
                B, Lq, M, P, Dh)
            w = (wy * wx * ok).to(value.dtype) * wts
            term = (rows * w[..., None]).sum(dim=3)  # (B, Lq, M, Dh)
            out = term if out is None else out + term
    return out.reshape(B, Lq, M * Dh)


def deform_attn_sample_ref(value: np.ndarray, loc: np.ndarray,
                           weights: np.ndarray) -> np.ndarray:
    """NumPy reference (float64 accumulation)."""
    B, H, W, M, Dh = value.shape
    _, Lq, _, P, _ = loc.shape
    out = np.zeros((B, Lq, M, Dh), dtype=np.float64)
    for b in range(B):
        for q in range(Lq):
            for m in range(M):
                for p in range(P):
                    px = loc[b, q, m, p, 0] * W - 0.5
                    py = loc[b, q, m, p, 1] * H - 0.5
                    y0 = int(np.floor(py))
                    x0 = int(np.floor(px))
                    fy = py - y0
                    fx = px - x0
                    samp = np.zeros(Dh, dtype=np.float64)
                    for dy, wy in ((0, 1 - fy), (1, fy)):
                        for dx, wx in ((0, 1 - fx), (1, fx)):
                            yy, xx = y0 + dy, x0 + dx
                            if 0 <= yy < H and 0 <= xx < W:
                                samp += wy * wx * value[b, yy, xx, m]
                    out[b, q, m] += weights[b, q, m, p] * samp
    return out.reshape(B, Lq, M * Dh).astype(value.dtype)
