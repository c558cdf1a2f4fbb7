"""Deformable-attention temporal fusion.

Counterparts of `streammos_tpu/nn/deform.py`: single-level `MSDeformAttn`,
the cross-attention + LayerNorm + FFN `DeformAttnLayer` (dropout after the
attention and twice in the FFN, at JAX's sites), and the stacked
`DeformAttnModule` over per-pixel reference points. Parameter names follow
the reference torch state_dict (`deformattn_module.deformattn_layers.{i}`).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

from streammos_tpu_torch.nn.blocks import Dropout, Linear
from streammos_tpu_torch.ops.deform_attn import deform_attn_sample
from streammos_tpu_torch.utils.profiling import constant


def rotational_offset_bias(n_heads: int, n_points: int) -> np.ndarray:
    """Directional grid bias the sampling offsets are initialized with."""
    thetas = np.arange(n_heads, dtype=np.float64) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], axis=-1)
    grid = grid / np.abs(grid).max(axis=-1, keepdims=True)
    grid = np.tile(grid[:, None, :], (1, n_points, 1))
    for i in range(n_points):
        grid[:, i, :] *= i + 1
    return grid.reshape(-1).astype(np.float32)


def reference_points(hw: Tuple[int, int]) -> np.ndarray:
    """Per-pixel normalized reference points (H*W, 2) as (x, y)."""
    H, W = hw
    ys = (np.arange(H, dtype=np.float32) + 0.5) / H
    xs = (np.arange(W, dtype=np.float32) + 0.5) / W
    ref_y, ref_x = np.meshgrid(ys, xs, indexing="ij")
    return np.stack([ref_x.reshape(-1), ref_y.reshape(-1)], axis=-1)


class MSDeformAttn(nn.Module):
    def __init__(self, d_model: int = 128, n_heads: int = 4, n_points: int = 4):
        super().__init__()
        self.n_heads, self.n_points = n_heads, n_points
        self.value_proj = Linear(d_model, d_model)
        self.sampling_offsets = Linear(d_model, n_heads * n_points * 2)
        self.attention_weights = Linear(d_model, n_heads * n_points)
        self.output_proj = Linear(d_model, d_model)

    def forward(self, query: torch.Tensor, ref_points: torch.Tensor,
                src: torch.Tensor, spatial_hw: Tuple[int, int]) -> torch.Tensor:
        """query (B, Lq, C); ref_points (Lq, 2) as (x, y) in [0, 1]; src
        (B, H*W, C) the flattened value map."""
        B, Lq, C = query.shape
        H, W = spatial_hw
        M, P = self.n_heads, self.n_points
        value = self.value_proj(src).reshape(B, H, W, M, C // M)
        offsets = self.sampling_offsets(query).reshape(B, Lq, M, P, 2)
        attn = torch.softmax(self.attention_weights(query).reshape(B, Lq, M, P), dim=-1)
        normalizer = constant(list, (W, H), device=query.device,
                              dtype=query.dtype)
        loc = ref_points[None, :, None, None, :] + offsets / normalizer
        return self.output_proj(deform_attn_sample(value, loc, attn))


class DeformAttnLayer(nn.Module):
    """cross-attention + residual + LayerNorm + FFN + residual + LayerNorm;
    the LayerNorms run in float32."""

    def __init__(self, d_model: int = 128, d_ffn: int = 512, n_heads: int = 4,
                 n_points: int = 4, dropout: float = 0.0):
        super().__init__()
        self.cross_attn = MSDeformAttn(d_model, n_heads, n_points)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = Linear(d_model, d_ffn)
        self.linear2 = Linear(d_ffn, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, query, ref_points, src, spatial_hw):
        dt = query.dtype
        attn_out = self.dropout1(self.cross_attn(query, ref_points, src,
                                                 spatial_hw))
        query = self.norm1((query + attn_out).float()).to(dt)
        ffn = self.dropout2(torch.relu(self.linear1(query)))
        ffn = self.dropout3(self.linear2(ffn))
        return self.norm2((query + ffn).float()).to(dt)


class DeformAttnModule(nn.Module):
    """Stack of deformable cross-attention layers refining the query
    against the current frame's features."""

    def __init__(self, num_layers: int = 2, d_model: int = 128,
                 d_ffn: int = 512, n_heads: int = 4, n_points: int = 4,
                 dropout: float = 0.0):
        super().__init__()
        self.deformattn_layers = nn.ModuleList(
            DeformAttnLayer(d_model, d_ffn, n_heads, n_points, dropout)
            for _ in range(num_layers))

    def forward(self, query: torch.Tensor, src: torch.Tensor,
                spatial_hw: Tuple[int, int]) -> torch.Tensor:
        refs = constant(reference_points, tuple(spatial_hw),
                        device=query.device, dtype=query.dtype)
        for layer in self.deformattn_layers:
            query = layer(query, refs, src, spatial_hw)
        return query
