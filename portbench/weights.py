"""Random weights from the seed, drawn on the device in two large calls.

The names and shapes are the plain reference's (`reference/streammos.py`),
which carry the reference recipe's state-dict keys; the measured package
loads the same dict. Distributions: conv and linear weights N(0, 1/fan_in),
biases N(0, 0.01^2), BatchNorm and LayerNorm scales N(1, 0.1^2) and shifts
N(0, 0.1^2), running means N(0, 0.1^2), running variances U[0.5, 1.5], the
learned query N(0, 1), the sampling offsets' bias the directional grid the
recipe initialises it with.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn as nn


def offset_grid(heads: int, points: int) -> np.ndarray:
    """The deformable attention's initial sampling-offset bias: per head a
    unit direction at angle 2 pi h / heads (largest component 1), scaled by
    1..points."""
    th = np.arange(heads, dtype=np.float64) * (2.0 * math.pi / heads)
    g = np.stack([np.cos(th), np.sin(th)], -1)
    g = g / np.abs(g).max(-1, keepdims=True)
    g = np.tile(g[:, None, :], (1, points, 1)) * np.arange(
        1, points + 1)[None, :, None]
    return g.reshape(-1).astype(np.float32)


def draw_weights(model: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """A float32 state dict for every entry of `model` (a reference model,
    on any device, the meta device included) but the BatchNorm step
    counters, drawn on `device` from `seed`."""
    entries = [(n, t.shape) for n, t in model.state_dict().items()
               if not n.endswith("num_batches_tracked")]
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [math.prod(s) for _, s in entries]
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape), size in zip(entries, sizes):
        z = normal[at:at + size].view(shape)
        u = uniform[at:at + size].view(shape)
        at += size
        owner = model.get_submodule(name.rsplit(".", 1)[0])
        norm = isinstance(owner, (nn.BatchNorm2d, nn.LayerNorm))
        if name.endswith("running_var"):
            val = u + 0.5
        elif name.endswith("running_mean"):
            val = z * 0.1
        elif norm:
            val = z * 0.1 + (1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("sampling_offsets.bias"):
            heads = owner.out_features // (2 * model.m["n_points"])
            val = torch.from_numpy(offset_grid(heads, model.m["n_points"])
                                   ).to(device)
        elif name.endswith("query_embed.weight"):
            val = z
        elif len(shape) == 1:
            val = z * 0.01
        else:
            val = z * math.prod(shape[1:]) ** -0.5
        out[name] = val.contiguous()
    return out
