"""The eval BatchNorm epilogue: a BN's per-channel affine from its four
float32 buffers, an optional per-(sample, channel) gate, an optional
residual and an activation, in one pass.

`bn_act` launches the hand-written CUDA kernel `csrc/bn_act.cu` for CUDA
tensors (it replaces no TPU kernel: JAX's eval BN is plain XLA, fused by
its compiler) and runs the plain version `bn_act_reference` for CPU
tensors. There is no other path: a CUDA call the kernel cannot take
raises, an input recording a gradient included (the kernel has no
backward; eval on a card runs under `torch.inference_mode()` or
`torch.no_grad()`).

Layouts (`fold`): 0, x (N, C, H, W), NCHW-contiguous or channels-last-
contiguous; >= 1, x (..., fold * C) contiguous, the channel of the last
axis's element i being i % C (the folded TTA point layout, `fold` v-major
blocks sharing the statistics). A residual has x's shape, dtype and
layout; a gate (fold 0 only) is (N, C) or (N, C, 1, 1) contiguous, of x's
dtype.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch

from streammos_tpu_torch.build import load_library
from streammos_tpu_torch.utils import profiling

ACTS = {"none": 0, "relu": 1, "leaky_relu": 2}
CHUNK = 2 ** 30  # elements a launch at most (csrc/bn_act.cu)
LEAKY_SLOPE = 0.01
DTYPES = (torch.float32, torch.bfloat16)


def activate(y: torch.Tensor, act: str) -> torch.Tensor:
    """`act` as the port's modules apply it; the leaky ReLU in
    jax.nn.leaky_relu's form (slope 1 at 0 in the gradient)."""
    if act == "relu":
        return torch.relu(y)
    if act == "leaky_relu":
        return torch.where(y >= 0, y, LEAKY_SLOPE * y)
    return y


def memory_format(x: torch.Tensor) -> torch.memory_format:
    """channels_last for a tensor laid out so and not NCHW-contiguous; the
    contiguous format otherwise."""
    if (x.is_contiguous(memory_format=torch.channels_last)
            and not x.is_contiguous()):
        return torch.channels_last
    return torch.contiguous_format


def _inner(x: torch.Tensor, C: int, fold: int) -> int:
    """Elements in a run of one channel in x's memory: H * W for NCHW, 1
    for channels last and the point layout; ValueError on any other shape
    or strides."""
    if fold:
        if x.dim() < 1 or x.shape[-1] != fold * C:
            raise ValueError(f"need x (..., {fold} * {C}), got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"the point layout needs a contiguous x, got "
                             f"strides {x.stride()}")
        return 1
    if x.dim() != 4 or x.shape[1] != C:
        raise ValueError(f"need x (N, {C}, H, W), got {tuple(x.shape)}")
    if x.is_contiguous():
        return x.shape[2] * x.shape[3]
    if x.is_contiguous(memory_format=torch.channels_last):
        return 1
    raise ValueError(f"need x NCHW- or channels-last-contiguous, got strides "
                     f"{x.stride()}")


def _check(x, weight, bias, running_mean, running_var, fold, act, residual,
           gate) -> int:
    """Validate the call; returns `_inner(x, ...)`."""
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}; expected one of {list(ACTS)}")
    if fold < 0:
        raise ValueError(f"fold must be >= 0, got {fold}")
    C = weight.shape[0]
    for name, t in (("weight", weight), ("bias", bias),
                    ("running_mean", running_mean),
                    ("running_var", running_var)):
        if t.shape != (C,):
            raise ValueError(f"need {name} ({C},), got {tuple(t.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"the BN epilogue takes float32 or bfloat16, got "
                        f"{x.dtype}")
    inner = _inner(x, C, fold)
    tensors = [weight, bias, running_mean, running_var]
    if residual is not None:
        if residual.shape != x.shape or residual.dtype != x.dtype:
            raise ValueError(f"need a residual of x's shape {tuple(x.shape)} "
                             f"and dtype {x.dtype}, got "
                             f"{tuple(residual.shape)}, {residual.dtype}")
        fmt = torch.contiguous_format if fold else memory_format(x)
        if not residual.is_contiguous(memory_format=fmt):
            raise ValueError(f"need the residual in x's layout ({fmt}), got "
                             f"strides {residual.stride()}")
        tensors.append(residual)
    if gate is not None:
        if fold:
            raise ValueError("a gate needs fold 0 (NCHW or channels last)")
        if (gate.shape not in ((x.shape[0], C), (x.shape[0], C, 1, 1))
                or gate.dtype != x.dtype or not gate.is_contiguous()):
            raise ValueError(f"need a contiguous gate ({x.shape[0]}, {C}[, 1, "
                             f"1]) of dtype {x.dtype}, got "
                             f"{tuple(gate.shape)}, {gate.dtype}")
        tensors.append(gate)
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"all inputs on x's device {x.device}, got one "
                             f"on {t.device}")
    return inner


def bn_act_reference(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, running_mean: torch.Tensor,
                     running_var: torch.Tensor, eps: float, fold: int = 0,
                     act: str = "none",
                     residual: Optional[torch.Tensor] = None,
                     gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of `bn_act`: act((x * s + b) * gate + residual) in
    float32, each op rounded as it comes, rounded once to x's dtype; s =
    weight / sqrt(running_var + eps), b = bias - running_mean * s.
    Differentiable."""
    s = weight.float() / torch.sqrt(running_var.float() + eps)
    b = bias.float() - running_mean.float() * s
    if fold:
        s, b = s.repeat(fold), b.repeat(fold)
    else:
        s, b = s[:, None, None], b[:, None, None]
    y = x.float() * s + b
    if gate is not None:
        y = y * gate.float().reshape(x.shape[0], -1, 1, 1)
    if residual is not None:
        y = y + residual.float()
    return activate(y, act).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("bn_act")
    fn = lib.streammos_bn_act
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_float]
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int]
                   + [ctypes.c_longlong] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    return lib


def bn_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           running_mean: torch.Tensor, running_var: torch.Tensor, eps: float,
           fold: int = 0, act: str = "none",
           residual: Optional[torch.Tensor] = None,
           gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """act((x * s + b) * gate + residual) with a BN's eval affine s, b from
    its buffers (`bn_act_reference`'s arithmetic). Checks the call (module
    docstring), then: CPU tensors run `bn_act_reference`; CUDA tensors
    launch the kernel (float32 buffers, C <= 4096; one launch a 2^30
    elements) and count its launches in ``kernel.bn_act``, or raise (an
    input recording a gradient, buffers or sizes it cannot take). y comes
    in x's layout."""
    inner = _check(x, weight, bias, running_mean, running_var, fold, act,
                   residual, gate)
    if x.device.type == "cpu":
        return bn_act_reference(x, weight, bias, running_mean, running_var,
                                eps, fold, act, residual, gate)
    if not x.is_cuda:
        raise ValueError(f"no BN epilogue for device {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, weight, bias, residual, gate)):
        raise RuntimeError("the BN epilogue kernel has no backward: run eval "
                           "on a card under torch.inference_mode() or "
                           "torch.no_grad()")
    buffers = (weight, bias, running_mean, running_var)
    C = weight.shape[0]
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in buffers):
        raise TypeError(f"the BN epilogue kernel reads contiguous float32 "
                        f"buffers, got "
                        f"{[(t.dtype, t.stride()) for t in buffers]}")
    per_sample = x.numel() // max(x.shape[0], 1) if gate is not None else 1
    # a launch takes whole units (samples with a gate, else whole channel
    # runs) and whole 16-byte vectors
    whole = math.lcm(per_sample if gate is not None else inner * C,
                     16 // x.element_size())
    if C > 4096 or whole > CHUNK:
        raise ValueError(f"the BN epilogue kernel takes at most 4096 "
                         f"channels and samples (NCHW: C * H * W) of at "
                         f"most 2^30 elements, got C={C}, {tuple(x.shape)}")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _library().streammos_bn_act(
            x.data_ptr(), ptr(residual), ptr(gate), y.data_ptr(),
            *(t.data_ptr() for t in buffers), float(np.float32(eps)),
            x.numel(), inner, C, per_sample, ACTS[act],
            int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"BN epilogue kernel launch failed: CUDA error "
                           f"{err}")
    profiling.count("kernel.bn_act",
                    -(-x.numel() // (CHUNK // whole * whole)))
    return y
