"""Fused TTA header: the header DownSample2D of all four TTA variants,
straight from the phase-outer scatter output.

Counterpart of `streammos_tpu/ops/fused_header.py`. `fused_header_tta`
launches the hand-written CUDA kernel `csrc/fused_header.cu` for CUDA
tensors (it replaces the TPU kernel `_pair_kernel` there) and runs the plain
version `fused_header_reference` for CPU tensors. There is no other path: a
CUDA tensor the kernel cannot take raises.

  input   g_phase (Bt*T, 4, Hh+2, Wh, V*C)  phase-outer, canonical
          orientation, one empty half-res row above and below each phase
          plane (`voxel_max_pool(..., phase_split="outer", row_pad=1)`);
          variants folded v-major on channels
  output  (V, Bt, Hh, Wh, Cout)  each variant's DownSample2D output,
          anchored to the canonical orientation (apply `orient_grid` per
          variant afterwards)
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from streammos_tpu_torch.build import load_library
from streammos_tpu_torch.ops.tta_fold import V_TTA, orient_grid

P_PHASE = 4
MAX_COUT = 32  # the kernel's channel groups: Cout % 8 == 0, Cout <= 32

Affine = Tuple[torch.Tensor, torch.Tensor]


def fused_header_reference(g_phase: torch.Tensor, k3: torch.Tensor,
                           k1: torch.Tensor, conv_affine: Affine,
                           pool_affine: Affine, T: int) -> torch.Tensor:
    """Plain version, in float32: strip the padding rows, rebuild the
    full-res grid, orient each variant, run the DownSample2D math (3x3/s2
    conv + affine, in parallel 1x1 conv + affine + 3x3/s2 max-pool with -inf
    padding, sum, ReLU), anchor the outputs back to canonical orientation.
    k3 (3, 3, T*C, Cout) and k1 (1, 1, T*C, Cout) are HWIO, as in JAX."""
    g = g_phase[:, :, 1:-1]
    BtT, P, Hh, Wh, VC = g.shape
    C = VC // V_TTA
    Bt = BtT // T
    full = g.reshape(BtT, 2, 2, Hh, Wh, V_TTA, C).permute(
        0, 3, 1, 4, 2, 5, 6).reshape(BtT, 2 * Hh, 2 * Wh, V_TTA, C)
    w3 = k3.float().permute(3, 2, 0, 1)
    w1 = k1.float().permute(3, 2, 0, 1)
    cs, cb = (a.float()[:, None, None] for a in conv_affine)
    ps, pb = (a.float()[:, None, None] for a in pool_affine)
    outs = []
    for v in range(V_TTA):
        gv = orient_grid(full[..., v, :], v, "bev", (1, 2))
        gv = gv.reshape(Bt, T, 2 * Hh, 2 * Wh, C).permute(0, 1, 4, 2, 3)
        gv = gv.reshape(Bt, T * C, 2 * Hh, 2 * Wh).float()
        conv = F.conv2d(gv, w3, stride=2, padding=1) * cs + cb
        z = F.conv2d(gv, w1) * ps + pb
        pooled = F.max_pool2d(z, 3, stride=2, padding=1)
        y = torch.relu(conv + pooled).permute(0, 2, 3, 1)
        outs.append(orient_grid(y, v, "bev", (1, 2)))
    return torch.stack(outs).to(g_phase.dtype)


def _check(g_phase, k3, k1, T) -> Tuple[int, int, int, int, int]:
    if g_phase.dim() != 5 or g_phase.shape[1] != P_PHASE:
        raise ValueError(f"g_phase must be (Bt*T, 4, Hh+2, Wh, V*C), got "
                         f"{tuple(g_phase.shape)}")
    BtT, _, Hp, Wh, VC = g_phase.shape
    if Hp < 3 or Wh < 1:
        raise ValueError(f"grid too small: Hh+2={Hp}, Wh={Wh}")
    if VC % V_TTA:
        raise ValueError(f"folded width {VC} is not a multiple of {V_TTA}")
    if T < 1 or BtT % T:
        raise ValueError(f"leading dim {BtT} is not a multiple of T={T}")
    C = VC // V_TTA
    Cout = k3.shape[-1]
    if tuple(k3.shape) != (3, 3, T * C, Cout) or tuple(k1.shape) != (1, 1, T * C, Cout):
        raise ValueError(f"kernels {tuple(k3.shape)}, {tuple(k1.shape)} do not "
                         f"match T*C={T * C}")
    return BtT // T, Hp - 2, Wh, C, Cout


def fused_header_tta(g_phase: torch.Tensor, k3: torch.Tensor,
                     k1: torch.Tensor, conv_affine: Affine,
                     pool_affine: Affine, T: int) -> torch.Tensor:
    """All four variants' DownSample2D outputs (V, Bt, Hh, Wh, Cout),
    canonical-anchored, in g_phase's dtype. CUDA tensors launch the kernel;
    CPU tensors run `fused_header_reference`."""
    Bt, Hh, Wh, C, Cout = _check(g_phase, k3, k1, T)
    if g_phase.device.type == "cpu":
        return fused_header_reference(g_phase, k3, k1, conv_affine,
                                      pool_affine, T)
    if not g_phase.is_cuda:
        raise ValueError(f"no fused header for device {g_phase.device}")
    if g_phase.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused header kernel takes float32 or bfloat16, "
                        f"got {g_phase.dtype}")
    if not g_phase.is_contiguous():
        raise ValueError("g_phase must be contiguous")
    if Cout % 8 or Cout > MAX_COUT:
        raise ValueError(f"fused header kernel takes Cout % 8 == 0 and "
                         f"Cout <= {MAX_COUT}, got {Cout}")
    dev = g_phase.device
    k3 = k3.to(dev, g_phase.dtype).contiguous()
    k1 = k1.to(dev, g_phase.dtype).contiguous()
    aff = [a.to(dev, torch.float32).contiguous()
           for a in (*conv_affine, *pool_affine)]
    if any(a.shape != (Cout,) for a in aff):
        raise ValueError(f"affines must be ({Cout},)")
    out = torch.empty((V_TTA, Bt, Hh, Wh, Cout), dtype=g_phase.dtype,
                      device=dev)
    fn = load_library("fused_header").streammos_fused_header_tta
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(g_phase.data_ptr(), k3.data_ptr(), k1.data_ptr(),
                 *(a.data_ptr() for a in aff), out.data_ptr(),
                 Bt, T, Hh, Wh, C, Cout,
                 int(g_phase.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"fused header kernel launch failed: CUDA error {err}")
    fused_header_tta.launches += 1
    return out


fused_header_tta.launches = 0
