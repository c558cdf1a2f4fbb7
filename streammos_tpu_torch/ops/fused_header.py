"""Fused TTA header: the header DownSample2D of all four TTA variants,
straight from the phase-outer scatter output.

Counterpart of `streammos_tpu/ops/fused_header.py`. `fused_header_tta`
launches the hand-written CUDA kernels of `csrc/fused_header.cu` for CUDA
tensors and runs the plain version `fused_header_reference` for CPU
tensors. There is no other path: a CUDA tensor the kernels cannot take
raises. The kernels replace the TPU kernel `_pair_kernel`
(`streammos_tpu/ops/fused_header.py:198`), one for each dtype:

- bfloat16, the main path: an implicit GEMM on the tensor cores
  (`mma.sync` m16n8k16, float32 sums in registers), its loads pipelined
  through a 3-stage `cp.async` ring. It stages only the full-res positions
  a tile's taps touch, reads G about once across the four variants, and
  takes its weights packed by `pack_header_weights`. Limits: C % 16 == 0,
  Cout % 8 == 0, Cout <= 32. Its bound at the production shape
  (3, 4, 258, 256, 256) bf16 is the 419.6 MB it moves: 0.1252 ms at
  3.35 TB/s (41.88 GFLOP, under the tensor cores' ridge). The source's
  header says what the design does about each of the first version's
  limits (float32 FMAs, no overlap, 159 KB a block, a 720-position halo
  window, weights re-read).
- float32, every float32 config: the same implicit GEMM in 3xTF32
  (`mma.sync` m16n8k8 tf32, each operand split in registers into
  hi = tf32(x) and lo = tf32(x - hi), a_lo b_hi + a_hi b_lo + a_hi b_hi
  summed in float32), steps of one frame x 16 channels on the same ring.
  A single TF32 product keeps 11 mantissa bits and would miss the float32
  tolerance (rtol = atol = 1e-4); the split keeps about 22 and meets it.
  Any C (16-byte copies when C % 4 == 0, else 4-byte ones); Cout % 8 == 0,
  Cout <= 32. Its bound at the production shape in float32 is the
  arithmetic: 41.88 GFLOP as three TF32 products, 0.2538 ms at 495
  TFLOP/s, beside 839.1 MB moved, 0.2505 ms at 3.35 TB/s.

Both kernels take a 16-byte aligned g_phase, frames of fewer than 2**31
elements and the weights packed by `pack_header_weights`.
Each launch counts in `utils/profiling.py`'s counters, as
``kernel.fused_header.bf16`` or ``kernel.fused_header.f32``.

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
from streammos_tpu_torch.utils import profiling

P_PHASE = 4
MAX_COUT = 32  # both kernels: Cout % 8 == 0, Cout <= 32
BF16_C_MULTIPLE = 16  # the bf16 kernel: C % 16 == 0

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


def pack_header_weights(k3: torch.Tensor, k1: torch.Tensor,
                        T: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' B operands, K-contiguous: k3 (3, 3, T*C, Cout) HWIO
    -> (T, 9, Cout, C) with tap = 3 * row tap + column tap, and k1
    (1, 1, T*C, Cout) -> (T, Cout, C)."""
    kh, kw, TC, Cout = k3.shape
    C = TC // T
    k3p = k3.reshape(kh, kw, T, C, Cout).permute(2, 0, 1, 4, 3)
    k1p = k1.reshape(T, C, Cout).permute(0, 2, 1)
    return (k3p.reshape(T, kh * kw, Cout, C).contiguous(),
            k1p.contiguous())


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
    canonical-anchored, in g_phase's dtype. CUDA tensors launch the kernel
    of their dtype (weights packed by `pack_header_weights` first); CPU
    tensors run `fused_header_reference`."""
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
    bf16 = g_phase.dtype == torch.bfloat16
    if bf16 and C % BF16_C_MULTIPLE:
        raise ValueError(f"bf16 fused header kernel takes C % "
                         f"{BF16_C_MULTIPLE} == 0, got C={C}")
    if g_phase.data_ptr() % 16:
        raise ValueError("fused header kernel takes a 16-byte aligned "
                         "g_phase")
    if g_phase[0].numel() >= 2 ** 31:
        raise ValueError("fused header kernel takes frames of fewer than "
                         "2**31 elements (32-bit window offsets)")
    dev = g_phase.device
    k3, k1 = pack_header_weights(k3.to(dev, g_phase.dtype),
                                 k1.to(dev, g_phase.dtype), T)
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
                 Bt, T, Hh, Wh, C, Cout, int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"fused header kernel launch failed: CUDA error {err}")
    profiling.count("kernel.fused_header.bf16" if bf16
                    else "kernel.fused_header.f32")
    return out
