"""The yardstick's arithmetic: the card's peaks, a kernel's work from its
call's shapes, and the model's FLOPs from the configuration's shapes.

Peaks: one NVIDIA H100 SXM at its 700 W limit, NVIDIA's data sheet, dense
rates without sparsity.

A kernel's work is what the computation needs whatever implements it:
each input byte read once, each output byte written once, FLOPs as
2 x multiply-adds. Its roofline share is max(bytes / HBM rate, FLOPs /
peak rate) over its measured time.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
F32_FLOP_PER_S = 67e12      # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
# the dense peak a compute dtype's matrix products run at (float32 convolutions
# and products take TF32 unless it is turned off)
PEAK_FLOP_PER_S = {"bfloat16": BF16_FLOP_PER_S, "float32": TF32_FLOP_PER_S}


def header_work(bt: int, T: int, hh: int, wh: int, c: int, cout: int,
                itemsize: int) -> Tuple[int, int]:
    """(bytes, FLOPs) of the fused TTA header over Bt streams: the four
    variants' DownSample2D (a 3x3 stride-2 convolution and a 1x1
    convolution over T frames of C channels, then a 3x3 max-pool, sum,
    ReLU) at the (hh, wh) half-resolution output. Bytes: the phase-split
    input grid without its padding rows (4 variants x C channels at full
    resolution, T frames), both weights, the output, four float32 affines
    of Cout."""
    grid = bt * T * 4 * hh * wh * 4 * c * itemsize
    weights = (9 + 1) * T * c * cout * itemsize
    out = 4 * bt * hh * wh * cout * itemsize
    nbytes = grid + weights + out + 4 * cout * 4
    flops = 2 * 4 * bt * hh * wh * cout * T * c * (9 + 4)
    return nbytes, flops


def header_bound_s(bt, T, hh, wh, c, cout, itemsize,
                   flop_per_s: float = BF16_FLOP_PER_S) -> float:
    nbytes, flops = header_work(bt, T, hh, wh, c, cout, itemsize)
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_per_s)


def _stage(rows, cin, cout, n, stride, unbalance, h, w) -> float:
    """A ConvStage at output (h, w): DownSample2D (3x3/stride conv and a
    1x1 conv at the input's resolution), `n` residual blocks (the first
    one asymmetric if `unbalance`), one block with channel attention."""
    f = 9 * cin * cout * h * w + cin * cout * (h * stride) * (w * stride)
    for i in range(n):
        if i == 0 and unbalance:
            k0, k1 = unbalance
            f += h * w * (2 * k0 * k1 * cout * cout + 9 * 2 * cout * cout)
        else:
            f += h * w * 2 * 9 * cout * cout
    f += h * w * 2 * 9 * cout * cout + 2 * cout * (cout // 4)
    return 2.0 * rows * f


def model_flops(m: Dict, rows: int, points: int, refine: bool
                ) -> List[Tuple[str, float]]:
    """Forward FLOPs of one frame over `rows` batch rows (streams x TTA
    variants), `points` points a frame, by layer.
    Counted: convolutions, linear maps (point MLPs, heads, the deformable
    attention's projections and FFN) and the deformable attention's
    sampling (4 bilinear taps and the attention weight a sample, per
    channel). Not counted: scatters, gathers, resizes, normalisation,
    activations."""
    c0, c1, c2, c3 = m["context_layers"]
    n1, n2, n3 = m["layers"]
    T = m["seq_num"]
    H, W = m["voxel"]["bev_shape"][:2]
    rh, rw = m["voxel"]["rv_shape"]
    hq, wq = m["query_hw"]
    d, ffn, M, P = m["d_model"], m["ffn_dim"], m["n_heads"], m["n_points"]
    cls, pfo = m["class_num"], m["point_feat_out_channels"]
    out_c = ((c3 + c2) // 2 + c1) // 2
    R, N, L = rows, points, hq * wq
    h0, w0 = H // 2, W // 2
    fused = c0 + out_c + c2
    layers = [
        ("point_pre", 2.0 * R * T * N * (7 * c0 + c0 * c0)),
        ("header_bev", _stage(R, T * c0, c1, n1, 2, (7, 3), h0, w0)),
        ("header_rv", _stage(R, c1, c1, n1 - 1, 1, None, rh // 2, rw // 2)),
        ("res1_bev", _stage(R, 2 * c1, c2, n2, 2, (5, 3), H // 4, W // 4)),
        ("res1_rv", _stage(R, c2, c2, n2 - 1, 1, None, rh // 4, rw // 4)),
        ("res2", _stage(R, 2 * c2, c3, n3, 2, None, H // 8, W // 8)),
        ("deform_attn_linear", 2.0 * R * L * m["n_attn_layers"] * (
            2 * d * d + d * M * P * 3 + 2 * d * ffn)),
        ("deform_attn_sampling", 2.0 * R * L * m["n_attn_layers"]
         * M * P * (d // M) * 5),
        ("decoder_convs", 2.0 * R * h0 * w0 * 9 * (
            (2 * c1 + 2 * c2 + c3) * 128 + 128 * out_c)),
        ("aux_heads", 2.0 * R * h0 * w0 * (2 * c1 + 2 * c2 + c3) * cls),
        ("point_heads", 2.0 * R * N * (fused * (fused // 2)
                                       + (fused // 2) * pfo + pfo * cls)
         * (2 if refine else 1)),
    ]
    return layers


def matmul_flops(layers: List[Tuple[str, float]]) -> float:
    """The FLOPs of the layers that are convolutions or matrix products
    (what `torch.utils.flop_counter` counts)."""
    return sum(f for name, f in layers if name != "deform_attn_sampling")
