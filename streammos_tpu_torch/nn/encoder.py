"""Cascaded multi-view (BEV + range-view) encoder with deformable-attention
temporal fusion.

Counterpart of `streammos_tpu/nn/encoder.py:MultiViewEncoder`. With
``tta_fold=False`` (train and eval) every cascade is the plain
`grid_to_point` gather and `voxel_max_pool` scatter. With ``tta_fold=True``
(eval only) the dense side runs on batch V*Bt (variants on the batch axis,
NCHW inside), while every point-mediated cascade gathers and scatters once
over the variants' shared index structure with the variants folded on
channels (`ops/tta_fold.py`).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from streammos_tpu_torch.config import ModelConfig
from streammos_tpu_torch.nn.blocks import (BasicBlock, BasicConv2d, Conv2d,
                                           DownSample2D, UnbalanceBasicBlock)
from streammos_tpu_torch.nn.deform import DeformAttnModule
from streammos_tpu_torch.ops.resize import resize_bilinear_align_corners
from streammos_tpu_torch.ops.sample import grid_to_point
from streammos_tpu_torch.ops.tta_fold import (V_TTA, grid_to_point_tta,
                                              voxel_max_pool_tta)
from streammos_tpu_torch.ops.voxel_pool import voxel_max_pool
from streammos_tpu_torch.utils.profiling import span


class ConvStage(nn.Sequential):
    """DownSample2D, ``num_blocks`` attention-free blocks (the first one
    optionally asymmetric), one channel-attention block; children are
    numbered as in the reference `_make_layer`."""

    def __init__(self, in_planes: int, out_planes: int, num_blocks: int,
                 stride: int = 1, unbalance_kernel: Tuple[int, int] = None):
        layers = [DownSample2D(in_planes, out_planes, stride)]
        for i in range(num_blocks):
            if i == 0 and unbalance_kernel is not None:
                k0, k1 = unbalance_kernel
                layers.append(UnbalanceBasicBlock(out_planes, (k0, k1),
                                                  (k0 // 2, k1 // 2)))
            else:
                layers.append(BasicBlock(out_planes, use_att=False))
        layers.append(BasicBlock(out_planes, use_att=True))
        super().__init__(*layers)

    def forward(self, x: torch.Tensor, tta_phase_T: int = 0) -> torch.Tensor:
        if tta_phase_T:
            x = self[0].forward_tta_fused(x, tta_phase_T)
        else:
            x = self[0](x)
        for block in list(self)[1:]:
            x = block(x)
        return x


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class MultiViewEncoder(nn.Module):
    """Inputs: bev_in, the frame-split stack (B, T, H, W, c0) of the full
    grid or, with `header_phase_T` = T (folded, fused header), the
    phase-outer scatter output (Bt*T, 4, H/2+2, W/2, V*c0); bev_coord,
    rv_coord (Bt, N, 2) current-frame coords (canonical when folded);
    memory (B, Hq, Wq, D); use_memory (False selects the learned query).
    B is Bt, or V*Bt when folded.

    Returns (out NCHW, point_feat_1 (Bt, N, c2) or folded (Bt, N, V*c2),
    aux0-2 NHWC, new_memory (B, Hq, Wq, D) float32)."""

    def __init__(self, cfg: ModelConfig, tta_fold: bool = False):
        super().__init__()
        self.cfg = cfg
        self.tta_fold = tta_fold
        c0, c1, c2, c3 = cfg.context_layers
        n1, n2, n3 = cfg.layers
        T = cfg.seq_num
        self.header_bev = ConvStage(T * c0, c1, n1, 2, (7, 3))
        self.header_rv = ConvStage(c1, c1, n1 - 1, 1)
        self.res1_bev = ConvStage(2 * c1, c2, n2, 2, (5, 3))
        self.res1_rv = ConvStage(c2, c2, n2 - 1, 1)
        self.res2 = ConvStage(2 * c2, c3, n3, 2)
        hq, wq = cfg.query_hw
        self.query_embed = nn.Embedding(hq * wq, cfg.d_model)
        self.deformattn_module = DeformAttnModule(
            cfg.n_attn_layers, cfg.d_model, cfg.ffn_dim, cfg.n_heads,
            cfg.n_points, cfg.attn_dropout)
        self.conv_1 = BasicConv2d(c1 * 2 + c2 * 2 + c3, 128, 3, 1)
        self.conv_2 = BasicConv2d(128, self.out_channels(cfg), 3, 1)
        self.aux_head1 = Conv2d(2 * c1, cfg.class_num, 1)
        self.aux_head2 = Conv2d(2 * c2, cfg.class_num, 1)
        self.aux_head3 = Conv2d(c3, cfg.class_num, 1)

    @staticmethod
    def out_channels(cfg: ModelConfig) -> int:
        _, c1, c2, c3 = cfg.context_layers
        return ((c3 + c2) // 2 + c1) // 2

    def forward(self, bev_in, bev_coord, rv_coord, memory, use_memory: bool,
                header_phase_T: int = 0):
        cfg = self.cfg
        rv_h, rv_w = cfg.voxel.rv_shape

        def gather(site, grid, coords, scale, kind):
            with span("smt.gather." + site):
                g = _nhwc(grid)
                if not self.tta_fold:
                    return grid_to_point(g, coords, scale)
                g = g.reshape(V_TTA, g.shape[0] // V_TTA, *g.shape[1:])
                return grid_to_point_tta(g, coords, scale, kind)

        def scatter(site, pts, coords, out_size, scale, kind):
            # gathered features are blends of post-ReLU grids: non-negative
            with span("smt.scatter." + site):
                if not self.tta_fold:
                    return _nchw(voxel_max_pool(pts, coords, out_size, scale,
                                                nonneg=True))
                out = voxel_max_pool_tta(pts, coords, out_size, scale, kind,
                                         nonneg=True)
                return _nchw(out.reshape(-1, *out.shape[2:]))

        # stage 0: full grid -> 1/2 (the fused header when folded), cascade
        # through the RV
        with span("smt.encoder.header"):
            x0 = self.header_bev(bev_in, header_phase_T)
        x0_point = gather("bev0", x0, bev_coord, (0.5, 0.5), "bev")
        x0_rv = scatter("rv0", x0_point, rv_coord, (rv_h // 2, rv_w // 2),
                        (0.5, 0.5), "rv")
        with span("smt.encoder.header_rv"):
            x0_rv = self.header_rv(x0_rv)
        x0_point = gather("rv0", x0_rv, rv_coord, (0.5, 0.5), "rv")
        h0, w0 = x0.shape[2], x0.shape[3]
        x0_bev = scatter("bev0", x0_point, bev_coord, (h0, w0), (0.5, 0.5),
                         "bev")

        # stage 1: 1/2 -> 1/4 (the join of stage 0's two halves is its input)
        with span("smt.encoder.res1_bev"):
            x0 = torch.cat([x0, x0_bev], dim=1)
            x1 = self.res1_bev(x0)
        x1_point = gather("bev1", x1, bev_coord, (0.25, 0.25), "bev")
        x1_rv = scatter("rv1", x1_point, rv_coord, (rv_h // 4, rv_w // 4),
                        (0.25, 0.25), "rv")
        with span("smt.encoder.res1_rv"):
            x1_rv = self.res1_rv(x1_rv)
        x1_point = gather("rv1", x1_rv, rv_coord, (0.25, 0.25), "rv")
        h1, w1 = x1.shape[2], x1.shape[3]
        x1_bev = scatter("bev1", x1_point, bev_coord, (h1, w1), (0.25, 0.25),
                         "bev")

        # stage 2: 1/4 -> 1/8, deformable-attention temporal fusion
        with span("smt.encoder.res2"):
            x1 = torch.cat([x1, x1_bev], dim=1)
            x2 = self.res2(x1)
        with span("smt.attention"):
            B, d, hq, wq = x2.shape
            if use_memory:
                query = memory.reshape(B, hq * wq, d)
            else:
                query = self.query_embed.weight[None].to(memory.dtype).expand(
                    B, hq * wq, d)
            src = _nhwc(x2).reshape(B, hq * wq, d)
            fused = self.deformattn_module(query.to(x2.dtype), src, (hq, wq))
            new_memory = fused.reshape(B, hq, wq, d).float()
            x2 = _nchw(fused.reshape(B, hq, wq, d))

        # parameter-free decoder at 1/2 resolution
        with span("smt.encoder.decoder"):
            res_1 = _nchw(resize_bilinear_align_corners(_nhwc(x1), (h0, w0)))
            res_2 = _nchw(resize_bilinear_align_corners(_nhwc(x2), (h0, w0)))
            out = torch.cat([x0, res_1, res_2], dim=1)
            out = self.conv_2(self.conv_1(out))
            aux = [_nhwc(head(res)) for head, res in
                   ((self.aux_head1, x0), (self.aux_head2, res_1),
                    (self.aux_head3, res_2))]
        return out, x1_point, aux[0], aux[1], aux[2], new_memory
