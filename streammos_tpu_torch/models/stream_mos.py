"""The StreamMOS network on the folded-TTA eval path, plus the per-frame
preprocessing around it.

Counterpart of `streammos_tpu/models/stream_mos.py` for ``tta_fold=True``,
``train=False`` and the fused header: the four flip variants ride a minor
axis on the point side and the batch axis on the dense side.

  points     (Bt, T, N, V=4, 7)   per-variant point features
  bev_coord  (Bt, T, N, V, 3)     per-variant coords; only variant 0 (the
  rv_coord   (Bt, T, N, V, 2)     canonical orientation) indexes the ops
  memory     (V*Bt, Hq, Wq, D)    dense side: variants on the batch axis
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from streammos_tpu_torch import geometry
from streammos_tpu_torch.config import ModelConfig
from streammos_tpu_torch.nn.blocks import CatFusion, PointNetStacker, PredBranch
from streammos_tpu_torch.nn.encoder import MultiViewEncoder
from streammos_tpu_torch.ops.tta_fold import V_TTA, grid_to_point_tta
from streammos_tpu_torch.ops.voxel_pool import voxel_max_pool

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.compute_dtype]


def memory_shape(cfg: ModelConfig, batch: int) -> Tuple[int, int, int, int]:
    hq, wq = cfg.query_hw
    return (batch, hq, wq, cfg.d_model)


def featurize(xyzi: torch.Tensor, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Raw (..., N, 4) xyzi -> the 7-channel point features and fractional
    BEV / RV coordinates."""
    v = cfg.voxel
    bev_coord = geometry.quantize(xyzi, v.range_x, v.range_y, v.range_z,
                                  v.bev_shape)
    rv_coord = geometry.sphere_quantize(xyzi, (-180.0, 180.0), v.rv_theta,
                                        v.rv_shape)
    points = geometry.make_point_feat(xyzi, bev_coord)
    return {"points": points, "bev_coord": bev_coord, "rv_coord": rv_coord}


def tta_expand_folded(xyzi: torch.Tensor) -> torch.Tensor:
    """(B, T, N, 4) -> (B, T, N, V=4, 4): the four (x, y) sign flips on a
    minor axis, in variant order (+x,+y), (+x,-y), (-x,+y), (-x,-y)."""
    signs = torch.tensor([[x, y, 1.0, 1.0] for x in (1.0, -1.0)
                          for y in (1.0, -1.0)], dtype=xyzi.dtype,
                         device=xyzi.device)
    return xyzi[..., None, :] * signs


def tta_scores(pred_folded: torch.Tensor, class_num: int,
               v: int = V_TTA) -> torch.Tensor:
    """Folded logits (Bt, N, V*classes) -> (Bt, N, classes) float32: softmax
    over classes per variant, mean over variants."""
    bt, n, vc = pred_folded.shape
    if vc != v * class_num:
        raise ValueError(f"folded width {vc} != {v} x {class_num}")
    x = pred_folded.float().reshape(bt, n, v, class_num)
    return torch.softmax(x, dim=-1).mean(dim=2)


class RefineBranch(nn.Module):
    """Stage-2 movable-object head over the same three point features."""

    def __init__(self, cfg: ModelConfig, in_channels, fold: int):
        super().__init__()
        c = cfg.point_feat_out_channels
        self.bf_point_post = CatFusion(in_channels, c, fold)
        self.bf_pred_layer = PredBranch(c, cfg.class_num, fold)

    def forward(self, feats):
        return self.bf_pred_layer(self.bf_point_post(feats))


class StreamMOSNet(nn.Module):
    """Folded-TTA eval forward with the fused header. `forward` returns
    pred_folded (Bt, N, V*classes), pred (Bt, N, V, classes), aux0-2
    (V*Bt, h, w, classes), memory (V*Bt, Hq, Wq, D) and, with the refine
    head, bf_pred_folded and bf_pred; all float32."""

    def __init__(self, cfg: ModelConfig, with_refine: bool = False):
        super().__init__()
        if not cfg.fused_header:
            raise NotImplementedError(
                "the port runs the folded eval path with the fused header "
                "only (cfg.fused_header=True)")
        if cfg.fusion_mode not in ("cat", "CatFusion"):
            raise NotImplementedError(f"fusion_mode {cfg.fusion_mode!r}")
        self.cfg = cfg
        self.with_refine = with_refine
        c0, _, c2, _ = cfg.context_layers
        fused_in = (c0, MultiViewEncoder.out_channels(cfg), c2)
        self.point_pre = PointNetStacker(7, c0, pre_bn=True, stack_num=2,
                                         fold=V_TTA)
        self.bev_net = MultiViewEncoder(cfg)
        self.point_post = CatFusion(fused_in, cfg.point_feat_out_channels, V_TTA)
        self.pred_layer = PredBranch(cfg.point_feat_out_channels,
                                     cfg.class_num, V_TTA)
        if with_refine:
            self.refine = RefineBranch(cfg, fused_in, V_TTA)

    def forward(self, points, bev_coord, rv_coord, memory,
                use_memory: bool) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        dt = compute_dtype(cfg)
        H, W = cfg.voxel.bev_wl
        c0 = cfg.context_layers[0]
        Bt, T, N, V, C = points.shape

        # per-point MLP over all frames, variants folded on channels
        point_feat = self.point_pre(points.reshape(Bt * T, N, V * C).to(dt))

        # full-grid scatter straight into the fused header's phase-outer,
        # row-padded layout (canonical cell ids; features are post-ReLU)
        coords0 = bev_coord[..., 0, :].reshape(Bt * T, N, 3)
        bev = voxel_max_pool(point_feat, coords0[..., :2], (H, W), (1.0, 1.0),
                             nonneg=True, phase_split="outer", row_pad=1)
        cur_bev = bev_coord[:, 0, :, 0, :2]
        cur_rv = rv_coord[:, 0, :, 0]

        bev_feat, point_feat_1, aux0, aux1, aux2, new_memory = self.bev_net(
            bev, cur_bev, cur_rv, memory, use_memory, T)

        g = bev_feat.permute(0, 2, 3, 1)
        point_bev_feat = grid_to_point_tta(
            g.reshape(V_TTA, Bt, *g.shape[1:]), cur_bev, cfg.grid2point_scale,
            "bev")
        point_feat_cur = point_feat.reshape(Bt, T, N, V * c0)[:, 0]
        feats = [point_feat_cur, point_bev_feat, point_feat_1]
        pred = self.pred_layer(self.point_post(feats)).float()
        out = {
            "pred_folded": pred,
            "pred": pred.reshape(Bt, N, V, cfg.class_num),
            "aux0": aux0.float(),
            "aux1": aux1.float(),
            "aux2": aux2.float(),
            "memory": new_memory,
        }
        if self.with_refine:
            bf = self.refine(feats).float()
            out["bf_pred_folded"] = bf
            out["bf_pred"] = bf.reshape(Bt, N, V, cfg.class_num)
        return out
