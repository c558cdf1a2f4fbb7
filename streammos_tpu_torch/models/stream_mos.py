"""The StreamMOS network, the per-frame preprocessing around it, and the
streaming training objective.

Counterpart of `streammos_tpu/models/stream_mos.py`. `StreamMOSNet` runs
either layout of JAX's module:

* ``tta_fold=False`` (train and eval): one scan per batch row,
  points (B, T, N, 7), bev_coord (B, T, N, 3), rv_coord (B, T, N, 2),
  memory (B, Hq, Wq, D); pred (B, N, classes). A TTA fan is the batch
  (`tta_expand`).
* ``tta_fold=True`` (eval only): the four flip variants ride a minor axis
  on the point side and the batch axis on the dense side,
    points     (Bt, T, N, V=4, 7)   per-variant point features
    bev_coord  (Bt, T, N, V, 3)     per-variant coords; only variant 0 (the
    rv_coord   (Bt, T, N, V, 2)     canonical orientation) indexes the ops
    memory     (V*Bt, Hq, Wq, D)
  with the fused header (``cfg.fused_header``) or the full-grid scatter and
  the frame-split header.

The module's `training` flag is JAX's ``train``: batch-statistics BN (the
running statistics move in place) and dropout from an explicit generator.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.utils.checkpoint

from streammos_tpu_torch import geometry
from streammos_tpu_torch.config import ModelConfig
from streammos_tpu_torch.losses import lovasz_softmax, make_criterion
from streammos_tpu_torch.nn.blocks import (BN, PointNetStacker, PredBranch,
                                           make_fusion, set_dropout_generator)
from streammos_tpu_torch.nn.encoder import MultiViewEncoder
from streammos_tpu_torch.ops.sample import grid_to_point
from streammos_tpu_torch.ops.tta_fold import (V_TTA, grid_to_point_tta,
                                              voxel_max_pool_tta)
from streammos_tpu_torch.ops.voxel_pool import voxel_max_pool
from streammos_tpu_torch.parallel import gather_batch
from streammos_tpu_torch.utils.profiling import constant, count, span

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


def tta_expand(xyzi: torch.Tensor) -> torch.Tensor:
    """(B, T, N, 4) -> (4B, T, N, 4): the four (x, y) sign flips stacked on
    the batch axis, variant-major, in `tta_expand_folded`'s variant order."""
    return torch.cat([xyzi * torch.tensor([x, y, 1.0, 1.0], dtype=xyzi.dtype,
                                          device=xyzi.device)
                      for x in (1.0, -1.0) for y in (1.0, -1.0)], dim=0)


def _tta_signs():
    return [[x, y, 1.0, 1.0] for x in (1.0, -1.0) for y in (1.0, -1.0)]


def tta_expand_folded(xyzi: torch.Tensor) -> torch.Tensor:
    """(B, T, N, 4) -> (B, T, N, V=4, 4): the four (x, y) sign flips on a
    minor axis, in variant order (+x,+y), (+x,-y), (-x,+y), (-x,-y)."""
    signs = constant(_tta_signs, device=xyzi.device, dtype=xyzi.dtype)
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
        self.bf_point_post = make_fusion(cfg.fusion_mode, in_channels, c,
                                         cfg.dropout_rate, fold)
        self.bf_pred_layer = PredBranch(c, cfg.class_num, fold,
                                        cfg.dropout_rate)

    def forward(self, feats):
        return self.bf_pred_layer(self.bf_point_post(feats))


class StreamMOSNet(nn.Module):
    """One frame's forward. Returns float32 pred, aux0-2 (B, h, w, classes),
    memory (B, Hq, Wq, D) and, with the refine head, bf_pred; folded, pred
    is (Bt, N, V, classes), aux and memory have batch V*Bt, and
    pred_folded / bf_pred_folded (Bt, N, V*classes) are added. The state
    dict is the same for both layouts."""

    def __init__(self, cfg: ModelConfig, with_refine: bool = False,
                 tta_fold: bool = False):
        super().__init__()
        self.cfg = cfg
        self.with_refine = with_refine
        self.tta_fold = tta_fold
        fold = V_TTA if tta_fold else 1
        c0, _, c2, _ = cfg.context_layers
        fused_in = (c0, MultiViewEncoder.out_channels(cfg), c2)
        self.point_pre = PointNetStacker(7, c0, pre_bn=True, stack_num=2,
                                         fold=fold)
        self.bev_net = MultiViewEncoder(cfg, tta_fold)
        self.point_post = make_fusion(cfg.fusion_mode, fused_in,
                                      cfg.point_feat_out_channels,
                                      cfg.dropout_rate, fold)
        self.pred_layer = PredBranch(cfg.point_feat_out_channels,
                                     cfg.class_num, fold, cfg.dropout_rate)
        if with_refine:
            self.refine = RefineBranch(cfg, fused_in, fold)
        # the carried eval step's CUDA graphs by key (`serve.step_graph`)
        self.step_graphs = {}

    def _apply(self, fn, *args, **kwargs):
        # the graphs read the weights where they were: a move or a cast
        # (`to`, `half`, ...) drops them
        self.step_graphs.clear()
        return super()._apply(fn, *args, **kwargs)

    def forward(self, points, bev_coord, rv_coord, memory,
                use_memory: bool) -> Dict[str, torch.Tensor]:
        if self.tta_fold:
            if self.training:
                raise ValueError("the folded TTA layout is eval only")
            return self._forward_folded(points, bev_coord, rv_coord, memory,
                                        use_memory)
        return self._forward_unfolded(points, bev_coord, rv_coord, memory,
                                      use_memory)

    def _heads(self, feats):
        pred = self.pred_layer(self.point_post(feats)).float()
        bf = self.refine(feats).float() if self.with_refine else None
        return pred, bf

    def _forward_unfolded(self, points, bev_coord, rv_coord, memory,
                          use_memory: bool) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        dt = compute_dtype(cfg)
        H, W = cfg.voxel.bev_wl
        c0 = cfg.context_layers[0]
        B, T, N, C = points.shape

        with span("smt.point_mlp"):
            point_feat = self.point_pre(points.reshape(B * T, N, C).to(dt))
        with span("smt.scatter.bev_full"):
            # every frame into the full grid (features are post-ReLU), kept
            # as the frame-split stack the header's DownSample2D takes
            bev = voxel_max_pool(point_feat,
                                 bev_coord.reshape(B * T, N, 3)[..., :2],
                                 (H, W), (1.0, 1.0), nonneg=True)
            bev = bev.reshape(B, T, H, W, c0)
        cur_bev = bev_coord[:, 0, :, :2]
        cur_rv = rv_coord[:, 0]

        bev_feat, point_feat_1, aux0, aux1, aux2, new_memory = self.bev_net(
            bev, cur_bev, cur_rv, memory, use_memory)

        with span("smt.gather.point"):
            point_bev_feat = grid_to_point(bev_feat.permute(0, 2, 3, 1),
                                           cur_bev, cfg.grid2point_scale)
        with span("smt.heads"):
            point_feat_cur = point_feat.reshape(B, T, N, c0)[:, 0]
            feats = [point_feat_cur, point_bev_feat, point_feat_1]
            out = {"aux0": aux0.float(), "aux1": aux1.float(),
                   "aux2": aux2.float(), "memory": new_memory}
            out["pred"], bf = self._heads(feats)
        if bf is not None:
            out["bf_pred"] = bf
        return out

    def _forward_folded(self, points, bev_coord, rv_coord, memory,
                        use_memory: bool) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        dt = compute_dtype(cfg)
        H, W = cfg.voxel.bev_wl
        c0 = cfg.context_layers[0]
        Bt, T, N, V, C = points.shape

        with span("smt.point_mlp"):
            # per-point MLP over all frames, variants folded on channels
            point_feat = self.point_pre(
                points.reshape(Bt * T, N, V * C).to(dt))

        with span("smt.scatter.bev_full"):
            coords0 = bev_coord[..., 0, :].reshape(Bt * T, N, 3)
            if cfg.fused_header:
                # full-grid scatter straight into the fused header's
                # phase-outer, row-padded layout (canonical cell ids;
                # features are post-ReLU)
                bev = voxel_max_pool_tta(point_feat, coords0, (H, W),
                                         (1.0, 1.0), "bev", nonneg=True,
                                         layout="phase_outer")
                header_T = T
            else:
                # every variant's full grid in its own orientation, then
                # the frame-split header on batch V*Bt
                bev = voxel_max_pool_tta(point_feat, coords0, (H, W),
                                         (1.0, 1.0), "bev", nonneg=True)
                bev = bev.reshape(V * Bt, T, H, W, c0)
                header_T = 0
        cur_bev = bev_coord[:, 0, :, 0, :2]
        cur_rv = rv_coord[:, 0, :, 0]

        bev_feat, point_feat_1, aux0, aux1, aux2, new_memory = self.bev_net(
            bev, cur_bev, cur_rv, memory, use_memory, header_T)

        with span("smt.gather.point"):
            g = bev_feat.permute(0, 2, 3, 1)
            point_bev_feat = grid_to_point_tta(
                g.reshape(V_TTA, Bt, *g.shape[1:]), cur_bev,
                cfg.grid2point_scale, "bev")
        with span("smt.heads"):
            point_feat_cur = point_feat.reshape(Bt, T, N, V * c0)[:, 0]
            feats = [point_feat_cur, point_bev_feat, point_feat_1]
            out = {"aux0": aux0.float(), "aux1": aux1.float(),
                   "aux2": aux2.float(), "memory": new_memory}
            pred, bf = self._heads(feats)
        out["pred_folded"] = pred
        out["pred"] = pred.reshape(Bt, N, V, cfg.class_num)
        if bf is not None:
            out["bf_pred_folded"] = bf
            out["bf_pred"] = bf.reshape(Bt, N, V, cfg.class_num)
        return out


def stage_forward(model: StreamMOSNet, batch: Dict[str, torch.Tensor],
                  memory: torch.Tensor, use_memory: bool, train: bool,
                  generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
    """One frame's forward in train or eval mode. In train mode the BN
    running statistics move in place (JAX returns them as new variables)
    and dropout draws from `generator`."""
    model.train(train)
    if train:
        set_dropout_generator(model, generator)
    return model(batch["points"], batch["bev_coord"], batch["rv_coord"],
                 memory, use_memory)


def bev_label_from_points(labels: torch.Tensor, bev_coord: torch.Tensor,
                          out_hw: Tuple[int, int],
                          scale: Tuple[float, float] = (0.5, 0.5)
                          ) -> torch.Tensor:
    """Per-point labels (B, N) -> a (B, h, w) BEV label map by per-cell max
    ('moving' over 'static' over 'unlabeled'; empty cells 0)."""
    lab = labels.float()[..., None]
    grid = voxel_max_pool(lab, bev_coord, out_hw, scale, nonneg=True)
    return grid[..., 0].to(torch.int32)


def _seg_loss(criterion, logits: torch.Tensor,
              targets: torch.Tensor) -> torch.Tensor:
    """criterion + 3 * Lovász over the global batch: while a process group
    is active, every rank's logits and targets are gathered in rank order
    first, so each rank computes the loss of the whole batch (OHEM's
    top-k, the Lovász order and the `wce` sums included)."""
    logits, targets = gather_batch(logits), gather_batch(targets)
    return criterion(logits, targets) + 3.0 * lovasz_softmax(logits,
                                                             targets, 0)


def single_frame_loss(cfg: ModelConfig, outputs: Dict[str, torch.Tensor],
                      targets: torch.Tensor, bev_targets: torch.Tensor,
                      criterion=None) -> torch.Tensor:
    """Point loss + mean of the 3 aux BEV losses, each CE(+OHEM) +
    3 * Lovász, over the global batch."""
    if criterion is None:
        criterion = make_criterion(cfg.loss_mode, cfg.class_num)
    B = targets.shape[0]
    loss1 = _seg_loss(criterion, outputs["pred"], targets)
    aux_losses = [_seg_loss(criterion,
                            outputs[k].reshape(B, -1, cfg.class_num),
                            bev_targets.reshape(B, -1))
                  for k in ("aux0", "aux1", "aux2")]
    return loss1 + sum(aux_losses) / 3.0


def refine_loss(cfg: ModelConfig, outputs: Dict[str, torch.Tensor],
                bf_targets: torch.Tensor, criterion=None) -> torch.Tensor:
    """Stage-2 loss: the movable head only, over the global batch."""
    if criterion is None:
        criterion = make_criterion(cfg.loss_mode, cfg.class_num)
    return _seg_loss(criterion, outputs["bf_pred"], bf_targets)


@contextlib.contextmanager
def frozen_bn_stats(model: nn.Module):
    """Leave every BN's running statistics alone inside the block (a
    checkpointed forward that runs again during the backward)."""
    bns = [m for m in model.modules() if isinstance(m, BN)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


def streaming_loss(model: StreamMOSNet, windows: Dict[str, torch.Tensor],
                   cfg: ModelConfig,
                   generator: Optional[torch.Generator] = None,
                   stage2: bool = False, remat: bool = False) -> torch.Tensor:
    """The streaming training objective over the S sliding windows of one
    sample: the memory carry threads through all windows, gradients flow
    through the whole chain (BPTT), window 0 takes the learned query.

    windows: tensors with a leading window axis S, either raw xyzi
    (S, B, T, N, 4) (featurized here) or points / bev_coord / rv_coord, plus
    targets (S, B, N) [+ bf_targets (S, B, N) for stage 2]. `generator` (on
    the CPU) draws one seed a window; each window's dropout draws from a
    generator on the device made from its seed, so a window run again under
    `remat` (`torch.utils.checkpoint`) draws the same masks, and its BN
    running statistics move only on the first run. The model's BN running
    statistics move once a window. Returns the mean loss over the windows.
    Each window runs in span ``smt.train.window``, its loss in
    ``smt.train.loss``; on a card, the bytes that the loss allocates and
    still holds after its span (what it keeps for the backward) count in
    ``train.loss_bytes`` (two reads of the allocator's count, no sync).
    """
    key = "xyzi" if "xyzi" in windows else "points"
    S, B = windows[key].shape[:2]
    device = windows[key].device
    card = device.type == "cuda"
    criterion = make_criterion(cfg.loss_mode, cfg.class_num)
    memory = torch.zeros(memory_shape(cfg, B), dtype=torch.float32,
                         device=device)
    seeds = ([None] * S if generator is None else
             torch.randint(0, 2 ** 62, (S,), generator=generator).tolist())

    def one_window(points, bev_coord, rv_coord, memory, use_memory, seed):
        gen = (None if seed is None else
               torch.Generator(device=device).manual_seed(seed))
        batch = {"points": points, "bev_coord": bev_coord,
                 "rv_coord": rv_coord}
        return stage_forward(model, batch, memory, use_memory, train=True,
                             generator=gen)

    def window_loss(i, batch, out):
        if stage2:
            return refine_loss(cfg, out, windows["bf_targets"][i], criterion)
        hw = (cfg.voxel.bev_wl[0] // 2, cfg.voxel.bev_wl[1] // 2)
        bev_tgt = bev_label_from_points(windows["targets"][i],
                                        batch["bev_coord"][:, 0, :, :2],
                                        hw, (0.5, 0.5))
        return single_frame_loss(cfg, out, windows["targets"][i], bev_tgt,
                                 criterion)

    total = 0.0
    for i in range(S):
        with span("smt.train.window"):
            if "xyzi" in windows:
                batch = featurize(windows["xyzi"][i], cfg)
            else:
                batch = {k: windows[k][i] for k in ("points", "bev_coord",
                                                    "rv_coord")}
            args = (batch["points"], batch["bev_coord"], batch["rv_coord"],
                    memory, i > 0, seeds[i])
            if remat:
                out = torch.utils.checkpoint.checkpoint(
                    one_window, *args, use_reentrant=False,
                    preserve_rng_state=False,
                    context_fn=lambda: (contextlib.nullcontext(),
                                        frozen_bn_stats(model)))
            else:
                out = one_window(*args)
            memory = out["memory"]
            held = torch.cuda.memory_allocated(device) if card else 0
            with span("smt.train.loss"):
                total = total + window_loss(i, batch, out)
            if card:
                count("train.loss_bytes",
                      torch.cuda.memory_allocated(device) - held)
    return total / S
