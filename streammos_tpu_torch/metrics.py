"""Segmentation metrics with counters on the device.

Counterpart of `streammos_tpu/metrics.py`: per-class true positives,
predicted and ground-truth counts over points with gt != 0, reduced to
IoU / precision / recall per class and their mean IoU; ``moving_iou`` is
the headline number. The argmax and the counts run on the scores' device
and the counts stay there, as int64, until `compute` reads them once.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch


def init_state(num_classes: int, device=None) -> Dict[str, torch.Tensor]:
    """num_classes counts the *foreground* categories (['static',
    'moving'])."""
    z = torch.zeros(num_classes, dtype=torch.int64, device=device)
    return {"tp": z, "pred_num": z.clone(), "gt_num": z.clone()}


def update(state: Dict[str, torch.Tensor], gt: torch.Tensor,
           pred_scores: torch.Tensor, valid: Optional[torch.Tensor] = None
           ) -> Dict[str, torch.Tensor]:
    """gt (M,) int labels in {0..K}; pred_scores (M, K+1) class scores.

    Points with gt == 0 are excluded; `valid` optionally masks out padding
    points. No host synchronisation."""
    K = state["tp"].shape[0]
    pred = pred_scores.argmax(dim=-1)
    mask = gt != 0
    if valid is not None:
        mask = mask & valid
    cls = torch.arange(1, K + 1, device=gt.device)
    p = (pred[:, None] == cls) & mask[:, None]
    g = (gt[:, None] == cls) & mask[:, None]
    return {"tp": state["tp"] + (p & g).sum(dim=0),
            "pred_num": state["pred_num"] + p.sum(dim=0),
            "gt_num": state["gt_num"] + g.sum(dim=0)}


def compute(state: Dict[str, torch.Tensor],
            categories: Sequence[str]) -> Dict[str, float]:
    tp, pred_num, gt_num = (state[k].cpu().numpy().astype(np.float64)
                            for k in ("tp", "pred_num", "gt_num"))
    iou = tp / (gt_num + pred_num - tp + 1e-12)
    pre = tp / (pred_num + 1e-12)
    rec = tp / (gt_num + 1e-12)
    out: Dict[str, float] = {}
    for i, cate in enumerate(categories):
        out[f"{cate}_iou"] = float(iou[i])
        out[f"{cate}_pre"] = float(pre[i])
        out[f"{cate}_rec"] = float(rec[i])
    out["mean_iou"] = float(iou.mean())
    return out


class MultiClassMetric:
    """The stateful interface: `add_batch` per frame, `get_metric` once
    (which also resets). The counters live on the device of the first
    batch's scores."""

    def __init__(self, categories: Sequence[str]):
        self.categories = list(categories)
        self.reset()

    def reset(self):
        self.state = None

    def add_batch(self, gt, pred_scores, valid=None):
        pred_scores = torch.as_tensor(pred_scores)
        dev = pred_scores.device
        if self.state is None:
            self.state = init_state(len(self.categories), dev)
        self.state = update(self.state, torch.as_tensor(gt, device=dev),
                            pred_scores,
                            None if valid is None
                            else torch.as_tensor(valid, device=dev))

    def get_metric(self) -> Dict[str, float]:
        state = self.state
        if state is None:
            state = init_state(len(self.categories))
        out = compute(state, self.categories)
        self.reset()
        return out
