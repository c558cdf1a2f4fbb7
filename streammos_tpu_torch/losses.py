"""Training losses: cross entropy with an ignore label, online hard-example
mining, weighted cross entropy, Lovász-softmax and the boundary-F1 loss.

Counterparts of `streammos_tpu/losses.py`, with the same formulations, so
values and gradients agree with `jax.grad` of the JAX functions:

* every loss runs in float32 whatever the logits' dtype;
* OHEM: ``mean + top_weight * mean(top-k)`` with k =
  ``max(int(top_ratio * n), 1)`` over the whole flattened batch, ignored
  elements (loss 0) counted in both means; the top-k is chosen on detached
  values, so the gradient reaches only the k selected elements;
* Lovász: all classes sorted at once by detached error, the Jaccard
  coefficients of the sorted foreground run put back in element order and
  detached, the loss ``sum(errors * coeffs)``; ignored elements carry error
  exactly 0, so they add nothing and get no gradient.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def _pick_class(values: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """values (..., C) -> the target-class entry per element, as a one-hot
    masked sum."""
    C = values.shape[-1]
    onehot = targets[..., None] == torch.arange(C, device=targets.device)
    return torch.where(onehot, values, torch.zeros((), dtype=values.dtype,
                                                   device=values.device)).sum(-1)


def cross_entropy_per_element(logits: torch.Tensor, targets: torch.Tensor,
                              ignore_index: Optional[int] = 0,
                              weight: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """logits (..., C), targets (...); ignored positions get 0."""
    logp = F.log_softmax(logits.float(), dim=-1)
    tgt = targets.clamp(0, logits.shape[-1] - 1)
    nll = -_pick_class(logp, tgt)
    if weight is not None:
        nll = nll * _pick_class(weight.to(logp.device).expand_as(logp), tgt)
    if ignore_index is not None:
        nll = torch.where(targets == ignore_index, torch.zeros_like(nll), nll)
    return nll


def ce_ohem(logits: torch.Tensor, targets: torch.Tensor,
            top_ratio: float = 0.2, top_weight: float = 4.0,
            ignore_index: Optional[int] = 0,
            weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CE + top-k hard-example mining over the flattened batch."""
    flat = cross_entropy_per_element(logits, targets, ignore_index,
                                     weight).reshape(-1)
    k = max(int(top_ratio * flat.shape[0]), 1)
    idx = torch.topk(flat.detach(), k, sorted=False).indices
    return flat.mean() + top_weight * flat[idx].mean()


def weighted_ce(logits: torch.Tensor, targets: torch.Tensor,
                weight: torch.Tensor) -> torch.Tensor:
    """'wce' mode: the mean weighted by each element's class weight
    (weight[0] = 0 leaves the unlabeled class out)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    tgt = targets.clamp(0, logits.shape[-1] - 1)
    nll = -_pick_class(logp, tgt)
    w = _pick_class(weight.to(logp.device).expand_as(logp), tgt)
    return (nll * w).sum() / w.sum().clamp(min=1e-12)


def _lovasz_grad_coeffs(fg_sorted: torch.Tensor) -> torch.Tensor:
    """Jaccard surrogate gradient over sorted error runs, per row."""
    gts = fg_sorted.sum(-1, keepdim=True)
    inter = gts - torch.cumsum(fg_sorted, -1)
    union = gts + torch.cumsum(1.0 - fg_sorted, -1)
    jacc = 1.0 - inter / union.clamp(min=1e-12)
    return torch.cat([jacc[..., :1], jacc[..., 1:] - jacc[..., :-1]], -1)


def lovasz_softmax(logits: torch.Tensor, targets: torch.Tensor,
                   ignore_index: int = 0) -> torch.Tensor:
    """Lovász-softmax over the present classes (softmax inside,
    per_image=False). logits (..., C), targets (...). Classes with no valid
    foreground are left out of the mean; an all-ignored batch gives 0."""
    C = logits.shape[-1]
    probas = F.softmax(logits.float(), dim=-1).reshape(-1, C)
    labels = targets.reshape(-1)
    valid = (labels != ignore_index).float()
    classes = torch.arange(C, device=labels.device)
    fg = (labels[None, :] == classes[:, None]).float() * valid
    errors = (fg - probas.T).abs() * valid  # (C, n); ignored -> exactly 0
    order = torch.argsort(errors.detach(), dim=1, descending=True)
    coeffs = _lovasz_grad_coeffs(torch.gather(fg, 1, order))
    coeffs_unsorted = torch.empty_like(coeffs).scatter_(1, order, coeffs)
    losses = (errors * coeffs_unsorted.detach()).sum(1)
    present = (fg.sum(1) > 0).float()
    denom = present.sum()
    return torch.where(denom > 0, (losses * present).sum() / denom.clamp(min=1.0),
                       torch.zeros_like(denom))


def boundary_loss(logits: torch.Tensor, targets: torch.Tensor,
                  theta0: int = 3) -> torch.Tensor:
    """Boundary-F1 loss over BEV maps: boundary maps ``maxpool_theta0(1 - x)
    - (1 - x)`` ('SAME' padding with -inf) of the softmax prediction and of
    the one-hot ground truth, per-(image, class) precision and recall over
    them, ``mean(1 - BF1)``. logits (B, H, W, C), targets (B, H, W)."""
    B, H, W, C = logits.shape
    probas = F.softmax(logits.float(), dim=-1)
    one_hot = F.one_hot(targets.long(), C).float()
    lo = (theta0 - 1) // 2
    pads = (lo, theta0 - 1 - lo, lo, theta0 - 1 - lo)

    def boundary(x):
        inv = (1.0 - x).permute(0, 3, 1, 2)
        pooled = F.max_pool2d(F.pad(inv, pads, value=-np.inf), theta0, 1)
        return (pooled - inv).permute(0, 2, 3, 1).reshape(B, -1, C)

    gt_b = boundary(one_hot)
    pred_b = boundary(probas)
    inter = (pred_b * gt_b).sum(1)
    precision = inter / (pred_b.sum(1) + 1e-7)
    recall = inter / (gt_b.sum(1) + 1e-7)
    bf1 = 2.0 * precision * recall / (precision + recall + 1e-7)
    return (1.0 - bf1).mean()


def make_criterion(loss_mode: str, class_num: int,
                   content_weights: Optional[np.ndarray] = None):
    """The criterion of `loss_mode`: "ce", "ohem" or "wce"."""
    if loss_mode == "ce":
        return lambda lg, tg: cross_entropy_per_element(lg, tg, 0).mean()
    if loss_mode == "ohem":
        return lambda lg, tg: ce_ohem(lg, tg, top_ratio=0.2, top_weight=4.0,
                                      ignore_index=0)
    if loss_mode == "wce":
        if content_weights is None:
            from streammos_tpu_torch.data.semantic_kitti import \
                content_class_weights
            content_weights = content_class_weights(class_num=class_num)
        w = torch.as_tensor(np.asarray(content_weights, np.float32))
        return lambda lg, tg: weighted_ce(lg, tg, w)
    raise ValueError('loss_mode must be in ["ce", "wce", "ohem"]')
