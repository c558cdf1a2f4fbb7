"""Plain StreamMOS training in PyTorch: the yardstick a train step is
judged by.

One step of the streaming objective of the reference recipe
(NEU-REAL/StreamMOS, arXiv:2407.17905, stage 1): S windows of one sample,
the memory carried from window to window with the gradient through it
(BPTT), the learned query in window 0, the whole network in train mode;
then one backward and one SGD update. It reuses the eval reference's
modules (`streammos.py`) unchanged and imports nothing of the measured
package.

* BatchNorm: batch statistics (`F.batch_norm(training=True)`), and the
  running statistics moved by 0.1 of the batch's, the variance unbiased.
* Dropout at the recipe's two sites, the inputs of the point fusion
  (`point_post.dropout`, one draw a source) and of the classifier
  (`pred_layer.dropout`), rate `dropout_rate`; a kept element is scaled by
  1 / (1 - rate). The masks come from a provider: the reference as a
  system draws its own, the check hands it those the measured program drew.
* Loss a window: the point logits' loss plus the mean of the three aux
  BEV heads' losses, each OHEM cross-entropy (ignore 0; the mean over every
  element plus 4 x the mean of the top 20%) + 3 x Lovasz-softmax (the
  present classes, ignore 0); the aux targets are the per-cell max of the
  point labels at half resolution. The step's loss is the windows' mean.
* SGD with Nesterov momentum 0.9 and coupled weight decay
  (`torch.optim.SGD`), the learning rate of the update count from the
  recipe's 'step' schedule: linear warm-up over `pct_start` of the run,
  then `decay_factor` every `step_epochs` epochs.

Departures from the published torch recipe, noted: the point and BEV
scatters take the max of every point of a cell (as the eval reference
does); where two points tie exactly, torch's `scatter_reduce` splits the
cell's gradient between them (in float32 ties are all but absent; the
recipe's `torch_scatter` gives it to one of them). The attention's
dropout (rate `attn_dropout`, 0 in the shipped configurations) is not
modelled: a configuration with a non-zero rate is refused.

Precision: as the eval reference, through `Precision`; the caller turns
TF32 off for float32.
"""
from __future__ import annotations

import types
from typing import Callable, Dict, Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference import streammos as ref

SITES = ("point_post.dropout", "pred_layer.dropout")
OHEM_RATIO, OHEM_WEIGHT, LOVASZ_WEIGHT = 0.2, 4.0, 3.0
# mask(site, call, shape) -> bool tensor: the elements a dropout site keeps
# in its `call`-th input of the forward
MaskFn = Callable[[str, int, torch.Size], torch.Tensor]


def _train_bn(bn: ref.BN, x: torch.Tensor, ch: int = 1) -> torch.Tensor:
    """Batch statistics over every axis but `ch` (1: NCHW; -1: channels
    last), the running statistics moved in place."""
    args = (bn.running_mean, bn.running_var, bn.weight, bn.bias, True, 0.1,
            bn.eps)
    if ch == 1:
        return F.batch_norm(x, *args)
    return F.batch_norm(x.reshape(-1, x.shape[-1]), *args).reshape(x.shape)


class Dropouts:
    """The model's dropout sites: a forward pre-hook on the site's module
    applies ``where(mask, x / keep, 0)`` to each input it takes."""

    def __init__(self, model: ref.StreamMOS, rate: float):
        self.keep = 1.0 - rate
        self.mask: Optional[MaskFn] = None
        for site in SITES:
            owner = model.get_submodule(site.rsplit(".", 1)[0])
            owner.register_forward_pre_hook(self._hook(site))

    def _hook(self, site: str):
        def hook(module, args):
            x = args[0]
            if isinstance(x, (list, tuple)):
                return ([self._drop(site, i, v) for i, v in enumerate(x)],)
            return (self._drop(site, 0, x),) + tuple(args[1:])
        return hook

    def _drop(self, site: str, call: int, x: torch.Tensor) -> torch.Tensor:
        if self.mask is None:
            raise RuntimeError("a train forward needs its dropout masks")
        keep = self.mask(site, call, x.shape)
        if keep.shape != x.shape:
            raise ValueError(f"mask of {site} #{call} {tuple(keep.shape)} for "
                             f"an input {tuple(x.shape)}")
        return torch.where(keep, x / self.keep, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))


def train_model(config: Mapping, weights: Mapping[str, torch.Tensor], device,
                precision: ref.Precision = ref.Precision()) -> ref.StreamMOS:
    """The stage-1 network in train mode from `weights` (the running
    statistics included), with `dropouts` (a `Dropouts`) attached."""
    m = config["model"]
    if m.get("attn_dropout", 0.0):
        raise NotImplementedError("the reference models no attention dropout")
    if config.get("with_refine"):
        raise NotImplementedError("the training reference is stage 1")
    model = ref.StreamMOS(m, False, precision)
    missing, unexpected = model.load_state_dict(dict(weights), strict=False)
    if unexpected or any("num_batches_tracked" not in k for k in missing):
        raise KeyError(f"weights do not fit the reference: {missing[:4]} "
                       f"{unexpected[:4]}")
    for bn in model.modules():
        if isinstance(bn, ref.BN):
            bn.forward = types.MethodType(_train_bn, bn)
    model.dropouts = Dropouts(model, m["dropout_rate"])
    return model.to(device).train()


# -------------------------------------------------------------------- loss

def ohem(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logits (n, C), targets (n,) int64."""
    nll = F.cross_entropy(logits, targets, ignore_index=0, reduction="none")
    k = max(int(OHEM_RATIO * nll.shape[0]), 1)
    return nll.mean() + OHEM_WEIGHT * nll.topk(k, sorted=False).values.mean()


def _lovasz_grad(fg_sorted: torch.Tensor) -> torch.Tensor:
    gts = fg_sorted.sum()
    inter = gts - fg_sorted.cumsum(0)
    union = gts + (1.0 - fg_sorted).cumsum(0)
    jaccard = 1.0 - inter / union
    return torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]])


def lovasz_softmax(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Lovasz-softmax over the classes present among the labelled
    elements (Berman et al.'s `lovasz_softmax_flat`); logits (n, C)."""
    valid = targets != 0
    probas = torch.softmax(logits, -1)[valid]
    labels = targets[valid]
    losses = []
    for c in range(logits.shape[-1]):
        fg = (labels == c).float()
        if not bool(fg.sum() > 0):
            continue
        errors = (fg - probas[:, c]).abs()
        errors_sorted, perm = torch.sort(errors, descending=True)
        losses.append(torch.dot(errors_sorted, _lovasz_grad(fg[perm]).detach()))
    if not losses:
        return logits.sum() * 0.0
    return torch.stack(losses).mean()


def seg_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    C = logits.shape[-1]
    lg, tg = logits.float().reshape(-1, C), targets.reshape(-1).long()
    return ohem(lg, tg) + LOVASZ_WEIGHT * lovasz_softmax(lg, tg)


def bev_targets(labels: torch.Tensor, bev_coord: torch.Tensor, hw) -> torch.Tensor:
    """Per-point labels (B, N) -> (B, h, w): each cell's largest label at
    half resolution, empty cells 0."""
    grid = ref.scatter_max(labels.float()[..., None], bev_coord, hw,
                           (0.5, 0.5), "bev")
    return grid[..., 0].long()


def window_loss(m: Mapping, out: Dict, targets: torch.Tensor,
                bev_coord: torch.Tensor) -> torch.Tensor:
    H, W = m["voxel"]["bev_shape"][:2]
    bev = bev_targets(targets, bev_coord, (H // 2, W // 2))
    aux = sum(seg_loss(a, bev) for a in out["aux"]) / 3.0
    return seg_loss(out["pred"], targets) + aux


def streaming_loss(model: ref.StreamMOS, xyzi: torch.Tensor,
                   targets: torch.Tensor, mask: MaskFn,
                   on_window: Optional[Callable[[int, Dict], None]] = None
                   ) -> torch.Tensor:
    """xyzi (S, B, T, N, 4), targets (S, B, N) -> the mean loss of the S
    windows. `mask(window, site, call, shape)`; `on_window(i, out)` sees
    each window's outputs (pred, aux, memory)."""
    m = model.m
    S, B = xyzi.shape[:2]
    memory = ref.memory_zeros(m, B, xyzi.device)
    total = 0.0
    for i in range(S):
        b = ref.featurize(xyzi[i], m["voxel"])
        model.dropouts.mask = (lambda site, call, shape, i=i:
                               mask(i, site, call, shape))
        out = model(b["points"], b["bev_coord"], b["rv_coord"], memory, i > 0)
        model.dropouts.mask = None
        if on_window is not None:
            on_window(i, out)
        memory = out["memory"]
        total = total + window_loss(m, out, targets[i], b["bev_coord"][:, 0, :, :2])
    return total / S


# --------------------------------------------------------------- optimizer

def learning_rate(optimize: Mapping, epoch_steps: int, count: int) -> float:
    """The recipe's 'step' schedule at update `count` (from 0)."""
    if optimize["schedule"] != "step":
        raise NotImplementedError(optimize["schedule"])
    total = max((optimize["end_epoch"] - optimize["begin_epoch"]) * epoch_steps, 1)
    warmup = max(int(total * optimize["pct_start"]), 1)
    if count < warmup:
        return optimize["base_lr"] * (count + 1) / warmup
    return optimize["base_lr"] * optimize["decay_factor"] ** (
        (count // epoch_steps) // optimize["step_epochs"])


class Trainer:
    """The model, its SGD and the update count: ``step`` runs one train
    step; the state can be read and set by parameter name."""

    def __init__(self, model: ref.StreamMOS, optimize: Mapping,
                 epoch_steps: int):
        if optimize["optimizer"] != "sgd":
            raise NotImplementedError(optimize["optimizer"])
        self.model, self.optimize, self.epoch_steps = model, optimize, epoch_steps
        self.params = dict(model.named_parameters())
        self.opt = torch.optim.SGD(
            list(self.params.values()), lr=0.0, momentum=optimize["momentum"],
            nesterov=optimize["nesterov"], weight_decay=optimize["weight_decay"])
        self.count = 0

    def trace(self) -> Dict[str, torch.Tensor]:
        """The momentum buffers by name (zeros before the first update)."""
        out = {}
        for n, p in self.params.items():
            buf = self.opt.state.get(p, {}).get("momentum_buffer")
            out[n] = torch.zeros_like(p) if buf is None else buf
        return out

    def set_trace(self, trace: Mapping[str, torch.Tensor], count: int) -> None:
        for n, p in self.params.items():
            self.opt.state[p]["momentum_buffer"] = trace[n].detach().clone()
        self.count = count

    def step(self, xyzi, targets, mask: MaskFn, on_window=None) -> torch.Tensor:
        """One step; the gradients stay in `.grad` for the caller."""
        self.opt.zero_grad(set_to_none=True)
        loss = streaming_loss(self.model, xyzi, targets, mask, on_window)
        loss.backward()
        for p in self.params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        for g in self.opt.param_groups:
            g["lr"] = learning_rate(self.optimize, self.epoch_steps, self.count)
        self.opt.step()
        self.count += 1
        return loss.detach()


def bn_buffers(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The running statistics by state-dict name."""
    return {n: b for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def grads(params: Mapping[str, nn.Parameter]) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in params.items()}
