"""Plain StreamMOS training on a global batch: `streammos_train.py`'s step,
computed one window at a time so that a batch too large for one float32
forward of all its windows fits one card.

The step is the one `streammos_train.Trainer` takes (S windows of BPTT
through the carried memory, OHEM + 3 x Lovasz, SGD), and gives the same
loss, gradient and running statistics up to the order of float32 sums:

* forward, without autograd: window after window, the memory carried,
  each window's loss taken; the BN running statistics move here, once a
  window, and the dropout masks are drawn here, once;
* backward, last window first: each window runs again from the memory it
  was handed, with autograd, the same masks and the running statistics
  left alone (batch statistics as before), and back-propagates its loss
  / S together with the cotangent of the memory it handed on; the
  cotangent of the memory it took goes to the window before it.

At most one window's autograd graph is alive at a time, which is what
the data-parallel train cell's check needs: the four ranks' 12 rows
replayed on one card. It imports nothing of the measured package.
"""
from __future__ import annotations

import types
from typing import Callable, Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from portbench.reference import streammos as ref
from portbench.reference import streammos_train as rt


def _bn(bn: ref.BN, x: torch.Tensor, ch: int = 1) -> torch.Tensor:
    """`streammos_train._train_bn`, except that while `bn.frozen` the
    running statistics stay as they are (the batch statistics are used all
    the same)."""
    if not bn.frozen:
        return rt._train_bn(bn, x, ch)
    args = (bn.running_mean.clone(), bn.running_var.clone(), bn.weight,
            bn.bias, True, 0.1, bn.eps)
    if ch == 1:
        return F.batch_norm(x, *args)
    return F.batch_norm(x.reshape(-1, x.shape[-1]), *args).reshape(x.shape)


def train_model(config: Mapping, weights: Mapping[str, torch.Tensor], device,
                precision: ref.Precision = ref.Precision()) -> ref.StreamMOS:
    """`streammos_train.train_model`, its BNs able to leave the running
    statistics alone (`frozen`)."""
    model = rt.train_model(config, weights, device, precision)
    for bn in model.modules():
        if isinstance(bn, ref.BN):
            bn.frozen = False
            bn.forward = types.MethodType(_bn, bn)
    return model


def _freeze(model: ref.StreamMOS, frozen: bool) -> None:
    for bn in model.modules():
        if isinstance(bn, ref.BN):
            bn.frozen = frozen


def streaming_backward(model: ref.StreamMOS, xyzi: torch.Tensor,
                       targets: torch.Tensor, mask: rt.MaskFn,
                       on_window: Optional[Callable[[int, Dict], None]] = None
                       ) -> torch.Tensor:
    """`streammos_train.streaming_loss` and its backward, window by window
    (module docstring): the gradient lands in the parameters' `.grad`.
    `mask(window, site, call, shape)` is asked once a mask; `on_window(i,
    out)` sees each window's outputs of the run with autograd (last window
    first). Returns the mean loss of the S windows."""
    m = model.m
    S, B = xyzi.shape[:2]
    masks: Dict = {}

    def drawn(i, site, call, shape):
        masks[(i, site, call)] = mask(i, site, call, shape)
        return masks[(i, site, call)]

    def window(i, memory, pick):
        b = ref.featurize(xyzi[i], m["voxel"])
        model.dropouts.mask = (lambda site, call, shape, i=i:
                               pick(i, site, call, shape))
        try:
            out = model(b["points"], b["bev_coord"], b["rv_coord"], memory,
                        i > 0)
        finally:
            model.dropouts.mask = None
        return out, rt.window_loss(m, out, targets[i],
                                   b["bev_coord"][:, 0, :, :2])

    memories = [ref.memory_zeros(m, B, xyzi.device)]
    total = 0.0
    with torch.no_grad():
        for i in range(S):
            out, loss = window(i, memories[-1], drawn)
            memories.append(out["memory"])
            total = total + loss
    del out, loss
    memories.pop()
    cotangent = None
    _freeze(model, True)
    try:
        for i in reversed(range(S)):
            memory = memories.pop().requires_grad_(i > 0)
            out, loss = window(i, memory, lambda *key: masks[key[:3]])
            if on_window is not None:
                on_window(i, out)
            tensors, grads = [loss / S], [None]
            if cotangent is not None:
                tensors.append(out["memory"])
                grads.append(cotangent)
            torch.autograd.backward(tensors, grads)
            cotangent = memory.grad if i > 0 else None
            del out, loss, tensors, grads, memory
    finally:
        _freeze(model, False)
    return total / S


class Trainer(rt.Trainer):
    """`streammos_train.Trainer` whose step computes the loss and its
    gradient window by window (`streaming_backward`)."""

    def step(self, xyzi, targets, mask: rt.MaskFn, on_window=None
             ) -> torch.Tensor:
        self.opt.zero_grad(set_to_none=True)
        loss = streaming_backward(self.model, xyzi, targets, mask, on_window)
        for p in self.params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        for g in self.opt.param_groups:
            g["lr"] = rt.learning_rate(self.optimize, self.epoch_steps,
                                       self.count)
        self.opt.step()
        self.count += 1
        return loss.detach()
