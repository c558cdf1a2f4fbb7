"""Optimizers and learning-rate schedules over named tensors.

Counterpart of `streammos_tpu/train/optim.py`, written out rather than
taken from `torch.optim` so each step is optax's arithmetic:

* 'step' schedule: linear warmup ``(count + 1) / warmup_iters`` over
  ``pct_start`` of the total iterations, then ``decay_factor ** (epoch //
  step_epochs)``; 'OneCycle': `optax.cosine_onecycle_schedule` (div factor
  25). Both are functions of the update count, starting at 0, and the
  update with count k uses the rate at k.
* SGD: ``add_decayed_weights`` (coupled weight decay) before momentum
  with Nesterov (`optax.sgd`); AdamW: `optax.adamw` (bias-corrected
  moments, then decoupled weight decay).
* ``freeze_except``: every parameter whose name lacks the substring gets a
  zero update (`optax.masked(set_to_zero)`); its optimizer state still
  moves, as in optax.

`tx.init(params)` makes the state, `tx.update(grads, state, params)` returns
(updates, new_state), and `apply_updates` adds the updates in place.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from streammos_tpu_torch.config import OptimizeConfig

Tensors = Mapping[str, torch.Tensor]
Schedule = Callable[[int], float]


def onecycle_schedule(transition_steps: int, peak_value: float,
                      pct_start: float = 0.3, div_factor: float = 25.0,
                      final_div_factor: float = 1e4) -> Schedule:
    """`optax.cosine_onecycle_schedule`: cosine from peak/div_factor up to
    the peak at ``int(pct_start * transition_steps)``, then down to
    peak/(div_factor * final_div_factor) at `transition_steps`, constant
    after."""
    if transition_steps <= 0:
        raise ValueError("transition_steps must be positive")
    bounds = [0, int(pct_start * transition_steps), int(transition_steps)]
    values = np.cumprod([peak_value / div_factor, div_factor,
                         1.0 / (div_factor * final_div_factor)])

    def sched(count: int) -> float:
        if count >= bounds[-1]:
            return float(values[-1])
        for i in range(len(bounds) - 1):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return float(end + (start - end) / 2.0
                             * (math.cos(math.pi * pct) + 1.0))
        return 0.0

    return sched


def build_schedule(cfg: OptimizeConfig, per_epoch_iters: int) -> Schedule:
    num_epochs = cfg.end_epoch - cfg.begin_epoch
    total_iters = max(num_epochs * per_epoch_iters, 1)
    if cfg.schedule == "step":
        warmup_iters = max(int(total_iters * cfg.pct_start), 1)

        def sched(count: int) -> float:
            if count < warmup_iters:
                return cfg.base_lr * (count + 1) / warmup_iters
            step_idx = (count // per_epoch_iters) // cfg.step_epochs
            return cfg.base_lr * cfg.decay_factor ** step_idx

        return sched
    if cfg.schedule == "OneCycle":
        return onecycle_schedule(total_iters, cfg.base_lr, cfg.pct_start,
                                 25.0, cfg.base_lr / cfg.final_lr)
    raise NotImplementedError(cfg.schedule)


def freeze_mask(names, keep_substring: str) -> Dict[str, bool]:
    """True = trainable: the names that contain the substring."""
    return {n: keep_substring in n for n in names}


class Optimizer:
    """SGD (coupled weight decay, momentum, optional Nesterov) or AdamW
    over a mapping of named float32 tensors; `trainable` (name -> bool)
    zeroes the other names' updates."""

    def __init__(self, kind: str, sched: Schedule, weight_decay: float,
                 momentum: float = 0.9, nesterov: bool = True,
                 trainable: Optional[Mapping[str, bool]] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        if kind not in ("sgd", "adamw"):
            raise NotImplementedError(kind)
        self.kind, self.sched = kind, sched
        self.weight_decay, self.momentum, self.nesterov = (weight_decay,
                                                           momentum, nesterov)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.trainable = None if trainable is None else dict(trainable)

    def init(self, params: Tensors) -> Dict:
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}
        if self.kind == "sgd":
            return {"count": 0, "trace": zeros()}
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    def update(self, grads: Tensors, state: Dict, params: Tensors
               ) -> Tuple[Dict[str, torch.Tensor], Dict]:
        count = state["count"]
        step_size = -self.sched(count)
        wd = self.weight_decay
        updates, new = {}, {"count": count + 1}
        with torch.no_grad():
            if self.kind == "sgd":
                m = self.momentum
                new["trace"] = {}
                for n, g in grads.items():
                    g = g + wd * params[n]
                    t = g + m * state["trace"][n]
                    new["trace"][n] = t
                    updates[n] = (g + m * t if self.nesterov else t) * step_size
            else:
                b1, b2, c = self.b1, self.b2, count + 1
                new["mu"], new["nu"] = {}, {}
                for n, g in grads.items():
                    mu = (1 - b1) * g + b1 * state["mu"][n]
                    nu = (1 - b2) * g.square() + b2 * state["nu"][n]
                    new["mu"][n], new["nu"][n] = mu, nu
                    u = (mu / (1 - b1 ** c)) / (torch.sqrt(nu / (1 - b2 ** c))
                                                + self.eps)
                    updates[n] = (u + wd * params[n]) * step_size
            if self.trainable is not None:
                for n in updates:
                    if not self.trainable[n]:
                        updates[n] = torch.zeros_like(updates[n])
        return updates, new


def apply_updates(params: Tensors, updates: Tensors) -> None:
    """params[n] += updates[n], in place."""
    with torch.no_grad():
        for n, p in params.items():
            p.add_(updates[n])


def global_norm(tensors: Tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (`optax.global_norm`)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors.values()))


def build_optimizer(cfg: OptimizeConfig, per_epoch_iters: int,
                    params: Optional[Tensors] = None,
                    freeze_except: Optional[str] = None
                    ) -> Tuple[Optimizer, Schedule]:
    sched = build_schedule(cfg, per_epoch_iters)
    trainable = None
    if freeze_except is not None:
        if params is None:
            raise ValueError("freezing needs the parameter names")
        trainable = freeze_mask(params, freeze_except)
    if cfg.optimizer == "sgd":
        tx = Optimizer("sgd", sched, cfg.weight_decay, cfg.momentum,
                       cfg.nesterov, trainable)
    elif cfg.optimizer in ("adam", "adamw"):
        tx = Optimizer("adamw", sched, cfg.weight_decay, trainable=trainable)
    else:
        raise NotImplementedError(cfg.optimizer)
    return tx, sched


class TSEnsemble:
    """Temporal ensemble: an exponential moving average of named tensors
    (a state dict); ``update(new)`` applies ``mean = alpha * mean + (1 -
    alpha) * new`` to the floating-point ones and takes the others from
    `new`."""

    def __init__(self, variables: Tensors, alpha: float = 0.95):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError(f"alpha {alpha} outside [0, 1]")
        self.alpha = alpha
        self.mean_variables = {n: t.detach().clone()
                               for n, t in variables.items()}

    def update(self, new_variables: Tensors) -> Dict[str, torch.Tensor]:
        a = self.alpha
        with torch.no_grad():
            self.mean_variables = {
                n: (old * a + new_variables[n] * (1.0 - a)
                    if old.is_floating_point() else
                    new_variables[n].detach().clone())
                for n, old in self.mean_variables.items()}
        return self.mean_variables
