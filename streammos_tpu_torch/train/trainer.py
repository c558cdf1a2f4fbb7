"""The training state, the train step, the eval step, and the model a
trainer starts from.

Counterpart of `streammos_tpu/train/trainer.py`. One train step is the
whole streaming objective (`streaming_loss`: S windows with the memory
carry and BPTT through it), one backward, the gradient's global norm and
one optimizer update; across processes, the same step on the global
batch (`streammos_tpu_torch.parallel`). As in JAX, every parameter is
differentiated and the whole model runs in train mode, so in stage 2
(``freeze_except="refine"``) the frozen backbone's BN running statistics
move while only the refine head's parameters change.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from streammos_tpu_torch import parallel
from streammos_tpu_torch.config import Config
from streammos_tpu_torch.models.stream_mos import (StreamMOSNet, stage_forward,
                                                   streaming_loss, tta_scores)
from streammos_tpu_torch.serve import resolve_device
from streammos_tpu_torch.train.checkpoint import graft_params
from streammos_tpu_torch.train.optim import (Optimizer, apply_updates,
                                             global_norm)
from streammos_tpu_torch.utils.profiling import count, span
from streammos_tpu_torch.weights import init_random_


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN statistics), the optimizer state and
    the number of steps taken."""
    model: StreamMOSNet
    opt_state: Dict
    step: int = 0


def create_train_state(model: StreamMOSNet, tx: Optimizer) -> TrainState:
    return TrainState(model, tx.init(dict(model.named_parameters())))


def make_train_step(model: StreamMOSNet, cfg: Config, tx: Optimizer,
                    stage2: bool = False, remat: bool = False
                    ) -> Callable[..., Tuple[TrainState, Dict]]:
    """Returns step(state, windows, generator=None) -> (state, metrics):
    the state is updated in place and returned; metrics are the loss and
    the global norm of the gradient over every parameter (a parameter the
    loss does not reach counts as a zero gradient). `windows` is laid out
    as `streaming_loss` documents; `generator` (a CPU `torch.Generator`)
    seeds the dropout of the step's windows. A step is span
    ``smt.train.step`` (with ``smt.train.backward`` and
    ``smt.train.optimizer`` inside) and counts one ``train.steps``; on a
    card it also counts in ``train.saved_bytes`` the bytes that the
    windows' forward and loss allocated and still hold when the backward
    starts (what autograd keeps for the backward through the S windows).

    Data-parallel (a process group active): `windows` holds this rank's
    rows of the global batch, and the step is JAX's step on the global
    batch. The BN statistics and the losses are the global batch's (`BN`,
    `single_frame_loss`), so every rank computes the same global loss L.
    Each rank back-propagates L / W (W ranks): the gathers' backward sums
    the W ranks' cotangents of the gathered logits, W x (1/W) dL/dlogits,
    so each rank receives exactly dL/d(its logits), and the BN all-reduce's
    backward likewise sums the ranks' cotangents of the statistics. Each
    rank's gradient is then its rows' share of dL/dtheta, and the sum over
    the ranks (`all_reduce_grads`, in flat buckets) is JAX's gradient.
    The loss and `grad_norm` reported are the global loss and the norm of
    the summed gradient, the same on every rank."""
    params = dict(model.named_parameters())

    def step_fn(state: TrainState, windows: Mapping[str, torch.Tensor],
                generator: Optional[torch.Generator] = None):
        if state.model is not model:
            raise ValueError("the state holds another model than the step")
        with span("smt.train.step"):
            for p in params.values():
                p.grad = None
            device = next(iter(params.values())).device
            card = device.type == "cuda"
            held = torch.cuda.memory_allocated(device) if card else 0
            loss = streaming_loss(model, windows, cfg.model, generator,
                                  stage2=stage2, remat=remat)
            if card:
                count("train.saved_bytes",
                      torch.cuda.memory_allocated(device) - held)
            with span("smt.train.backward"):
                if parallel.active():
                    (loss / parallel.process_count()).backward()
                else:
                    loss.backward()
            grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                     for n, p in params.items()}
            parallel.all_reduce_grads(grads)
            with span("smt.train.optimizer"):
                updates, state.opt_state = tx.update(grads, state.opt_state,
                                                     params)
                apply_updates(params, updates)
            state.step += 1
            count("train.steps")
            return state, {"loss": loss.detach(),
                           "grad_norm": global_norm(grads)}

    return step_fn


def make_eval_step(model: StreamMOSNet, cfg: Config,
                   with_refine: bool = False):
    """Returns eval(batch, memory, use_memory) -> (scores (Bt, N, classes),
    bf_scores or None, new_memory): the TTA mean of the per-variant softmax.
    Unfolded, the batch is one stream's TTA fan (`tta_expand`) and the
    scores are its mean over the batch axis; folded, one row per stream."""

    def tta_mean(out, key):
        if model.tta_fold:
            return tta_scores(out[key + "_folded"], cfg.model.class_num)
        return torch.softmax(out[key], dim=-1).mean(dim=0)[None]

    @torch.inference_mode()
    def eval_fn(batch, memory, use_memory: bool):
        out = stage_forward(model, batch, memory, use_memory, train=False)
        scores = tta_mean(out, "pred")
        bf_scores = tta_mean(out, "bf_pred") if with_refine else None
        return scores, bf_scores, out["memory"]

    return eval_fn


def build_train_model(cfg: Config, stage2: bool = False, *, device="cuda",
                      state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                      seed: Optional[int] = None) -> StreamMOSNet:
    """The unfolded model a trainer runs (refine head on for stage 2), on
    `device`, in train mode. Weights are drawn from `seed` (default
    ``cfg.seed``); then every entry of `state_dict` (reference key names)
    whose key and shape the model has replaces the drawn one, as the
    reference's ``load_state_dict(strict=False)`` grafts a stage-1
    checkpoint into stage 2. That carries the BN running statistics too,
    where the JAX CLI grafts ``params`` only and starts stage 2 from fresh
    statistics: a deliberate difference."""
    device = resolve_device(device)
    model = StreamMOSNet(cfg.model, with_refine=stage2)
    init_random_(model, torch.Generator().manual_seed(
        cfg.seed if seed is None else seed))
    if state_dict is not None:
        model.load_state_dict(graft_params(model.state_dict(), state_dict))
    return model.to(device).train()
