"""Faults planted underneath the timed train step, each a context manager
that patches the measured package while it is active. The comparison must
call a run with any of them incorrect (`tests/test_portbench_train.py` on
the CPU); on the card `control.py` reads what each does to the compared
numbers.

* ``half_batch``: each window's loss over the first half of the batch's
  rows only (at least one), the mean taken over them.
* ``stage_grad_zeroed``: the gradient of one encoder stage (`bev_net.res2`)
  zeroed before the update.
* ``update_skipped``: the parameters left as they were (the state
  unchanged).
* ``no_momentum``: the update without momentum.
* ``bn_stats_frozen``: the running statistics left as they were.
* ``memory_cut``: the memory carried into windows 1.. detached, so no
  gradient flows back through the carry.
"""
from __future__ import annotations

import contextlib

from portbench.faults import _patched

STAGE = "bev_net.res2."


@contextlib.contextmanager
def half_batch():
    from streammos_tpu_torch.models import stream_mos

    loss = stream_mos.single_frame_loss

    def half(cfg, outputs, targets, bev_targets, criterion=None):
        h = max(targets.shape[0] // 2, 1)
        cut = {k: v[:h] if k in ("pred", "aux0", "aux1", "aux2") else v
               for k, v in outputs.items()}
        return loss(cfg, cut, targets[:h], bev_targets[:h], criterion)
    with _patched(stream_mos, "single_frame_loss", half):
        yield


@contextlib.contextmanager
def stage_grad_zeroed():
    from streammos_tpu_torch import parallel

    reduce = parallel.all_reduce_grads

    def zeroed(grads, *args, **kwargs):
        for name, g in grads.items():
            if name.startswith(STAGE):
                g.zero_()
        return reduce(grads, *args, **kwargs)
    with _patched(parallel, "all_reduce_grads", zeroed):
        yield


@contextlib.contextmanager
def update_skipped():
    from streammos_tpu_torch.train import trainer

    with _patched(trainer, "apply_updates", lambda params, updates: None):
        yield


@contextlib.contextmanager
def no_momentum():
    from streammos_tpu_torch.train import optim

    update = optim.Optimizer.update

    def plain(self, grads, state, params):
        momentum, self.momentum = self.momentum, 0.0
        try:
            return update(self, grads, state, params)
        finally:
            self.momentum = momentum
    with _patched(optim.Optimizer, "update", plain):
        yield


@contextlib.contextmanager
def bn_stats_frozen():
    from streammos_tpu_torch.nn import blocks

    forward = blocks.BN._train_forward

    def frozen(self, x):
        self.update_stats = False
        try:
            return forward(self, x)
        finally:
            self.update_stats = True
    with _patched(blocks.BN, "_train_forward", frozen):
        yield


@contextlib.contextmanager
def memory_cut():
    from streammos_tpu_torch.models import stream_mos

    forward = stream_mos.stage_forward

    def cut(model, batch, memory, use_memory, train, generator=None):
        if use_memory:
            memory = memory.detach()
        return forward(model, batch, memory, use_memory, train, generator)
    with _patched(stream_mos, "stage_forward", cut):
        yield


FAULTS = {"half_batch": half_batch, "stage_grad_zeroed": stage_grad_zeroed,
          "update_skipped": update_skipped, "no_momentum": no_momentum,
          "bn_stats_frozen": bn_stats_frozen, "memory_cut": memory_cut}
