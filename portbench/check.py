"""The comparison that decides `correct`: what the timed path produced,
against the plain reference (`reference/streammos.py`) in float32 with TF32
off, on the benchmark's own inputs and weights. Run after the window,
after the peak was read, with the program freed.

Two kinds of steps are compared, each by its logits and its new memory
(L2 of the difference over the reference's):

* the chain: the first `chain_steps` calls from the fresh start, on the
  path the window takes. The reference runs them from its own fresh
  memory and carries its own memory from link to link, so a drift of the
  carried state shows as it grows (`chain_*`);
* a seeded sample of the window's steps. These follow hundreds of
  carried frames, more than the reference can replay within a run, so
  the reference works each out again from the same frames and the memory
  the program carried into it: the window's steps link by link.

The scores of every compared step are checked against the TTA mean of
the softmax of the program's own logits (the stage after the network, by
itself).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

from portbench import sut
from portbench.reference import streammos as ref


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matrix products and convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def tta_mean(logits: torch.Tensor, bt: int) -> torch.Tensor:
    """The scores the program's own logits (V*Bt, N, classes), rows
    variant-major, give: the mean over the variants of the softmax."""
    v = logits.shape[0] // bt
    x = logits.float().reshape(v, bt, *logits.shape[1:]).permute(1, 2, 0, 3)
    return torch.softmax(x.contiguous(), dim=-1).mean(dim=2)


def eval_numbers(cell, rec, chain: List[Dict], sample: List[Dict], weights,
                 device) -> Dict:
    """The widest gaps over the chain and over the sample."""
    bank = rec.check["bank"]
    out = {"scores_max": 0.0, "scores_rms": 0.0, "bf_scores_max": 0.0,
           "bf_scores_rms": 0.0, "chain_logits_rel": 0.0,
           "chain_memory_rel": 0.0, "memory_rel": 0.0, "logits_rel": 0.0,
           "scores_vs_logits": 0.0, "labels_differ": 0.0, "finite": 1.0}
    rel = lambda g, w: float((g.float() - w).norm() / w.norm())
    with float32_exact():
        model = sut.reference_model(cell.config, weights, device)
        logits = {}
        sut.ref_logit_hook(model, lambda p, b: logits.update(p=p, b=b))

        def compare(c: Dict, memory: torch.Tensor, prefix: str):
            """One step from `memory`; returns the reference's new memory."""
            xyzi = torch.stack([bank[i] for i in c["frames"]]).to(device)
            want = ref.eval_frame(model, xyzi, memory, c["use_memory"])
            for key, w in (("logits", logits["p"]), ("bf_logits", logits["b"])):
                if w is None:
                    continue
                if key not in c or c[key].shape != w.shape:
                    out["finite"] = 0.0
                    continue
                out[prefix + "logits_rel"] = max(out[prefix + "logits_rel"],
                                                 rel(c[key], w))
                scores = c["scores" if key == "logits" else "bf_scores"]
                out["scores_vs_logits"] = max(out["scores_vs_logits"], float(
                    (scores - tta_mean(c[key], scores.shape[0])).abs().max()))
            got = (c["scores"], c.get("bf_scores"), c["memory_out"])
            for key, g, w in zip(("scores", "bf_scores"), got[:2], want[:2]):
                if w is None:
                    continue
                if g is None or g.shape != w.shape:
                    out["finite"] = 0.0
                    continue
                d = (g.float() - w).abs()
                out[key + "_max"] = max(out[key + "_max"], float(d.max()))
                out[key + "_rms"] = max(out[key + "_rms"],
                                        float(d.square().mean().sqrt()))
                out["labels_differ"] = max(out["labels_differ"], float(
                    (g.argmax(-1) != w.argmax(-1)).float().mean()))
            out[prefix + "memory_rel"] = max(out[prefix + "memory_rel"],
                                             rel(got[2], want[2]))
            if not all(bool(torch.isfinite(t).all()) for t in got
                       if t is not None):
                out["finite"] = 0.0
            return want[2]

        memory = ref.memory_zeros(model.m, chain[0]["memory_in"].shape[0],
                                  device)
        for c in chain:
            memory = compare(c, memory, "chain_")
        for c in sample:
            compare(c, c["memory_in"], "")
    out["steps_checked"] = float(len(chain) + len(sample))
    return out


def verdict(numbers: Dict, limits: Dict) -> bool:
    """Every compared number within its limit, every output finite."""
    return numbers.get("finite", 0.0) == 1.0 and all(
        np.isfinite(numbers[k]) and numbers[k] <= v for k, v in limits.items())
