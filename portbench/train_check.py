"""The comparison that decides `correct` for a train step: what the timed
path produced, against the plain training reference
(`reference/streammos_train.py`) in float32 with TF32 off, on the
benchmark's own weights, samples and labels, and the dropout masks the
program drew. Run after the window, with the program freed.

Two kinds of steps are compared:

* the chain: the first `chain_steps` steps from the fresh start. The
  reference starts from the same weights and carries its own parameters,
  running statistics, momentum and update count from link to link
  (`chain_*`);
* a seeded sample of `check_steps` steps of the window. The reference
  replays each from the program's state at its start: the parameters, the
  running statistics, the momentum and the update count it carried in.

Each compared step gives, widest over the steps (each a relative gap):

* `logits_rel`: the first window's point logits, L2 of the difference;
* `loss_rel`: the step's loss (the windows' mean);
* `row_grad_max`: for each window and batch row, the norm of the loss's
  gradient on that row's logits (point and aux heads): the row's share of
  the objective. The gap of norms over the reference's, or the median
  row's where that is larger. A row the loss leaves out reads 1;
* `grad_rel`: the whole gradient as one vector, L2 of the difference;
* `grad_leaf_max`: the worst leaf of the gradient: the gap between the
  program's norm and the reference's over the reference's norm of that
  leaf or of the median leaf, whichever is larger;
* `update_rel`, `update_leaf_max`: the parameters' change by the step, as
  one vector and by the worst leaf (leaves whose reference gradient is
  under a thousandth of the median leaf's are left out of the latter: they
  move by weight decay and round-off alone);
* `bn_stats_rel`: the running statistics' change by the step, as one
  vector.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import torch

from portbench.check import float32_exact
from portbench.reference import streammos_train as rt

NUMBERS = ("logits_rel", "loss_rel", "row_grad_max", "grad_rel",
           "grad_leaf_max", "update_rel", "update_leaf_max", "bn_stats_rel")
DEAD_LEAF = 1e-3


class Layout:
    """Named tensors <-> one float32 vector, in sorted name order."""

    def __init__(self, tensors: Mapping[str, torch.Tensor]):
        self.names = sorted(tensors)
        self.sizes = [tensors[n].numel() for n in self.names]

    def flat(self, tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return torch.cat([tensors[n].detach().reshape(-1).float()
                          for n in self.names])

    def load(self, vector: torch.Tensor, tensors: Mapping[str, torch.Tensor]):
        with torch.no_grad():
            for n, part in zip(self.names, vector.split(self.sizes)):
                tensors[n].copy_(part.view_as(tensors[n]))

    def leaves(self, vector: torch.Tensor) -> List[torch.Tensor]:
        return list(vector.split(self.sizes))


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    d = float((got.detach().float() - want.detach().float()).norm())
    w = float(want.detach().float().norm())
    return d / w if w > 0 else (0.0 if d == 0 else float("inf"))


def gap_of_norms(got: torch.Tensor, want: torch.Tensor) -> Tuple[float, int]:
    """max over i of |got_i - want_i| / max(want_i, median(want)), and its
    index; `got`, `want` norms of matching parts."""
    floor = torch.maximum(want, want.median())
    gaps = (got - want).abs() / floor.clamp(min=1e-30)
    i = int(gaps.argmax())
    return float(gaps[i]), i


def leaf_norms(layout: Layout, vector: torch.Tensor) -> torch.Tensor:
    return torch.stack([v.norm() for v in layout.leaves(vector)])


def row_sq_hook(row_sq: torch.Tensor, i: int):
    """A tensor hook that adds each batch row's sum of squares of the
    gradient into row_sq[i]."""
    def hook(g):
        row_sq[i].add_(g.detach().float().reshape(g.shape[0], -1)
                       .square().sum(1))
    return hook


class Replay:
    """The reference's train step from a given state, with the program's
    masks, and what it gives for the comparison."""

    def __init__(self, cell, weights, device, layouts):
        self.trainer = rt.Trainer(rt.train_model(cell.config, weights, device),
                                  cell.config["optimize"],
                                  cell.traffic["epoch_steps"])
        self.params = self.trainer.params
        self.p_lay, self.b_lay = layouts

    def set_state(self, c: Dict) -> None:
        self.p_lay.load(c["params_in"], self.params)
        self.b_lay.load(c["bn_in"], rt.bn_buffers(self.trainer.model))
        trace = {n: v.view_as(self.params[n]) for n, v in
                 zip(self.p_lay.names, self.p_lay.leaves(c["trace_in"]))}
        self.trainer.set_trace(trace, c["count"])

    def step(self, c: Dict, xyzi, targets) -> Dict:
        S, B = targets.shape[:2]
        bn = rt.bn_buffers(self.trainer.model)
        out = {"params_in": self.p_lay.flat(self.params),
               "bn_in": self.b_lay.flat(bn),
               "row_sq": torch.zeros((S, B), device=targets.device)}

        def on_window(i, o):
            if i == 0:
                out["logits0"] = o["pred"].detach()
            for t in [o["pred"]] + list(o["aux"]):
                t.register_hook(row_sq_hook(out["row_sq"], i))

        def mask(i, site, call, shape):
            return c["masks"][(i, site, call)]

        out["loss"] = self.trainer.step(xyzi, targets, mask, on_window)
        out["grad"] = self.p_lay.flat(rt.grads(self.params))
        out["params_out"] = self.p_lay.flat(self.params)
        out["bn_out"] = self.b_lay.flat(bn)
        return out


def compare(c: Dict, r: Dict, p_lay: Layout, prefix: str, out: Dict) -> None:
    """Widen `out`'s numbers by step c (the program's) against r (the
    reference's)."""
    def widen(key, value):
        out[prefix + key] = max(out[prefix + key], value)

    widen("logits_rel", rel(c["logits0"], r["logits0"]))
    widen("loss_rel", abs(float(c["loss"]) - float(r["loss"]))
          / abs(float(r["loss"])))
    widen("row_grad_max", gap_of_norms(c["row_sq"].sqrt().reshape(-1),
                                       r["row_sq"].sqrt().reshape(-1))[0])
    widen("grad_rel", rel(c["grad"], r["grad"]))
    g_ref = leaf_norms(p_lay, r["grad"])
    gap, i = gap_of_norms(leaf_norms(p_lay, c["grad"]), g_ref)
    if gap >= out[prefix + "grad_leaf_max"]:
        out[prefix + "worst_grad_leaf"] = p_lay.names[i]
    widen("grad_leaf_max", gap)
    d_got = c["params_out"] - c["params_in"]
    d_ref = r["params_out"] - r["params_in"]
    widen("update_rel", rel(d_got, d_ref))
    live = g_ref >= DEAD_LEAF * g_ref.median()
    gap, i = gap_of_norms(leaf_norms(p_lay, d_got)[live],
                          leaf_norms(p_lay, d_ref)[live])
    if gap >= out[prefix + "update_leaf_max"]:
        out[prefix + "worst_update_leaf"] = [
            n for n, ok in zip(p_lay.names, live.tolist()) if ok][i]
    widen("update_leaf_max", gap)
    out[prefix + "dead_leaves"] = float((~live).sum())
    widen("bn_stats_rel", rel(c["bn_out"] - c["bn_in"],
                              r["bn_out"] - r["bn_in"]))
    got = [c[k] for k in ("logits0", "loss", "grad", "params_out", "bn_out",
                          "row_sq")]
    if not all(bool(torch.isfinite(t).all()) for t in got):
        out["finite"] = 0.0


def train_numbers(cell, bank, chain: Sequence[Dict], sample: Sequence[Dict],
                  layouts, weights, device) -> Dict:
    """The widest gaps over the chain and over the sample. `bank` is
    (xyzi (K, S, B, T, N, 4), labels (K, S, B, N))."""
    xyzi, labels = bank
    out = {p + k: 0.0 for p in ("chain_", "") for k in NUMBERS}
    out["finite"] = 1.0
    with float32_exact():
        replay = Replay(cell, weights, device, layouts)
        for c in chain:
            r = replay.step(c, xyzi[c["sample"]], labels[c["sample"]])
            compare(c, r, layouts[0], "chain_", out)
        for c in sample:
            replay.set_state(c)
            r = replay.step(c, xyzi[c["sample"]], labels[c["sample"]])
            compare(c, r, layouts[0], "", out)
    out["steps_checked"] = float(len(chain) + len(sample))
    return out
