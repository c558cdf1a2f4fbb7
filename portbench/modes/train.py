"""Loop ``train``: the streaming train step, one sample a step.

Traffic parameters: `batch` (B), `points` (N), `windows` (S), `bank_samples`
(K), `label_shares` (unlabeled, static, moving), `epoch_steps` (the
schedule's steps an epoch), `warmup_steps`, `chain_steps`, `check_steps`,
`trace_steps`. The configuration's `log_frequency` says how often the
loss is read on the host.

Set-up draws the weights and a bank on the device from the seed: K
samples of S windows of B rows of T scans (`scans.scan_bank`) with
per-point labels 0, 1, 2 in the given shares, independent of the points.
Step n trains on sample n mod K: the port's `make_train_step` under the
configuration's optimizer (`build_optimizer`), dropout seeded by a CPU
generator from the traffic seed; every `log_frequency` steps the loss is
read on the host, as the train CLI does. The window ends with a sync.

What is recorded for the comparison (`train_check.py`), for the chain
(the first `chain_steps` steps) and a seeded reservoir of `check_steps`
window steps, in buffers allocated before the window: the parameters,
running statistics, momentum and update count carried into the step, the
sample, the dropout masks drawn (the elements a dropout site passed on),
the first window's point logits, each window's and row's squared norm of
the loss's gradient on the heads' logits, the loss, the gradient, and the
parameters, statistics and momentum after it.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import loops, scans, sut, train_check, train_faults
from portbench import weights as wts
from portbench.reference import streammos as ref
from portbench.reference import streammos_train as rt

FAULTS = train_faults.FAULTS


def draw_bank(cell, seed: int, device):
    """(xyzi (K, S, B, T, N, 4) float32, labels (K, S, B, N) int32) on
    `device`."""
    t = cell.traffic
    K, S, B, N = t["bank_samples"], t["windows"], t["batch"], t["points"]
    T = cell.config["model"]["seq_num"]
    gen = torch.Generator(device=device).manual_seed(seed)
    xyzi = scans.scan_bank(gen, K * S * B, T, N, device).reshape(
        K, S, B, T, N, 4)
    u = torch.rand((K, S, B, N), generator=gen, device=device)
    edges = torch.tensor(np.cumsum(t["label_shares"])[:-1], dtype=torch.float32,
                         device=device)
    labels = torch.bucketize(u, edges, right=True).to(torch.int32)
    return xyzi, labels


class PortSide:
    """`streammos_tpu_torch`: `trainer.build_train_model`,
    `optim.build_optimizer`, `trainer.make_train_step`."""

    def __init__(self, config, weights, device, traffic):
        from streammos_tpu_torch.nn.blocks import Dropout
        from streammos_tpu_torch.train import optim, trainer

        cfg = sut.port_config(config)
        self.model = trainer.build_train_model(cfg, stage2=False, device=device,
                                               state_dict=weights)
        tx, _ = optim.build_optimizer(cfg.optimize, traffic["epoch_steps"])
        self.state = trainer.create_train_state(self.model, tx)
        self.step_fn = trainer.make_train_step(self.model, cfg, tx)
        self.params = dict(self.model.named_parameters())
        self.dropouts = [(n, m) for n, m in self.model.named_modules()
                         if isinstance(m, Dropout) and m.rate > 0]

    def step(self, windows, generator):
        self.state, metrics = self.step_fn(self.state, windows, generator)
        return metrics["loss"]

    def trace(self):
        return self.state.opt_state["trace"]

    def count(self) -> int:
        return self.state.opt_state["count"]

    def hook(self, recorder) -> callable:
        """Feed the model's windows and its dropout sites' outputs to the
        recorder; returns the undo. A site's mask is where its output is
        not 0 (an input of 0 passes on 0 either way)."""
        at = {"window": 0, "calls": {}}

        def on_window(module, args, out):
            recorder.window(at["window"], out["pred"],
                            [out[k] for k in ("aux0", "aux1", "aux2")])
            at["window"] += 1
            at["calls"] = {}

        def on_drop(site):
            def hook(module, args, out):
                call = at["calls"].get(site, 0)
                at["calls"][site] = call + 1
                if recorder.pending is not None:
                    recorder.mask(at["window"], site, call, out != 0)
            return hook

        handles = [self.model.register_forward_hook(on_window)]
        handles += [m.register_forward_hook(on_drop(n))
                    for n, m in self.dropouts]
        recorder.on_begin = lambda: at.update(window=0, calls={})

        def undo():
            for h in handles:
                h.remove()
        return undo


class ReferenceSide:
    """The plain training reference in the program's place, in the
    system's precision; it draws its own dropout masks on the device from
    a seed the CPU generator gives each step."""

    def __init__(self, config, weights, device, traffic, precision):
        self.model = rt.train_model(config, weights, device, precision)
        self.trainer = rt.Trainer(self.model, config["optimize"],
                                  traffic["epoch_steps"])
        self.params = self.trainer.params
        self.keep = 1.0 - config["model"]["dropout_rate"]
        self.device = device
        self.recorder = None

    def step(self, windows, generator):
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        rec = self.recorder

        def mask(i, site, call, shape):
            keep = torch.rand(shape, generator=gen, device=self.device) < self.keep
            if rec is not None and rec.pending is not None:
                rec.mask(i, site, call, keep)
            return keep

        def on_window(i, out):
            if rec is not None:
                rec.window(i, out["pred"], list(out["aux"]))

        return self.trainer.step(windows["xyzi"], windows["targets"], mask,
                                 on_window)

    def trace(self):
        return self.trainer.trace()

    def count(self) -> int:
        return self.trainer.count

    def hook(self, recorder):
        self.recorder = recorder

        def undo():
            self.recorder = None
        return undo


def side_of(system, config, weights, device, traffic):
    if isinstance(system, sut.Reference):
        return ReferenceSide(config, weights, device, traffic,
                             system.precision)
    if isinstance(system, sut.Port):
        return PortSide(config, weights, device, traffic)
    raise TypeError(f"no train side for {type(system).__name__}")


class StepRecorder:
    """What a compared step carried in and gave out (module docstring),
    for the chain and a seeded reservoir of `k` window steps; the
    reservoir's buffers are allocated at the first recorded step, before
    the window, and `bytes` counts every slot's."""

    def __init__(self, k: int, chain: int, seed: int):
        self.k, self.chain_len = k, chain
        self.rng = np.random.default_rng([seed, 0x5eed])
        self.in_window = False
        self.window_calls = 0
        self.chain: List[Dict] = []
        self.slots: List[Dict] = []
        self.pending: Optional[Dict] = None
        self.bytes = 0
        self.layouts = None
        self.on_begin = lambda: None

    @staticmethod
    def _put(slot: Dict, key, t: torch.Tensor) -> None:
        if key in slot:
            slot[key].copy_(t)
        else:
            slot[key] = t.detach().clone()

    def begin(self, side, sample: int, batch_shape) -> None:
        self.on_begin()
        slot = None
        if len(self.chain) < self.chain_len and not self.in_window:
            slot = {"masks": {}}
            self.chain.append(slot)
        elif self.in_window:
            j = self.window_calls
            self.window_calls += 1
            r = j if j < self.k else int(self.rng.integers(0, j + 1))
            if r < self.k:
                slot = self.slots[r]
        self.pending = slot
        if slot is None:
            return
        if self.layouts is None:
            self.layouts = (train_check.Layout(side.params),
                            train_check.Layout(rt.bn_buffers(side.model)))
        p_lay, b_lay = self.layouts
        bn = rt.bn_buffers(side.model)
        self._put(slot, "params_in", p_lay.flat(side.params))
        self._put(slot, "bn_in", b_lay.flat(bn))
        self._put(slot, "trace_in", p_lay.flat(side.trace()))
        self._put(slot, "row_sq", torch.zeros(batch_shape,
                                              device=slot["params_in"].device))
        slot["count"], slot["sample"] = side.count(), sample

    def window(self, i: int, pred: torch.Tensor, aux: List[torch.Tensor]):
        slot = self.pending
        if slot is None:
            return
        if i == 0:
            self._put(slot, "logits0", pred.float())
        for t in [pred] + list(aux):
            if t.requires_grad:
                t.register_hook(train_check.row_sq_hook(slot["row_sq"], i))

    def mask(self, i: int, site: str, call: int, keep: torch.Tensor) -> None:
        self._put(self.pending["masks"], (i, site, call), keep)

    def end(self, side, loss: torch.Tensor) -> None:
        slot, self.pending = self.pending, None
        if slot is None:
            return
        p_lay, b_lay = self.layouts
        self._put(slot, "loss", loss.float())
        self._put(slot, "grad", p_lay.flat(rt.grads(side.params)))
        self._put(slot, "params_out", p_lay.flat(side.params))
        self._put(slot, "bn_out", b_lay.flat(rt.bn_buffers(side.model)))
        if self.in_window:
            slot["filled"] = True
        if not self.slots:
            self.slots = [_empty_like(slot) for _ in range(self.k)]
            self.bytes = (self.k + self.chain_len) * _nbytes(slot)

    def sample(self) -> List[Dict]:
        """The window's sampled steps (in no order)."""
        return [s for s in self.slots if s.get("filled")]


def _empty_like(slot: Dict) -> Dict:
    out = {}
    for key, v in slot.items():
        if isinstance(v, dict):
            out[key] = _empty_like(v)
        elif isinstance(v, torch.Tensor):
            out[key] = torch.empty_like(v)
    return out


def _nbytes(slot: Dict) -> int:
    return sum(_nbytes(v) if isinstance(v, dict) else
               v.numel() * v.element_size() for v in slot.values()
               if isinstance(v, (dict, torch.Tensor)))


def run(system, cell, w_seed, t_seed, seconds, trace, device):
    t, config = cell.traffic, cell.config
    meta = ref.StreamMOS(config["model"], config["with_refine"]).to("meta")
    weights = wts.draw_weights(meta, w_seed, device)
    side = side_of(system, config, weights, device, t)
    bank = draw_bank(cell, t_seed, device)
    recorder = StepRecorder(t["check_steps"], t["chain_steps"], t_seed)
    undo = side.hook(recorder)
    generator = torch.Generator().manual_seed(t_seed)
    log_every = config["log_frequency"]
    rec = loops.Record("train")
    n, win = 0, None
    try:
        while True:
            if n == t["warmup_steps"]:
                win = loops._window(rec, recorder, device, trace)
                win.__enter__()
            k = n % t["bank_samples"]
            recorder.begin(side, k, (t["windows"], t["batch"]))
            loss = side.step({"xyzi": bank[0][k], "targets": bank[1][k]},
                             generator)
            recorder.end(side, loss)
            if n % log_every == 0:
                float(loss)
            n += 1
            if win is not None:
                rec.steps += 1
                if loops._done(rec, time.perf_counter(), seconds,
                               t["trace_steps"], trace):
                    break
        win.__exit__(None, None, None)
    finally:
        undo()
    rec.frames = rec.steps
    del side
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    def compare():
        chain, sample = recorder.chain, recorder.sample()
        numbers = train_check.train_numbers(cell, bank, chain, sample,
                                            recorder.layouts, weights, device)
        if (len(chain) != t["chain_steps"]
                or len(sample) != min(t["check_steps"], rec.steps)):
            numbers["finite"] = 0.0
        return numbers, len(chain) + len(sample)

    return rec, compare
