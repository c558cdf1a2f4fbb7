"""The eval mode, shared by the loops ``stream`` and ``batched``
(`loops.py`): the system builds the network for inference
(``eval_model``), `loops.Recorder` wraps its step function and hooks its
logits, and `check.eval_numbers` compares the chain and the window's
sampled steps with the plain reference (`reference/streammos.py`)."""
from __future__ import annotations

import torch

from portbench import check, faults, loops
from portbench import weights as wts
from portbench.reference import streammos as ref

FAULTS = faults.FAULTS


def mode(loop_fn):
    """The `run` of the eval loop `loop_fn` (`loops.stream`, `loops.batched`)."""

    def run(system, cell, w_seed, t_seed, seconds, trace, device):
        meta = ref.StreamMOS(cell.config["model"], cell.config["with_refine"]
                             ).to("meta")
        weights = wts.draw_weights(meta, w_seed, device)
        t = cell.traffic
        model = system.eval_model(cell.config, weights, device)
        recorder = loops.Recorder(t["check_steps"], t["chain_steps"], t_seed)
        undo = system.instrument(recorder.wrap)
        unhook = system.hook_logits(model, recorder.on_logits)
        try:
            rec = loop_fn(system, model, cell, t_seed, seconds, trace, device,
                          recorder)
        finally:
            undo()
            unhook()
        rec.host_spans_s = recorder.spans
        del model
        if device.type == "cuda":
            torch.cuda.empty_cache()

        def compare():
            chain, sample = recorder.chain, recorder.sample()
            numbers = check.eval_numbers(cell, rec, chain, sample, weights,
                                         device)
            if (len(chain) != t["chain_steps"]
                    or len(sample) != min(t["check_steps"], rec.steps)):
                numbers["finite"] = 0.0
            return numbers, len(chain + sample)

        return rec, compare

    return run
