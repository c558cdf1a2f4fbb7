"""The system under test behind one interface, so that the same loops drive
the measured package (`Port`) or the plain reference in its place
(`Reference`: the control, computed in a lower precision).

Eval: ``eval_model(config, weights, device)``, ``stream_eval(model,
frames)`` (yields (scores, bf_scores) a frame of one stream),
``eval_step(model, xyzi, memory, use_memory)`` (one step of Bt streams),
``initial_memory(model, bt)``. Every eval step goes through one function
that `instrument` can wrap with the loops' recorder.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Iterator, Mapping

import torch

from portbench.reference import streammos as ref


def _tuples(d: Mapping) -> Dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def port_config(config: Mapping):
    """The measured package's `Config` for a configuration file: its
    registered config with the file's model and optimizer fields."""
    from streammos_tpu_torch import config as pc

    cfg = pc.get_config(config["port_config"])
    model = dict(config["model"])
    voxel = pc.VoxelConfig(**_tuples(model.pop("voxel")))
    return dataclasses.replace(
        cfg, model=pc.ModelConfig(**_tuples(model), voxel=voxel),
        optimize=pc.OptimizeConfig(**config["optimize"]))


class Port:
    """`streammos_tpu_torch`: `serve.build_model`, `serve.stream_eval`,
    `serve.eval_step`."""

    def __init__(self):
        from streammos_tpu_torch import serve
        self.serve = serve

    def eval_model(self, config, weights, device):
        return self.serve.build_model(port_config(config),
                                      with_refine=config["with_refine"],
                                      device=device, state_dict=weights)

    def instrument(self, wrap: Callable[[Callable], Callable]) -> Callable:
        """Route `serve.eval_step` (which `serve.stream_eval` calls by name)
        through `wrap`; returns the undo."""
        original = self.serve.eval_step
        self.serve.eval_step = wrap(original)

        def undo():
            self.serve.eval_step = original
        return undo

    @staticmethod
    def hook_logits(model, fn: Callable) -> Callable:
        """Call fn(pred, bf_pred) with each forward's logits as (V*Bt, N,
        classes) rows, variant-major; returns the undo."""
        def hook(module, args, out):
            view = lambda t: t.permute(2, 0, 1, 3).reshape(
                -1, t.shape[1], t.shape[3])
            fn(view(out["pred"]),
               view(out["bf_pred"]) if "bf_pred" in out else None)
        return model.register_forward_hook(hook).remove

    def stream_eval(self, model, frames: Iterable[Mapping]) -> Iterator:
        return self.serve.stream_eval(model, frames)

    def eval_step(self, model, xyzi, memory, use_memory):
        return self.serve.eval_step(model, xyzi, memory, use_memory)

    def initial_memory(self, model, bt: int):
        return self.serve.initial_memory(model, bt)


def reference_model(config, weights, device,
                    precision: ref.Precision = ref.Precision()) -> ref.StreamMOS:
    model = ref.StreamMOS(config["model"], config["with_refine"], precision)
    missing, unexpected = model.load_state_dict(dict(weights), strict=False)
    if unexpected or any("num_batches_tracked" not in k for k in missing):
        raise KeyError(f"weights do not fit the reference: {missing[:4]} "
                       f"{unexpected[:4]}")
    return model.to(device)


def ref_logit_hook(model: ref.StreamMOS, fn: Callable) -> Callable:
    """Call fn(pred, bf_pred) with each forward's logits; returns the undo."""
    def hook(module, args, out):
        fn(out["pred"], out.get("bf_pred"))
    return model.register_forward_hook(hook).remove


class Reference:
    """The plain reference in the program's place, in `precision`."""

    def __init__(self, precision: ref.Precision):
        self.precision = precision
        self.step_fn = ref.eval_frame

    def eval_model(self, config, weights, device):
        return reference_model(config, weights, device, self.precision)

    def instrument(self, wrap):
        original = self.step_fn
        self.step_fn = wrap(original)

        def undo():
            self.step_fn = original
        return undo

    @staticmethod
    def hook_logits(model, fn: Callable) -> Callable:
        return ref_logit_hook(model, fn)

    def stream_eval(self, model, frames):
        device = next(model.parameters()).device
        memory = self.initial_memory(model, 1)
        for n, frame in enumerate(frames):
            xyzi = torch.as_tensor(frame["xyzi"], dtype=torch.float32,
                                   device=device)[None]
            scores, bf, memory = self.step_fn(model, xyzi, memory, n > 0)
            yield scores[0], None if bf is None else bf[0]

    def eval_step(self, model, xyzi, memory, use_memory):
        return self.step_fn(model, xyzi, memory, use_memory)

    def initial_memory(self, model, bt):
        return ref.memory_zeros(model.m, ref.V_TTA * bt,
                                next(model.parameters()).device)
