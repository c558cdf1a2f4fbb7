"""Checkpoint save / restore and stage-1 -> stage-2 grafting.

Counterpart of `streammos_tpu/train/checkpoint.py`. Layout:
``<dir>/<epoch:04d>/state.pt`` holds the whole training state, written by
`torch.save`: the model's state dict (parameters and BN statistics), the
optimizer state and the step. The streaming memory is not saved: it is
reset at the start of every stream.
"""
from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import torch

STATE_FILE = "state.pt"


def _path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"{epoch:04d}")


def save(ckpt_dir: str, epoch: int, state) -> str:
    """Write `state` (a `TrainState`) as epoch `epoch`; returns the
    epoch's directory."""
    path = _path(ckpt_dir, epoch)
    os.makedirs(path, exist_ok=True)
    torch.save({"model": state.model.state_dict(),
                "opt_state": state.opt_state, "step": state.step},
               os.path.join(path, STATE_FILE))
    return path


def restore(ckpt_dir: str, epoch: int, state):
    """Load epoch `epoch` into `state` (its model's parameters and
    statistics in place, the optimizer state on the model's device, the
    step) and return it."""
    device = next(state.model.parameters()).device
    blob = torch.load(os.path.join(_path(ckpt_dir, epoch), STATE_FILE),
                      map_location=device, weights_only=True)
    state.model.load_state_dict(blob["model"])
    state.opt_state = blob["opt_state"]
    state.step = blob["step"]
    return state


def load_model_state(ckpt_dir: str, epoch: int) -> Dict[str, torch.Tensor]:
    """The model's state dict of epoch `epoch`, on the CPU (for an eval
    model, or for grafting a stage-1 checkpoint into stage 2)."""
    blob = torch.load(os.path.join(_path(ckpt_dir, epoch), STATE_FILE),
                      map_location="cpu", weights_only=True)
    return blob["model"]


def latest_epoch(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    epochs = [int(name) for name in os.listdir(ckpt_dir)
              if name.isdigit() and os.path.isdir(os.path.join(ckpt_dir, name))]
    return max(epochs) if epochs else None


def graft_params(target: Mapping[str, torch.Tensor],
                 source: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`target` with every entry that `source` has under the same key and
    shape taken from `source` (torch ``load_state_dict(strict=False)``);
    entries only the target has (the stage-2 refine head) keep theirs."""
    return {k: (source[k] if k in source
                and tuple(source[k].shape) == tuple(v.shape) else v)
            for k, v in target.items()}
