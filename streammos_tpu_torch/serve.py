"""Streaming TTA evaluation: the per-frame eval step and the frame loop.

Counterparts of `streammos_tpu/train/trainer.py:make_eval_step` (folded
TTA) and the frame loop of `streammos_tpu/train/evaluate.py:stream_eval`.
One stream: each frame's four flip variants run folded through the model,
and each variant keeps its own short-term memory slot from frame to frame.
"""
from __future__ import annotations

from typing import Iterable, Iterator, Mapping, Optional, Tuple

import torch

from streammos_tpu_torch.config import Config
from streammos_tpu_torch.models.stream_mos import (V_TTA, StreamMOSNet,
                                                   featurize, memory_shape,
                                                   tta_expand_folded,
                                                   tta_scores)
from streammos_tpu_torch.utils.profiling import count, span, to_device
from streammos_tpu_torch.weights import init_random_, load_state_dict_checked


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain versions on the CPU")
    return device


def build_model(cfg: Config, *, with_refine: bool = True, device="cuda",
                state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                seed: Optional[int] = None) -> StreamMOSNet:
    """The eval model on `device`, with weights from `state_dict` (reference
    key names) or, failing that, drawn from `seed`."""
    device = resolve_device(device)
    model = StreamMOSNet(cfg.model, with_refine=with_refine, tta_fold=True)
    if state_dict is not None:
        load_state_dict_checked(model, state_dict)
    else:
        init_random_(model, torch.Generator().manual_seed(
            cfg.seed if seed is None else seed))
    return model.to(device).eval()


def initial_memory(model: StreamMOSNet, bt: int = 1) -> torch.Tensor:
    device = next(model.parameters()).device
    return torch.zeros(memory_shape(model.cfg, V_TTA * bt),
                       dtype=torch.float32, device=device)


@torch.inference_mode()
def eval_step(model: StreamMOSNet, xyzi: torch.Tensor, memory: torch.Tensor,
              use_memory: bool
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """One frame: xyzi (Bt, T, N, 4) raw points on the model's device ->
    (scores (Bt, N, classes), bf_scores or None, new_memory). Scores are
    the TTA mean of the per-variant softmax. Counted in ``smt.steps``."""
    cfg = model.cfg
    count("smt.steps")
    with span("smt.step"):
        with span("smt.featurize"):
            batch = featurize(tta_expand_folded(xyzi), cfg)
        out = model(batch["points"], batch["bev_coord"], batch["rv_coord"],
                    memory, use_memory)
        with span("smt.heads.scores"):
            scores = tta_scores(out["pred_folded"], cfg.class_num)
            bf_scores = (tta_scores(out["bf_pred_folded"], cfg.class_num)
                         if "bf_pred_folded" in out else None)
    return scores, bf_scores, out["memory"]


def stream_eval(model: StreamMOSNet, frames: Iterable[Mapping],
                carry_across_sequences: bool = False
                ) -> Iterator[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
    """Yield (scores, bf_scores) per frame of one stream.

    frames: mappings with "xyzi" ((T, N, 4) array or tensor) and "seq_id".
    The memory resets at the first frame and, unless
    ``carry_across_sequences``, whenever the sequence id changes (the
    reference val and test loops carry it across sequences)."""
    device = next(model.parameters()).device
    memory = initial_memory(model)
    prev_seq = None
    for n, frame in enumerate(frames):
        if carry_across_sequences:
            fresh = n == 0
        else:
            fresh = n == 0 or frame["seq_id"] != prev_seq
        prev_seq = frame["seq_id"]
        with span("smt.input"):
            xyzi = to_device(frame["xyzi"], device, torch.float32)[None]
        scores, bf_scores, memory = eval_step(model, xyzi, memory,
                                              use_memory=not fresh)
        yield scores[0], None if bf_scores is None else bf_scores[0]

