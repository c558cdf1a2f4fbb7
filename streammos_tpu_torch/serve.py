"""Streaming TTA evaluation: the per-frame eval step and the frame loop.

Counterparts of `streammos_tpu/train/trainer.py:make_eval_step` (folded
TTA) and the frame loop of `streammos_tpu/train/evaluate.py:stream_eval`.
One stream: each frame's four flip variants run folded through the model,
and each variant keeps its own short-term memory slot from frame to frame.

On a card, the carried step (``use_memory``) of a folded model in eval
mode runs as CUDA graphs: captured once for each key (the input's shape,
the compute dtype, the device, the refine head) and replayed on every
later carried step, in segments cut at the step's spans
(`utils/graphs.py`). The first step of a stream runs eagerly.
"""
from __future__ import annotations

from typing import Iterable, Iterator, Mapping, Optional, Tuple

import torch

from streammos_tpu_torch.config import Config
from streammos_tpu_torch.models.stream_mos import (V_TTA, StreamMOSNet,
                                                   featurize, memory_shape,
                                                   tta_expand_folded,
                                                   tta_scores)
from streammos_tpu_torch.utils import graphs
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


def _step(model: StreamMOSNet, forward, xyzi: torch.Tensor,
          memory: torch.Tensor, use_memory: bool):
    """The eval step's work, with the model's forward called as `forward`."""
    cfg = model.cfg
    with span("smt.featurize"):
        batch = featurize(tta_expand_folded(xyzi), cfg)
    out = forward(batch["points"], batch["bev_coord"], batch["rv_coord"],
                  memory, use_memory)
    with span("smt.heads.scores"):
        scores = tta_scores(out["pred_folded"], cfg.class_num)
        bf_scores = (tta_scores(out["bf_pred_folded"], cfg.class_num)
                     if "bf_pred_folded" in out else None)
    return scores, bf_scores, out["memory"]


class StepGraph:
    """The carried eval step of one key as CUDA graphs, in three parts:
    before the model's forward, inside it, after it. A replay copies the
    input and the memory into the captured step's own (span
    ``smt.input``), replays the parts and returns copies of the outputs
    (``smt.output``), so a later replay overwrites none of them. The model
    is still called once a replay, its forward standing in for the middle
    part, so its forward hooks see the logits. The graphs read the weights
    where they are: weights written in place (``load_state_dict``) show in
    the next replay."""

    def __init__(self, model: StreamMOSNet, xyzi: torch.Tensor,
                 memory: torch.Tensor):
        dev = xyzi.device
        self.xyzi, self.memory = xyzi.clone(), memory.clone()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            # once eagerly on the capturing stream first: cuDNN plans,
            # cuBLAS handles and workspaces, the kernels' libraries
            _step(model, model.forward, self.xyzi, self.memory, True)
            torch.cuda.synchronize(dev)
            # the warm-up's blocks are cached for the side stream alone:
            # hand them back before the graphs' pool takes its own
            torch.cuda.empty_cache()
            with graphs.Capture() as cap:
                self.result = _step(model, self._capture_forward(cap, model),
                                    self.xyzi, self.memory, True)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.program = cap.program()
        count("graph.captures")

    def _capture_forward(self, cap: graphs.Capture, model: StreamMOSNet):
        def forward(*args):
            cap.mark()
            self.args = args
            self.out = model.forward(*args)
            cap.mark()
            return self.out
        return forward

    def _replay_forward(self, *args):
        self.program.replay(1)
        return dict(self.out)

    def __call__(self, model: StreamMOSNet, xyzi: torch.Tensor,
                 memory: torch.Tensor):
        with span("smt.input"):
            self.xyzi.copy_(xyzi)
            self.memory.copy_(memory)
        self.program.replay(0)
        model.forward = self._replay_forward
        try:
            model(*self.args)
        finally:
            del model.forward
        self.program.replay(2)
        count("graph.replays")
        with span("smt.output"):
            return tuple(None if t is None else t.clone()
                         for t in self.result)


def step_graph(model: StreamMOSNet, xyzi: torch.Tensor, memory: torch.Tensor,
               use_memory: bool) -> Optional[StepGraph]:
    """The step's graphs, captured now if its key is new; None where it
    runs eagerly: off the card, the first step of a stream, a model in
    train mode or unfolded, outside inference mode."""
    if not (xyzi.is_cuda and use_memory and model.tta_fold
            and not model.training and torch.is_inference_mode_enabled()):
        return None
    key = (tuple(xyzi.shape), xyzi.dtype, tuple(memory.shape), memory.dtype,
           xyzi.device, model.cfg.compute_dtype, model.with_refine)
    if key not in model.step_graphs:
        model.step_graphs[key] = StepGraph(model, xyzi, memory)
    return model.step_graphs[key]


@torch.inference_mode()
def eval_step(model: StreamMOSNet, xyzi: torch.Tensor, memory: torch.Tensor,
              use_memory: bool
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """One frame: xyzi (Bt, T, N, 4) raw points on the model's device ->
    (scores (Bt, N, classes), bf_scores or None, new_memory). Scores are
    the TTA mean of the per-variant softmax. Counted in ``smt.steps``; a
    step replayed from `step_graph` in ``graph.replays`` too."""
    count("smt.steps")
    with span("smt.step"):
        graph = step_graph(model, xyzi, memory, use_memory)
        if graph is not None:
            return graph(model, xyzi, memory)
        return _step(model, model, xyzi, memory, use_memory)


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

