"""Shared pieces of the benchmark's CPU tests: cells at the measured
package's tiny widths, so a whole run fits a test."""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import manifest  # noqa: E402

TRAFFIC = {
    "stream": dict(loop="stream", streams=1, points=1000, bank_frames=4,
                   warmup_frames=3, check_steps=3, chain_steps=3,
                   trace_steps=3),
    "batched": dict(loop="batched", streams=2, points=1000, bank_frames=4,
                    warmup_frames=3, check_steps=2, chain_steps=3,
                    trace_steps=3),
}
CELL_OF = {"stream": "seg_eval_1s", "batched": "seg_eval_4s"}


def tiny_cell(loop: str, dtype: str = "bfloat16") -> manifest.Cell:
    """The manifest's cell of this loop, at StreamMOS_tiny's widths and
    grids, in `dtype`, with small traffic; the cell's own limits."""
    from streammos_tpu_torch.config import get_config

    cell = manifest.resolve(manifest.load_manifest(), CELL_OF[loop])
    conf = json.loads(json.dumps(cell.config))
    conf["port_config"] = "StreamMOS_tiny"
    model = dataclasses.asdict(get_config("StreamMOS_tiny").model)
    model["compute_dtype"] = dtype
    conf["model"] = json.loads(json.dumps(model))
    return dataclasses.replace(cell, config=conf, traffic=dict(TRAFFIC[loop]))


TRAIN_TRAFFIC = dict(loop="train", batch=2, points=1000, windows=2,
                     bank_samples=3, label_shares=[0.1, 0.7, 0.2],
                     epoch_steps=100, warmup_steps=2, chain_steps=2,
                     check_steps=2, trace_steps=2)
# the provisional limits of the stage-1 train cell (PERF.md §2), set from
# the float32 port's readings on the card and the control's and faults'
TRAIN_LIMITS = {
    "chain_logits_rel": 0.02, "chain_loss_rel": 6e-4,
    "chain_row_grad_max": 0.004, "chain_grad_rel": 0.05,
    "chain_grad_leaf_max": 0.06, "chain_update_rel": 0.05,
    "chain_update_leaf_max": 0.06, "chain_bn_stats_rel": 0.004,
    "logits_rel": 0.02, "loss_rel": 6e-4, "row_grad_max": 0.004,
    "grad_rel": 0.05, "grad_leaf_max": 0.07, "update_rel": 0.025,
    "update_leaf_max": 0.035, "bn_stats_rel": 0.01}


def tiny_train_cell(dtype: str = "float32") -> manifest.Cell:
    """A stage-1 train cell (StreamMOS: no refine head, its optimizer) at
    StreamMOS_tiny's widths and grids, in `dtype`, with small traffic."""
    from streammos_tpu_torch.config import get_config

    seg = manifest.resolve(manifest.load_manifest(), CELL_OF["batched"])
    conf = json.loads(json.dumps(seg.config))
    conf.update(name="StreamMOS", port_config="StreamMOS", stage=1,
                with_refine=False, log_frequency=100)
    model = dataclasses.asdict(get_config("StreamMOS_tiny").model)
    model["compute_dtype"] = dtype
    conf["model"] = json.loads(json.dumps(model))
    conf["optimize"] = json.loads(json.dumps(
        dataclasses.asdict(get_config("StreamMOS").optimize)))
    return dataclasses.replace(
        seg, name="tiny_train", config=conf, traffic=dict(TRAIN_TRAFFIC),
        limits=dict(TRAIN_LIMITS), end_to_end=[], per_layer=[])
