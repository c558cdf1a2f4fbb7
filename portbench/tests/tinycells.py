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
