"""Dynamic-point-count frame whitelist ("drop few static frames").

A copy of `streammos_tpu/data/droplist.py`: (seq, frame, #dynamic-points)
lines, one for each train-split frame with enough points of a raw moving
class; `TrainDataset` keeps only those frames. The list is derivable from
the labels, so the train CLI writes it on its first run.
"""
from __future__ import annotations

import os
import tempfile
from typing import Tuple

import numpy as np

from streammos_tpu_torch.data import semantic_kitti as sk

# raw SemanticKITTI moving classes are 252..259 (semantic-kitti.yaml)
MOVING_RAW_MIN, MOVING_RAW_MAX = 252, 259


def write_drop_list(seq_dir: str, out_path: str,
                    min_dynamic: int = 100) -> Tuple[int, int]:
    """Scan the train-split labels and write the whitelist atomically (a
    temporary file in the same directory, then `os.replace`).

    Returns (kept, total) frame counts. Frames with >= ``min_dynamic``
    points labeled as any raw moving class are kept.
    """
    out_dir = os.path.dirname(out_path) or "."
    os.makedirs(out_dir, exist_ok=True)
    n_kept = n_total = 0
    fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as out:
            for seq in sk.SPLITS["train"]:
                seq_id = str(seq).rjust(2, "0")
                lab_dir = os.path.join(seq_dir, seq_id, "labels")
                if not os.path.isdir(lab_dir):
                    continue
                for name in sorted(os.listdir(lab_dir)):
                    if not name.endswith(".label"):
                        continue
                    fid = int(name.split(".")[0])
                    raw = np.fromfile(os.path.join(lab_dir, name),
                                      dtype=np.uint32)
                    sem = (raw & 0xFFFF).astype(np.int64)
                    n_dyn = int(((sem >= MOVING_RAW_MIN)
                                 & (sem <= MOVING_RAW_MAX)).sum())
                    n_total += 1
                    if n_dyn >= min_dynamic:
                        out.write(f"{seq_id} {fid:06d} {n_dyn}\n")
                        n_kept += 1
        os.replace(tmp, out_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return n_kept, n_total
