"""The dataset-driven streaming evaluation and its record line.

Counterpart of `streammos_tpu/train/evaluate.py`. One loop serves both
entry points: the val CLI (`tools/val.py`, which also writes KITTI
`.label` files) and the train CLI's per-epoch validation (metric only).
Each frame of an `EvalDataset` runs through `serve.eval_step` (folded TTA,
each variant with its own memory slot carried from frame to frame); the
argmax and the metric's counts stay on the model's device, and only the
argmax of the valid points crosses to the host, where a label file is
written.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from streammos_tpu_torch import parallel, serve
from streammos_tpu_torch.data import semantic_kitti as sk
from streammos_tpu_torch.data.dataset import EvalDataset
from streammos_tpu_torch.data.loader import PrefetchLoader
from streammos_tpu_torch.metrics import MultiClassMetric


def _write_labels(pred: torch.Tensor, valid_mask: np.ndarray, root: str,
                  seq_id: str, file_id: str, lut: Optional[np.ndarray]) -> None:
    """Scatter the valid points' labels back to raw scan order (0 for the
    cropped points), map them through `lut` when given, write
    `<root>/<seq>/predictions/<frame>.label` as uint32."""
    full = np.zeros(valid_mask.shape[0], np.uint32)
    full[valid_mask] = pred.cpu().numpy().astype(np.uint32)
    if lut is not None:
        full = lut[full].astype(np.uint32)
    out_dir = os.path.join(root, seq_id, "predictions")
    os.makedirs(out_dir, exist_ok=True)
    full.tofile(os.path.join(out_dir, file_id + ".label"))


def stream_eval(cfg, dcfg, model, *, with_refine: bool, with_labels: bool,
                logger, dataset=None, save_root: Optional[str] = None,
                bf_root: Optional[str] = None,
                carry_across_sequences: bool = False
                ) -> Optional[Dict[str, float]]:
    """Run the streaming eval over ``dataset`` (or a fresh `EvalDataset`
    of ``dcfg``'s validation split); returns the metric dict when
    ``with_labels``.

    `model` is the folded-TTA eval model (`serve.build_model`). Label files
    are written only when ``save_root`` is given (LEARNING_MAP_INV labels,
    {0, 9, 251}), bf-label files (the raw argmax) only with the refine head
    and ``bf_root``. The memory resets at every sequence boundary unless
    ``carry_across_sequences`` (then only at the stream's first frame). The
    metric covers each frame's valid points, not its padding.
    """
    ds = dataset
    if ds is None:
        ds = EvalDataset(dcfg, split="valid", with_labels=with_labels)
    if len(ds) == 0:
        raise ValueError(f"no eval frames under {dcfg.seq_dir}")

    device = next(model.parameters()).device
    metric = MultiClassMetric(cfg.category_list)
    memory = serve.initial_memory(model)
    inv_lut = sk.label_lut(sk.LEARNING_MAP_INV)

    t0 = time.time()
    n_frames = 0
    prev_seq = None
    loader = PrefetchLoader((ds[i] for i in range(len(ds))), depth=4)
    for sample in loader:
        if carry_across_sequences:
            is_first = n_frames == 0
        else:
            is_first = sample["seq_id"] != prev_seq
        prev_seq = sample["seq_id"]
        xyzi = torch.from_numpy(sample["xyzi"]).to(device)[None]
        scores, bf_scores, memory = serve.eval_step(model, xyzi, memory,
                                                    use_memory=not is_first)
        n_frames += 1

        n_valid = dcfg.frame_point_num - sample["pad_length"]
        scores = scores[0, :n_valid]  # one stream: Bt == 1
        if with_labels:
            gt = torch.from_numpy(sample["targets"][:n_valid]).to(device)
            metric.add_batch(gt, scores)
        if save_root is not None:
            _write_labels(scores.argmax(dim=-1), sample["valid_mask"],
                          save_root, sample["seq_id"], sample["file_id"],
                          inv_lut)
        if with_refine and bf_scores is not None and bf_root is not None:
            _write_labels(bf_scores[0, :n_valid].argmax(dim=-1),
                          sample["valid_mask"], bf_root, sample["seq_id"],
                          sample["file_id"], None)

    dt = time.time() - t0
    logger.info("evaluated %d frames in %.1fs (%.2f fps)", n_frames, dt,
                max(n_frames, 1) / dt)
    if with_labels:
        return metric.get_metric()
    return None


def record_metrics(result: Dict[str, float], epoch, save_path: str,
                   logger, writer=None) -> str:
    """Append the line to `record_<rank>.txt` (rank 0 without a process
    group) and, with a writer, the metrics as ``val/<name>`` scalars at
    step `epoch`."""
    line = f"Epoch {epoch}; " + "; ".join(f"{k}: {v}"
                                          for k, v in result.items())
    logger.info(line)
    rec = os.path.join(save_path, f"record_{parallel.process_index()}.txt")
    os.makedirs(os.path.dirname(rec), exist_ok=True)
    with open(rec, "a") as f:
        f.write(line + "\n")
    if writer is not None:
        step = epoch if isinstance(epoch, int) else 0
        writer.add_scalars({f"val/{k}": float(v) for k, v in result.items()
                            if isinstance(v, (int, float))}, step)
    return line
