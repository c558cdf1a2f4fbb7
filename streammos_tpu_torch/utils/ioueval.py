"""Standalone confusion-matrix IoU evaluator.

A numpy copy of `streammos_tpu/utils/ioueval.py`, the semantic-kitti-api
evaluator: a (C, C) confusion matrix accumulated over batches with an
ignore list, reduced to per-class and mean IoU. Complements
`streammos_tpu_torch.metrics` (the training-loop metric); this one is for
offline leaderboard-style evaluation over saved `.label` files.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


class IoUEval:
    def __init__(self, n_classes: int, ignore: Sequence[int] = ()):
        self.n_classes = n_classes
        self.ignore = np.asarray(list(ignore), dtype=np.int64)
        self.include = np.array(
            [c for c in range(n_classes) if c not in set(ignore)],
            dtype=np.int64)
        self.reset()

    def reset(self):
        self.conf = np.zeros((self.n_classes, self.n_classes), dtype=np.int64)

    def add_batch(self, pred: np.ndarray, gt: np.ndarray):
        pred = np.asarray(pred).reshape(-1).astype(np.int64)
        gt = np.asarray(gt).reshape(-1).astype(np.int64)
        idx = gt * self.n_classes + pred
        self.conf += np.bincount(
            idx, minlength=self.n_classes ** 2).reshape(self.n_classes,
                                                        self.n_classes)

    def get_stats(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        conf = self.conf.copy().astype(np.float64)
        # ignored classes contribute neither as gt nor as prediction
        conf[self.ignore, :] = 0
        tp = np.diag(conf)
        fp = conf.sum(axis=0) - tp
        fn = conf.sum(axis=1) - tp
        return tp, fp, fn

    def get_iou(self) -> Tuple[float, np.ndarray]:
        tp, fp, fn = self.get_stats()
        iou = tp / np.maximum(tp + fp + fn, 1e-15)
        mean_iou = float(iou[self.include].mean()) if len(self.include) else 0.0
        return mean_iou, iou

    def get_acc(self) -> float:
        tp, fp, fn = self.get_stats()
        total = tp.sum() + fp.sum()
        return float(tp.sum() / np.maximum(total, 1e-15))
