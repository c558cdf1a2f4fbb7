"""The epoch's sample order.

The numpy part of `streammos_tpu/parallel.py`; the port trains in one
process, so the order is the whole (padded) permutation.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def process_shard_indices(num_samples: int,
                          shuffle_rng: Optional[np.random.Generator],
                          batch_size_global: int) -> np.ndarray:
    """The epoch's index order, as torch's DistributedSampler makes it for
    process 0 of 1: shuffled with ``shuffle_rng`` (when given), then padded
    with its own head to a multiple of the global batch."""
    idx = np.arange(num_samples)
    if shuffle_rng is not None:
        shuffle_rng.shuffle(idx)
    pad = (-len(idx)) % batch_size_global
    if pad:
        idx = np.concatenate([idx, idx[:pad]])
    return idx
