"""SemanticKITTI label taxonomy, label-file decoding and the class weights
of the 'wce' loss.

A numpy copy of the metadata of `streammos_tpu/data/semantic_kitti.py`
(importing that module would run `streammos_tpu/__init__.py`, which imports
jax): raw semantic label -> {0 unlabeled, 1 static, 2 moving}
(``LEARNING_MAP``) and -> {0 unlabeled, 1 background, 2 movable}
(``BF_LEARNING_MAP``, stage 2), the labels written back for a submission
(``LEARNING_MAP_INV``), the sequence splits, and the per-raw-class point
frequencies of the train split that `content_class_weights` turns into
loss weights. Raw labels are 32-bit: low 16 bits semantic class, high 16
bits instance id (`split_label`); `relabel` maps them through a lookup
table (`label_lut`). Numpy only: the dataset workers import this module.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np

_MOVING = (251, 252, 253, 254, 255, 256, 257, 258, 259)
_STATIC = (9, 10, 11, 13, 15, 16, 18, 20, 30, 31, 32, 40, 44, 48, 49, 50, 51,
           52, 60, 70, 71, 72, 80, 81, 99)

LEARNING_MAP: Dict[int, int] = {0: 0, 1: 0}
LEARNING_MAP.update({k: 1 for k in _STATIC})
LEARNING_MAP.update({k: 2 for k in _MOVING})

_MOVABLE = (10, 11, 13, 15, 16, 18, 20, 30, 31, 32, 252, 253, 254, 255, 256,
            257, 258, 259)
_BACKGROUND = (40, 44, 48, 49, 50, 51, 52, 60, 70, 71, 72, 80, 81, 99)

BF_LEARNING_MAP: Dict[int, int] = {0: 0, 1: 0}
BF_LEARNING_MAP.update({k: 1 for k in _BACKGROUND})
BF_LEARNING_MAP.update({k: 2 for k in _MOVABLE})

LEARNING_MAP_INV: Dict[int, int] = {0: 0, 1: 9, 2: 251}

SPLITS: Dict[str, Sequence[int]] = {
    "train": (0, 1, 2, 3, 4, 5, 6, 7, 9, 10),
    "valid": (8,),
    "test": (11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21),
}

ROAD_LABEL = 40  # copy-paste augmentation ground support (data_StreamMOS.py:231)

# Per-raw-class point-frequency statistics of the train split (yaml
# `content`, lines ~30-78) — used by the 'wce' loss mode
# (models/StreamMOS.py:49-60: per-learning-class frequency sum, weights
# 1/(freq+1e-3) with the unlabeled class zeroed).
CONTENT = {
    0: 0.018889854628292943, 1: 0.0002937197336781505,
    10: 0.040818519255974316, 11: 0.00016609538710764618,
    13: 2.7879693665067774e-05, 15: 0.00039838616015114444, 16: 0.0,
    18: 0.0020633612104619787, 20: 0.0016218197275284021,
    30: 0.00017698551338515307, 31: 1.1065903904919655e-08,
    32: 5.532951952459828e-09, 40: 0.1987493871255525,
    44: 0.014717169549888214, 48: 0.14392298360372,
    49: 0.0039048553037472045, 50: 0.1326861944777486,
    51: 0.0723592229456223, 52: 0.002395131480328884,
    60: 4.7084144280367186e-05, 70: 0.26681502148037506,
    71: 0.006035012012626033, 72: 0.07814222006271769,
    80: 0.002855498193863172, 81: 0.0006155958086189918,
    99: 0.009923127583046915, 252: 0.001789309418528068,
    253: 0.00012709999297008662, 254: 0.00016059776092534436,
    255: 3.745553104802113e-05, 256: 0.0, 257: 0.00011351574470342043,
    258: 0.00010157861367183268, 259: 4.3840131989471124e-05,
}


def content_class_weights(mapping=None, class_num: int = 3) -> np.ndarray:
    """'wce' class weights (models/StreamMOS.py:50-58): sum raw-class
    frequencies into learning classes, weight = 1/(freq + 1e-3), w[0] = 0."""
    mapping = LEARNING_MAP if mapping is None else mapping
    content = np.zeros(class_num, dtype=np.float32)
    for raw, freq in CONTENT.items():
        cls = mapping.get(raw, 0)
        content[cls] += freq
    w = 1.0 / (content + 0.001)
    w[0] = 0.0
    return w


def label_lut(mapping: Mapping[int, int], size: int = 260 + 100) -> np.ndarray:
    """Lookup table for vectorized relabeling (+100 headroom for unknown
    labels, which map to 0)."""
    lut = np.zeros(size, dtype=np.int32)
    for k, v in mapping.items():
        lut[k] = v
    return lut


# the tables of the module's own maps, made once
_LUTS: Dict[int, np.ndarray] = {id(m): label_lut(m) for m in
                                (LEARNING_MAP, BF_LEARNING_MAP,
                                 LEARNING_MAP_INV)}


def relabel(labels: np.ndarray, mapping: Mapping[int, int]) -> np.ndarray:
    lut = _LUTS.get(id(mapping))
    if lut is None:
        lut = label_lut(mapping)
    return lut[labels]


def split_label(raw: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """32-bit KITTI label -> (semantic, instance), int32."""
    return (raw & 0xFFFF).astype(np.int32), (raw >> 16).astype(np.int32)
