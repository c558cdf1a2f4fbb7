"""Logging and the scalar stream of the CLIs.

A copy of `streammos_tpu/utils/logging.py`: file + console logging, and a
JSONL scalar writer with the same fields ({tag, value, step, ts} a line).
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Dict, Optional


def config_logger(log_file: Optional[str] = None,
                  name: str = "streammos") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class ScalarWriter:
    """Append-only JSONL scalar stream: one {tag, value, step, ts} per line."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def add_scalar(self, tag: str, value: float, step: int):
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": int(step), "ts": time.time()}) + "\n")
        self._f.flush()

    def add_scalars(self, scalars: Dict[str, float], step: int):
        for k, v in scalars.items():
            self.add_scalar(k, v, step)

    def close(self):
        self._f.close()
