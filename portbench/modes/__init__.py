"""The modes of a cell, one file a traffic `loop`: ``modes/<loop>.py``.

A mode is everything that differs between kinds of cells: how the system
under test (`sut.Port`, or `sut.Reference` in the program's place) builds
what it runs, the loop and its window, what the loop records for the
comparison, and the compared numbers that `check.verdict` holds to the
cell's ``limits/<cell>.json``. A mode module defines

    run(system, cell, w_seed, t_seed, seconds, trace, device)
        -> (record, compare)

where `record` is the window's `loops.Record` (what the metric readers
read) and ``compare() -> (numbers, steps compared)`` is called after
`run` has returned and freed the program (`numbers` holds every number
the limits name, and ``finite``: 1.0 where every output compared was
there and finite); and ``FAULTS``, the faults
`control.py` plants for the mode's cells (name -> context manager). A new
kind of cell is a new mode file, found by its loop's name.
"""
from __future__ import annotations

import importlib.util
import re
from pathlib import Path

from portbench.manifest import HERE

_LOADED = {}


def load(loop: str, here: Path = HERE):
    """The mode module of `loop`: ``<here>/modes/<loop>.py``."""
    path = Path(here) / "modes" / f"{loop}.py"
    if path not in _LOADED:
        if not path.is_file():
            raise KeyError(f"no mode for loop {loop!r}: {path} is missing")
        spec = importlib.util.spec_from_file_location(
            "portbench_mode_" + re.sub(r"\W", "_", loop), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]
