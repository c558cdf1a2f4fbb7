"""CUDA graphs cut at the profiler's spans.

A `Capture` records the CUDA work of a block into a series of graphs, one
segment for each stretch between two boundaries: the opening or closing
of a `profiling.span`, or a `Capture.mark`. All segments share one memory
pool. Its `Program` replays them in the order of capture, opening and
closing each span around its segments again, so that a trace of a replay
still splits device and idle time by span: the profiler gives each kernel
of a graph the correlation of the `cudaGraphLaunch` that launched it.

Counts taken inside a segment (the hand kernels' ``kernel.*``) are taken
back when the segment ends, since a capture launches nothing, and added
again at each replay of the segment. Segments without work are not
replayed; they are kept all the same, since the pool goes when its last
graph does.
"""
from __future__ import annotations

import warnings
from typing import List, Tuple

import torch

from streammos_tpu_torch.utils import profiling

_OPEN, _CLOSE, _GRAPH = range(3)


class Program:
    """Parts of captured work, cut at the capture's marks; `replay(i)`
    runs part i. A span opened in one part may close in a later one."""

    def __init__(self, parts: List[List[Tuple]], graphs: List):
        self.parts = parts
        self._graphs = graphs   # every graph of the pool, empty ones too
        self._open: List = []

    def replay(self, i: int) -> None:
        for kind, a, b in self.parts[i]:
            if kind == _GRAPH:
                if a is not None:
                    a.replay()
                for name, n in b:
                    profiling.count(name, n)
            elif kind == _OPEN:
                ctx = profiling.span(a)
                ctx.__enter__()
                self._open.append(ctx)
            else:
                self._open.pop().__exit__(None, None, None)

    @property
    def graphs(self) -> int:
        """Graph launches a replay of every part makes."""
        return sum(op[0] == _GRAPH and op[1] is not None
                   for part in self.parts for op in part)


class Capture:
    """Capture the block's CUDA work on the current stream, which must not
    be the default stream, into span-cut segments; `program()` afterwards.
    Spans that open inside the block close inside it."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self._parts: List[List[Tuple]] = [[]]
        self._graphs: List = []
        self._graph = None
        self._before = {}

    def __enter__(self) -> "Capture":
        self._spans = profiling.spans_to(self._span)
        self._spans.__enter__()
        self._begin()
        return self

    def __exit__(self, exc_type, *exc) -> None:
        try:
            self._end()
        except Exception:
            if exc_type is None:
                raise
            # the block's own error is the one to see
        finally:
            self._spans.__exit__(None, None, None)

    def mark(self) -> None:
        """End the current part here and start the next."""
        self._end()
        self._parts.append([])
        self._begin()

    def program(self) -> Program:
        return Program(self._parts, self._graphs)

    def _span(self, name: str):
        return _Cut(self, name)

    def _cut(self, op: Tuple) -> None:
        self._end()
        self._parts[-1].append(op)
        self._begin()

    def _begin(self) -> None:
        self._before = profiling.counters()
        self._graph = torch.cuda.CUDAGraph()
        self._graphs.append(self._graph)
        self._graph.capture_begin(pool=self.pool)

    def _end(self) -> None:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            self._graph.capture_end()
        empty = False
        for w in caught:
            if "is empty" in str(w.message):
                empty = True
            else:
                warnings.warn_explicit(w.message, w.category, w.filename,
                                       w.lineno)
        before = self._before
        counted = tuple((k, n - before.get(k, 0))
                        for k, n in profiling.counters().items()
                        if n != before.get(k, 0))
        for k, n in counted:
            profiling.count(k, -n)
        if counted or not empty:
            self._parts[-1].append(
                (_GRAPH, None if empty else self._graph, counted))
        self._graph = None


class _Cut:
    """A span boundary inside a capture: a cut on entry and on exit."""

    def __init__(self, capture: Capture, name: str):
        self.capture, self.name = capture, name

    def __enter__(self):
        self.capture._cut((_OPEN, self.name, None))

    def __exit__(self, *exc):
        self.capture._cut((_CLOSE, None, None))
