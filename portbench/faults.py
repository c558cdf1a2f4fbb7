"""Faults planted underneath the timed path, each a context manager that
patches the measured package while it is active. The comparison must call
a run with any of them incorrect (`tests/test_portbench_faults.py` on the
CPU); on the card `control.py` reads what each does to the compared
numbers.

* ``state_unchanged``: eval steps hand back the memory they were given.
* ``half_batch``: the scores are averaged over the first half of the
  folded TTA batch.
* ``altered_answer``: the classes' scores are rolled by one at one point
  of every frame.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def state_unchanged():
    from streammos_tpu_torch import serve

    step = serve.eval_step

    def stale(model, xyzi, memory, use_memory):
        scores, bf, _ = step(model, xyzi, memory, use_memory)
        return scores, bf, memory
    with _patched(serve, "eval_step", stale):
        yield


@contextlib.contextmanager
def half_batch():
    from streammos_tpu_torch import serve

    scores = serve.tta_scores

    def half(pred_folded, class_num):
        v = pred_folded.shape[-1] // class_num
        return scores(pred_folded[..., :(v // 2) * class_num], class_num,
                      v // 2)
    with _patched(serve, "tta_scores", half):
        yield


@contextlib.contextmanager
def altered_answer():
    from streammos_tpu_torch import serve

    step = serve.eval_step

    def altered(model, xyzi, memory, use_memory):
        scores, bf, new_memory = step(model, xyzi, memory, use_memory)
        scores = scores.clone()
        scores[:, 0] = scores[:, 0].roll(1, dims=-1)
        return scores, bf, new_memory
    with _patched(serve, "eval_step", altered):
        yield


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "altered_answer": altered_answer}
