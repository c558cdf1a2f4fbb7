"""The port's metrics against the JAX package's on random labels and scores
from numpy: `MultiClassMetric` (counts exact, the metric dict within
1e-12) and the confusion-matrix `IoUEval` (exact)."""
import numpy as np
import pytest
import torch

from streammos_tpu import metrics as jax_metrics
from streammos_tpu.utils.ioueval import IoUEval as JaxIoUEval

from streammos_tpu_torch import metrics
from streammos_tpu_torch.utils.ioueval import IoUEval

CATS = ("static", "moving")


def _batches(seed: int, n_batches: int = 4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        m = int(rng.integers(500, 5000))
        gt = rng.integers(0, 3, m).astype(np.int32)
        scores = rng.random((m, 3)).astype(np.float32)
        scores[: m // 10] = scores[: m // 10, :1]  # exact ties: first wins
        valid = rng.random(m) < 0.9
        out.append((gt, scores, valid))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_valid", [False, True])
def test_multiclass_metric_matches(seed, with_valid):
    jm, tm = jax_metrics.MultiClassMetric(CATS), metrics.MultiClassMetric(CATS)
    for gt, scores, valid in _batches(seed):
        v = valid if with_valid else None
        jm.add_batch(gt, scores, v)
        tm.add_batch(torch.from_numpy(gt), torch.from_numpy(scores),
                     None if v is None else torch.from_numpy(v))
    for k in ("tp", "pred_num", "gt_num"):
        assert tm.state[k].dtype == torch.int64
        np.testing.assert_array_equal(tm.state[k].numpy(),
                                      np.asarray(jm.state[k]).astype(np.int64))
    a, b = jm.get_metric(), tm.get_metric()
    assert a.keys() == b.keys()
    assert "moving_iou" in b and "mean_iou" in b
    for k in a:
        assert abs(a[k] - b[k]) <= 1e-12, (k, a[k], b[k])
    assert tm.state is None  # get_metric resets


def test_metric_functional_form_and_empty():
    gt, scores, _ = _batches(5, 1)[0]
    s = metrics.update(metrics.init_state(2), torch.from_numpy(gt),
                       torch.from_numpy(scores))
    js = jax_metrics.update(jax_metrics.init_state(2), gt, scores)
    assert metrics.compute(s, CATS) == jax_metrics.compute(js, CATS)
    empty = metrics.MultiClassMetric(CATS).get_metric()
    assert empty == jax_metrics.MultiClassMetric(CATS).get_metric()


@pytest.mark.parametrize("ignore", [(), (0,), (0, 2)])
def test_ioueval_matches(ignore):
    a, b = JaxIoUEval(3, ignore), IoUEval(3, ignore)
    for gt, scores, _ in _batches(7):
        pred = scores.argmax(-1)
        a.add_batch(pred, gt)
        b.add_batch(pred, gt)
    np.testing.assert_array_equal(a.conf, b.conf)
    ma, ia = a.get_iou()
    mb, ib = b.get_iou()
    assert ma == mb and np.array_equal(ia, ib)
    assert a.get_acc() == b.get_acc()
