"""One stage-2 train step of the port (StreamMOS_tiny with the refine head,
``freeze_except="refine"``, float32, 3 windows of 512 points) against JAX's
`make_train_step` from the same weights and windows.

As in JAX, every parameter is differentiated (the gradient norm runs over
all of them), only the refine head's parameters change, and the whole
model runs in train mode, so the frozen backbone's BN running statistics
move too. Tolerances as `tests/test_torch_train_step.py`.
"""
import numpy as np
import pytest
import torch

from tests.test_torch_common import jax_tiny_model
from tests.test_torch_train_step import (N, SEED, assert_updates_match,
                                         compare_with_jax, make_windows)


@pytest.fixture(scope="module")
def stage2():
    _, variables = jax_tiny_model(N)
    return compare_with_jax(variables, make_windows(SEED, True), stage2=True)


def test_stage2_loss_and_grad_norm_match_jax(stage2):
    metrics, (loss, grad_norm), *_ = stage2
    assert np.isfinite(float(metrics["loss"]))
    np.testing.assert_allclose(float(metrics["loss"]), loss, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), grad_norm,
                               rtol=2e-4)


def test_stage2_updates_only_the_refine_head(stage2):
    _, _, before, got, want = stage2
    params = [k for k in want if not k.endswith(("running_mean",
                                                 "running_var"))]
    refine = [k for k in params if k.startswith("refine.")]
    assert refine
    for k in params:
        if k in refine:
            assert not torch.equal(got[k], before[k]), k
        else:
            assert torch.equal(got[k], before[k]), k
            assert torch.equal(want[k], before[k]), k
    assert_updates_match(before, got, want, refine)


def test_stage2_backbone_bn_statistics_move_as_in_jax(stage2):
    _, _, before, got, want = stage2
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    backbone = [k for k in stats if not k.startswith("refine.")]
    assert len(backbone) > 100
    for k in stats:
        assert not torch.equal(got[k], before[k]), k
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-4,
                                   msg=k)
