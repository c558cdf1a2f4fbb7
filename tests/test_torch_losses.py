"""The port's losses against `streammos_tpu/losses.py` and the loss
helpers of `streammos_tpu/models/stream_mos.py`: values and gradients
(against `jax.grad`) on seeded logits with ignore labels (class 0) among
the targets.

Tolerances: values rtol = 1e-5, gradients atol = 1e-6 + rtol = 3e-5
(float32, sums in another order; the class weights reach 280); label maps
exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streammos_tpu import losses as j_losses
from streammos_tpu.data.semantic_kitti import content_class_weights
from streammos_tpu.models import stream_mos as j_sm

from streammos_tpu_torch import losses as t_losses
from streammos_tpu_torch.data import semantic_kitti as t_kitti
from streammos_tpu_torch.models import stream_mos as t_sm
from tests.test_torch_common import tiny_cfgs, use_few_threads

use_few_threads()

C = 3
WEIGHT = content_class_weights(class_num=C)


def _inputs(shape=(2, 300), seed=0, scale=2.0):
    rng = np.random.RandomState(seed)
    logits = (rng.normal(size=shape + (C,)) * scale).astype(np.float32)
    targets = rng.randint(0, C, shape).astype(np.int32)
    return logits, targets


def _check(jfn, tfn, logits, targets):
    """Value and gradient w.r.t. the logits of both functions."""
    want, gwant = jax.value_and_grad(jfn)(jnp.asarray(logits),
                                          jnp.asarray(targets))
    x = torch.from_numpy(logits).requires_grad_()
    got = tfn(x, torch.from_numpy(targets).long())
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gwant), rtol=3e-5,
                               atol=1e-6)


LOSSES = {
    "ce": (lambda lg, tg: j_losses.cross_entropy_per_element(lg, tg).mean(),
           lambda lg, tg: t_losses.cross_entropy_per_element(lg, tg).mean()),
    "ce_weighted": (
        lambda lg, tg: j_losses.cross_entropy_per_element(
            lg, tg, 0, jnp.asarray(WEIGHT)).sum(),
        lambda lg, tg: t_losses.cross_entropy_per_element(
            lg, tg, 0, torch.from_numpy(WEIGHT)).sum()),
    "ohem": (j_losses.ce_ohem, t_losses.ce_ohem),
    "wce": (lambda lg, tg: j_losses.weighted_ce(lg, tg, jnp.asarray(WEIGHT)),
            lambda lg, tg: t_losses.weighted_ce(lg, tg,
                                                torch.from_numpy(WEIGHT))),
    "lovasz": (j_losses.lovasz_softmax, t_losses.lovasz_softmax),
}


@pytest.mark.parametrize("name", list(LOSSES))
@pytest.mark.parametrize("seed", [0, 1])
def test_loss_matches_jax(name, seed):
    _check(*LOSSES[name], *_inputs(seed=seed))


@pytest.mark.parametrize("mode", ["ce", "ohem", "wce"])
def test_make_criterion_matches_jax(mode):
    _check(j_losses.make_criterion(mode, C), t_losses.make_criterion(mode, C),
           *_inputs(seed=4))


def test_ohem_mostly_ignored():
    """Fewer valid elements than k: the top-k takes ignored zeros, which
    get no gradient."""
    logits, targets = _inputs(seed=2)
    targets[:, 20:] = 0
    _check(*LOSSES["ohem"], logits, targets)


def test_lovasz_absent_class_and_all_ignored():
    logits, targets = _inputs(seed=3)
    targets[targets == 2] = 1  # class 2 absent
    _check(*LOSSES["lovasz"], logits, targets)
    zeros = np.zeros_like(targets)
    x = torch.from_numpy(logits).requires_grad_()
    loss = t_losses.lovasz_softmax(x, torch.from_numpy(zeros))
    loss.backward()
    assert float(loss.detach()) == 0.0 and not x.grad.any()


@pytest.mark.parametrize("theta0", [3, 4])
def test_boundary_loss_matches_jax(theta0):
    rng = np.random.RandomState(5)
    logits = rng.normal(size=(2, 12, 10, C)).astype(np.float32)
    targets = rng.randint(0, C, (2, 12, 10)).astype(np.int32)
    _check(lambda lg, tg: j_losses.boundary_loss(lg, tg, theta0),
           lambda lg, tg: t_losses.boundary_loss(lg, tg, theta0),
           logits, targets)


def test_content_class_weights_copy():
    from streammos_tpu.data import semantic_kitti as j_kitti

    np.testing.assert_array_equal(t_kitti.content_class_weights(class_num=C),
                                  WEIGHT)
    for name in ("LEARNING_MAP", "BF_LEARNING_MAP", "LEARNING_MAP_INV",
                 "CONTENT", "SPLITS"):
        assert getattr(t_kitti, name) == getattr(j_kitti, name), name


def test_bev_label_from_points_matches_jax():
    rng = np.random.RandomState(6)
    labels = rng.randint(0, C, (2, 400)).astype(np.int32)
    coords = rng.uniform(-5, 70, (2, 400, 2)).astype(np.float32)
    want = j_sm.bev_label_from_points(jnp.asarray(labels), jnp.asarray(coords),
                                      (32, 32), (0.5, 0.5))
    got = t_sm.bev_label_from_points(torch.from_numpy(labels),
                                     torch.from_numpy(coords), (32, 32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("stage2", [False, True], ids=["frame", "refine"])
def test_frame_losses_match_jax(stage2):
    """single_frame_loss (point loss + the three aux BEV losses) and
    refine_loss on random outputs of the tiny model's shapes."""
    jcfg, tcfg = tiny_cfgs()
    rng = np.random.RandomState(7)
    B, N, h = 1, 300, jcfg.voxel.bev_wl[0] // 2
    outs = {k: rng.normal(size=(B, N, C)).astype(np.float32)
            for k in ("pred", "bf_pred")}
    outs.update({f"aux{i}": rng.normal(size=(B, h, h, C)).astype(np.float32)
                 for i in range(3)})
    targets = rng.randint(0, C, (B, N)).astype(np.int32)
    bev_targets = rng.randint(0, C, (B, h, h)).astype(np.int32)

    def jfn(o):
        if stage2:
            return j_sm.refine_loss(jcfg, o, jnp.asarray(targets))
        return j_sm.single_frame_loss(jcfg, o, jnp.asarray(targets),
                                      jnp.asarray(bev_targets))

    want, gwant = jax.value_and_grad(jfn)({k: jnp.asarray(v)
                                           for k, v in outs.items()})
    tout = {k: torch.from_numpy(v).requires_grad_() for k, v in outs.items()}
    tt = torch.from_numpy(targets).long()
    if stage2:
        got = t_sm.refine_loss(tcfg, tout, tt)
    else:
        got = t_sm.single_frame_loss(tcfg, tout, tt,
                                     torch.from_numpy(bev_targets).long())
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for k, v in tout.items():
        g = np.zeros_like(outs[k]) if v.grad is None else v.grad.numpy()
        np.testing.assert_allclose(g, np.asarray(gwant[k]), rtol=3e-5,
                                   atol=1e-6, err_msg=k)
