"""The port's schedules and optimizers against `streammos_tpu/train/optim.py`
(optax): the step and OneCycle schedules over a range of update counts,
three updates of SGD-Nesterov (coupled weight decay) and of AdamW on a
small tree, with and without the stage-2 freeze mask, and TSEnsemble.

Tolerances: schedules rtol = 1e-5, atol = 1e-7 * base_lr = 2e-9
(float32 arithmetic and cosine on the JAX side, float64 here); parameters
after three updates rtol = 1e-6, atol = 1e-7 (float32).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from streammos_tpu.config import OptimizeConfig as JaxOptimizeConfig
from streammos_tpu.train import optim as j_optim

from streammos_tpu_torch.config import OptimizeConfig
from streammos_tpu_torch.train import optim as t_optim

COUNTS = [0, 1, 5, 23, 24, 47, 48, 100, 499, 500, 999, 1000, 1999, 2000,
          2399, 2400, 4799, 4800, 6000]


@pytest.mark.parametrize("schedule,pct_start", [
    ("step", 0.01), ("step", 0.0), ("step", 0.2), ("OneCycle", 0.01),
    ("OneCycle", 0.3)])
def test_schedule_matches_jax(schedule, pct_start):
    kw = dict(schedule=schedule, pct_start=pct_start)
    want = j_optim.build_schedule(JaxOptimizeConfig(**kw), 50)
    got = t_optim.build_schedule(OptimizeConfig(**kw), 50)
    for k in COUNTS:
        np.testing.assert_allclose(got(k), float(want(jnp.asarray(k))),
                                   rtol=1e-5, atol=2e-9, err_msg=str(k))


def _tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"trunk.weight": rng.normal(size=(4, 3)).astype(np.float32),
            "trunk.bias": rng.normal(size=(3,)).astype(np.float32),
            "refine.bf_pred_layer.weight": rng.normal(size=(2, 5)).astype(
                np.float32)}


def _nested(flat):
    """flat names -> one level of nesting per dot, as a flax tree."""
    out = {}
    for name, v in flat.items():
        node = out
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


@pytest.mark.parametrize("freeze", [None, "refine"])
@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_three_updates_match_optax(optimizer, freeze):
    kw = dict(optimizer=optimizer, pct_start=0.1, weight_decay=1e-2)
    params = _tree()
    grads = [_tree(seed) for seed in (1, 2, 3)]

    jparams = jax.tree_util.tree_map(jnp.asarray, _nested(params))
    tx, _ = j_optim.build_optimizer(JaxOptimizeConfig(**kw), 10,
                                    params=jparams, freeze_except=freeze)
    state = tx.init(jparams)
    for g in grads:
        updates, state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, _nested(g)), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    want = _flat(jparams)

    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ttx, _ = t_optim.build_optimizer(OptimizeConfig(**kw), 10,
                                     params=tparams, freeze_except=freeze)
    tstate = ttx.init(tparams)
    for g in grads:
        updates, tstate = ttx.update(
            {k: torch.from_numpy(v) for k, v in g.items()}, tstate, tparams)
        t_optim.apply_updates(tparams, updates)
    assert tstate["count"] == 3
    for k, v in tparams.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
        if freeze and not k.startswith("refine"):
            np.testing.assert_array_equal(v.numpy(), params[k])
        else:
            assert not np.array_equal(v.numpy(), params[k])


def test_freeze_needs_the_parameter_names():
    with pytest.raises(ValueError):
        t_optim.build_optimizer(OptimizeConfig(), 10, freeze_except="refine")
    assert t_optim.freeze_mask(["a.refine.w", "trunk.w"], "refine") == {
        "a.refine.w": True, "trunk.w": False}


def test_global_norm_matches_optax():
    g = _tree(4)
    want = optax.global_norm(jax.tree_util.tree_map(jnp.asarray, g))
    got = t_optim.global_norm({k: torch.from_numpy(v) for k, v in g.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_ts_ensemble_matches_jax():
    a, b, c = _tree(5), _tree(6), _tree(7)
    jens = j_optim.TSEnsemble(a, alpha=0.9)
    tens = t_optim.TSEnsemble({k: torch.from_numpy(v) for k, v in a.items()},
                              alpha=0.9)
    for new in (b, c):
        want = jens.update(new)
        got = tens.update({k: torch.from_numpy(v) for k, v in new.items()})
    for k in a:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6)
    with pytest.raises(ValueError):
        t_optim.TSEnsemble({}, alpha=1.5)
    steps = {"n": torch.tensor(3)}
    assert t_optim.TSEnsemble(steps).update({"n": torch.tensor(4)})["n"] == 4


def test_onecycle_is_optax_s_formula():
    """Peak at pct_start, init peak/25, final peak/(25*final_div)."""
    cfg = dataclasses.replace(OptimizeConfig(), schedule="OneCycle",
                              pct_start=0.25, end_epoch=4)
    s = t_optim.build_schedule(cfg, 10)
    assert s(0) == pytest.approx(cfg.base_lr / 25.0)
    assert s(10) == pytest.approx(cfg.base_lr)
    assert s(40) == pytest.approx(cfg.final_lr / 25.0)
    want = optax.cosine_onecycle_schedule(40, cfg.base_lr, 0.25, 25.0,
                                          cfg.base_lr / cfg.final_lr)
    for k in range(0, 45, 3):
        np.testing.assert_allclose(s(k), float(want(k)), rtol=1e-5,
                                   atol=1e-7 * cfg.base_lr)
