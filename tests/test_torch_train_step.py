"""One stage-1 train step of the port (StreamMOS_tiny, float32, 3 windows
of 512 points, SGD-Nesterov) against JAX's `make_train_step` from the same
weights and windows; the port's `remat=True` against `remat=False`; a
checkpoint round trip and stage-1 -> stage-2 grafting.

Dropout is off on both sides (the port's masks come from torch generators,
JAX's from its own keys). JAX's step is compiled with XLA's fusion pass off
(`compile_unfused`: fused, XLA:CPU drops part of the gradient at the
scatters' tie test).

Tolerances: loss rtol 1e-5 and BN running statistics rtol = atol = 1e-4
(forward only, float32 sums in another order); gradient norm rtol 2e-4 and
each parameter's update within 2e-3 of the largest update of the step plus
2e-3 of its own size. A ReLU input or a scatter's runner-up within about
1e-6 of its switch routes the gradient differently on the two sides, which
moves single entries by a few percent of their tensor's largest update;
JAX against itself moves as much under a 1e-6 relative change of its
input.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streammos_tpu.config import get_config as jax_get_config
from streammos_tpu.models.stream_mos import StreamMOSNet as JaxStreamMOSNet
from streammos_tpu.train import build_optimizer as jax_build_optimizer
from streammos_tpu.train import create_train_state as jax_create_train_state
from streammos_tpu.train import make_train_step as jax_make_train_step

from streammos_tpu_torch import train as t_train
from streammos_tpu_torch.config import get_config
from streammos_tpu_torch.weights import from_flax_variables
from tests.test_torch_common import (compile_unfused, jax_tiny_model,
                                     jnp_tree, lidar_points, port_model,
                                     use_few_threads, without_refine)

use_few_threads()

N = 512
S = 3
SEED = 7
UPDATE_TOL = 2e-3


def train_cfgs(get, dropout_rate=0.0):
    """StreamMOS_tiny with the given dropout and no warmup (the first
    update runs at the base rate)."""
    cfg = get("StreamMOS_tiny")
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dropout_rate=dropout_rate),
        optimize=dataclasses.replace(cfg.optimize, pct_start=0.0))


def make_windows(seed: int, stage2: bool):
    rng = np.random.RandomState(seed)
    w = {"xyzi": lidar_points(rng, (S, 1, 3, N)),
         "targets": rng.randint(0, 3, (S, 1, N)).astype(np.int32)}
    if stage2:
        w["bf_targets"] = rng.randint(0, 3, (S, 1, N)).astype(np.int32)
    return w


def jax_step(variables, windows, stage2: bool):
    """JAX's `make_train_step` once: (loss, grad_norm, new variables)."""
    cfg = train_cfgs(jax_get_config)
    model = JaxStreamMOSNet(cfg.model, with_refine=stage2, tta_fold=False)
    jvars = jnp_tree(variables)
    tx, _ = jax_build_optimizer(cfg.optimize, 100, params=jvars["params"],
                                freeze_except="refine" if stage2 else None)
    state = jax_create_train_state(jvars, tx)
    step = jax_make_train_step(model, cfg, tx, stage2=stage2, donate=False)
    args = (state, {k: jnp.asarray(v) for k, v in windows.items()},
            jax.random.key(0))
    new, metrics = compile_unfused(step, *args)(*args)
    new_vars = {"params": jax.device_get(new.params),
                "batch_stats": jax.device_get(new.batch_stats)}
    return (float(metrics["loss"]), float(metrics["grad_norm"]), new_vars)


def port_step(model, windows, stage2: bool, remat: bool = False,
              dropout_rate: float = 0.0, seed: int = 0):
    """The port's `make_train_step` once on `model` (updated in place)."""
    cfg = train_cfgs(get_config, dropout_rate)
    params = dict(model.named_parameters())
    tx, _ = t_train.build_optimizer(cfg.optimize, 100, params=params,
                                    freeze_except="refine" if stage2 else None)
    state = t_train.create_train_state(model, tx)
    step = t_train.make_train_step(model, cfg, tx, stage2=stage2, remat=remat)
    state, metrics = step(state, {k: torch.from_numpy(v)
                                  for k, v in windows.items()},
                          torch.Generator().manual_seed(seed))
    return state, metrics


def compare_with_jax(variables, windows, stage2: bool):
    """Run both steps; returns (port metrics, JAX metrics, state dict before,
    port state dict after, JAX state dict after)."""
    cfg = train_cfgs(get_config).model
    model = port_model(variables, with_refine=stage2, tta_fold=False, cfg=cfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _, metrics = port_step(model, windows, stage2)
    loss, grad_norm, new_vars = jax_step(variables, windows, stage2)
    want = from_flax_variables(new_vars, cfg, stage2)
    return (metrics, (loss, grad_norm), before, model.state_dict(), want)


def assert_updates_match(before, got, want, names):
    """Each tensor's update within UPDATE_TOL of the step's largest update
    plus UPDATE_TOL of its own size."""
    scale = max(float((want[k] - before[k]).abs().max()) for k in names)
    assert scale > 0
    for k in names:
        d_got, d_want = got[k] - before[k], want[k] - before[k]
        excess = (d_got - d_want).abs() - UPDATE_TOL * (scale + d_want.abs())
        assert float(excess.max()) <= 0, (
            k, float((d_got - d_want).abs().max()), scale)


@pytest.fixture(scope="module")
def stage1():
    _, variables = jax_tiny_model(N)
    return compare_with_jax(without_refine(variables),
                            make_windows(SEED, False), stage2=False)


def test_stage1_loss_and_grad_norm_match_jax(stage1):
    metrics, (loss, grad_norm), *_ = stage1
    assert np.isfinite(float(metrics["loss"]))
    np.testing.assert_allclose(float(metrics["loss"]), loss, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), grad_norm,
                               rtol=2e-4)


def test_stage1_updated_params_match_jax(stage1):
    _, _, before, got, want = stage1
    names = [k for k in want if not k.endswith(("running_mean",
                                                "running_var"))]
    assert all(not torch.equal(got[k], before[k]) for k in names)
    assert_updates_match(before, got, want, names)


def test_stage1_bn_statistics_match_jax(stage1):
    _, _, before, got, want = stage1
    names = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(names) > 100
    for k in names:
        assert not torch.equal(got[k], before[k]), k
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-4,
                                   msg=k)


@pytest.mark.parametrize("stage2", [False, True], ids=["stage1", "stage2"])
def test_remat_equals_plain(stage2):
    """`remat=True` re-runs each window's forward in the backward: with
    dropout on, the masks are drawn again from the same per-window seeds,
    and the BN running statistics move once; loss, gradients, updated
    parameters and statistics equal the plain run's."""
    _, variables = jax_tiny_model(N)
    variables = variables if stage2 else without_refine(variables)
    cfg = train_cfgs(get_config, dropout_rate=0.2).model
    base = port_model(variables, with_refine=stage2, tta_fold=False, cfg=cfg)
    windows = make_windows(SEED + 1, stage2)
    runs = []
    for remat in (False, True):
        model = copy.deepcopy(base)
        _, metrics = port_step(model, windows, stage2, remat=remat,
                               dropout_rate=0.2, seed=5)
        grads = {n: p.grad for n, p in model.named_parameters()}
        runs.append((metrics, grads, model.state_dict()))
    (m0, g0, s0), (m1, g1, s1) = runs
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    for n in g0:
        assert (g0[n] is None) == (g1[n] is None), n
        if g0[n] is not None:
            assert torch.equal(g0[n], g1[n]), n
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    # dropout was on: another seed gives another loss
    model = copy.deepcopy(base)
    _, m2 = port_step(model, windows, stage2, dropout_rate=0.2, seed=6)
    assert not torch.equal(m0["loss"], m2["loss"])


def test_checkpoint_round_trip(tmp_path):
    """save, then restore into a fresh state: model, optimizer state and
    step come back; `latest_epoch` finds the newest epoch."""
    _, variables = jax_tiny_model(N)
    cfg = train_cfgs(get_config).model
    model = port_model(without_refine(variables), with_refine=False,
                       tta_fold=False, cfg=cfg)
    state, _ = port_step(model, make_windows(SEED, False), stage2=False)
    assert t_train.latest_epoch(str(tmp_path)) is None
    t_train.save(str(tmp_path), 3, state)
    t_train.save(str(tmp_path), 12, state)
    assert t_train.latest_epoch(str(tmp_path)) == 12

    fresh = port_model(without_refine(variables), with_refine=False,
                       tta_fold=False, cfg=cfg)
    tx, _ = t_train.build_optimizer(train_cfgs(get_config).optimize, 100)
    restored = t_train.restore(str(tmp_path), 12,
                               t_train.create_train_state(fresh, tx))
    assert restored.step == state.step == 1
    assert restored.opt_state["count"] == 1
    for k, v in state.model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[k], v), k
    for n, t in state.opt_state["trace"].items():
        assert torch.equal(restored.opt_state["trace"][n], t), n


def test_graft_stage1_into_stage2():
    """A stage-1 state dict grafted into the stage-2 model: every shared
    entry is stage 1's, the refine head keeps its drawn weights; entries
    of another shape are left alone."""
    _, variables = jax_tiny_model(N)
    cfg = get_config("StreamMOS_tiny")
    stage1_sd = from_flax_variables(without_refine(variables), cfg.model)
    fresh = t_train.build_train_model(cfg, stage2=True, device="cpu", seed=1)
    grafted = t_train.build_train_model(cfg, stage2=True, device="cpu",
                                        seed=1, state_dict=stage1_sd)
    assert grafted.training and grafted.with_refine and not grafted.tta_fold
    got, drawn = grafted.state_dict(), fresh.state_dict()
    refine = [k for k in got if k.startswith("refine.")]
    assert refine
    for k in refine:
        assert torch.equal(got[k], drawn[k]), k
    for k, v in stage1_sd.items():
        assert torch.equal(got[k], v), k
    assert set(got) == set(stage1_sd) | set(refine) | {
        k for k in got if k.endswith("num_batches_tracked")}

    wrong = {"pred_layer.pred_layer.0.weight": torch.zeros(5, 5, 1, 1)}
    merged = t_train.graft_params(drawn, wrong)
    assert torch.equal(merged["pred_layer.pred_layer.0.weight"],
                       drawn["pred_layer.pred_layer.0.weight"])


def test_graft_carries_bn_running_statistics():
    """Stage 2 built from a stage-1 model's dict starts from stage 1's BN
    running statistics (the original trainer's `load_state_dict(strict=
    False)`; the JAX CLI grafts `params` only and starts from mean 0,
    variance 1)."""
    cfg = get_config("StreamMOS_tiny")
    stage1 = t_train.build_train_model(cfg, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for k, v in stage1.state_dict().items():
            if k.endswith("running_mean"):
                v.copy_(torch.randn(v.shape, generator=gen))
            elif k.endswith("running_var"):
                v.copy_(torch.rand(v.shape, generator=gen) + 0.5)
    stats1 = {k: v for k, v in stage1.state_dict().items()
              if k.endswith(("running_mean", "running_var"))}
    grafted = t_train.build_train_model(cfg, stage2=True, device="cpu",
                                        seed=1,
                                        state_dict=stage1.state_dict())
    got = grafted.state_dict()
    backbone = {k for k in got if k.endswith(("running_mean", "running_var"))
                and not k.startswith("refine.")}
    assert backbone and backbone == set(stats1)
    for k in backbone:
        assert torch.equal(got[k], stats1[k]), k
        assert not torch.equal(got[k], torch.zeros_like(got[k])) and \
            not torch.equal(got[k], torch.ones_like(got[k])), k


def test_build_train_model_needs_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        t_train.build_train_model(get_config("StreamMOS_tiny"))
