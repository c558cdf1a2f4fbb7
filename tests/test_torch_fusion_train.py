"""One train step of `StreamMOSNet(tta_fold=False)` with each attention
fusion (`fusion_mode` "branch_att" and "point_att"), stage 1 and stage 2,
against JAX's `make_train_step` from the same weights and window (JAX's
compiled with fusion off, `compile_unfused`; dropout off on both sides;
one window of 256 points, which keeps JAX's compile short).

Tolerances as `tests/test_torch_train_step.py`: loss rtol 1e-5, gradient
norm rtol 2e-4, each update within 2e-3 of the step's largest update, BN
running statistics rtol = atol = 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streammos_tpu.train import build_optimizer as jax_build_optimizer
from streammos_tpu.train import create_train_state as jax_create_train_state
from streammos_tpu.train import make_train_step as jax_make_train_step

from streammos_tpu_torch import train as t_train
from streammos_tpu_torch.weights import from_flax_variables
from tests.test_torch_aux_blocks import (MODES, N, _check_stats, models,
                                         port_net)
from tests.test_torch_common import (compile_unfused, jnp_tree, lidar_points,
                                     use_few_threads)
from tests.test_torch_train_step import assert_updates_match

use_few_threads()

S = 1


def train_windows(stage2: bool):
    rng = np.random.RandomState(9)
    w = {"xyzi": lidar_points(rng, (S, 1, 3, N)),
         "targets": rng.randint(0, 3, (S, 1, N)).astype(np.int32)}
    if stage2:
        w["bf_targets"] = rng.randint(0, 3, (S, 1, N)).astype(np.int32)
    return w


@pytest.mark.parametrize("stage2", [False, True], ids=["stage1", "stage2"])
@pytest.mark.parametrize("mode", MODES)
def test_train_step_matches_jax(mode, stage2):
    jcfg, tcfg, jmodel, variables = models(mode, stage2)
    windows = train_windows(stage2)
    freeze = "refine" if stage2 else None

    jvars = jnp_tree(variables)
    jtx, _ = jax_build_optimizer(jcfg.optimize, 100, params=jvars["params"],
                                 freeze_except=freeze)
    jstep = jax_make_train_step(jmodel, jcfg, jtx, stage2=stage2,
                                donate=False)
    args = (jax_create_train_state(jvars, jtx),
            {k: jnp.asarray(v) for k, v in windows.items()},
            jax.random.key(0))
    new, jmetrics = compile_unfused(jstep, *args)(*args)
    want = from_flax_variables(
        {"params": jax.device_get(new.params),
         "batch_stats": jax.device_get(new.batch_stats)}, tcfg.model, stage2)

    model = port_net(tcfg, variables, stage2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    params = dict(model.named_parameters())
    tx, _ = t_train.build_optimizer(tcfg.optimize, 100, params=params,
                                    freeze_except=freeze)
    step = t_train.make_train_step(model, tcfg, tx, stage2=stage2)
    _, metrics = step(t_train.create_train_state(model, tx),
                      {k: torch.from_numpy(v) for k, v in windows.items()},
                      torch.Generator().manual_seed(0))
    got = model.state_dict()

    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(jmetrics["grad_norm"]), rtol=2e-4)
    names = [k for k in want if not k.endswith(("running_mean",
                                                "running_var"))]
    moved = [k for k in names if not torch.equal(want[k], before[k])]
    assert any(".feat_model" in k for k in moved)
    assert_updates_match(before, got, want, names)
    _check_stats(want, got)


