"""The blocks and fusions no shipped config builds, against JAX's with the
weights carried across (`weights._Mapping`, `apply_mapping`):
`SpatialAtt`, `CSAtt` and `BasicBlockV2` in train and eval mode, the
attention fusions (`fusion_mode` "branch_att" and "point_att") alone, and
`StreamMOSNet(tta_fold=False)` with each of them, stage 1 and stage 2:
the weight mapping and the unfolded `make_eval_step` over a fresh and a
carried frame (one train step of each: `test_torch_fusion_train.py`). A
folded model with those fusions raises, as JAX's does.

Tolerances: rtol = atol = 2e-3 (the model-parity tolerance), BN running
statistics rtol = atol = 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from streammos_tpu.config import get_config as jax_get_config
from streammos_tpu.models import stream_mos as j_sm
from streammos_tpu.nn import blocks as jb
from streammos_tpu.train.trainer import make_eval_step as jax_make_eval_step

from streammos_tpu_torch import train as t_train
from streammos_tpu_torch.config import get_config
from streammos_tpu_torch.models import stream_mos as t_sm
from streammos_tpu_torch.nn import blocks as tb
from streammos_tpu_torch.weights import (_Mapping, apply_mapping,
                                         from_flax_variables,
                                         load_state_dict_checked)
from tests.test_torch_common import (_perturb, jnp_tree, lidar_points,
                                     use_few_threads)

use_few_threads()

TOL = dict(rtol=2e-3, atol=2e-3)
STAT_TOL = dict(rtol=1e-4, atol=1e-4)
C = 8
N = 256
MODES = ("branch_att", "point_att")


def perturbed(variables, seed: int):
    """A flax variables tree as numpy, every quantity off its init."""
    rng = np.random.RandomState(seed)
    return {k: jax.tree_util.tree_map_with_path(
        lambda p, x: _perturb(p, np.asarray(x), rng), dict(variables[k]))
        for k in ("params", "batch_stats")}


def carried(mapping_rule, variables):
    """The port block's state dict, under the key prefix "m"."""
    m = _Mapping()
    mapping_rule(m)
    return apply_mapping(m, variables)


def run_block(jmod, tmod, rule, xs_np, train: bool, channels_last: bool):
    """(JAX output, port output, JAX batch_stats after, port state after)
    for one call; `xs_np` one array (NHWC) or a list (points)."""
    jx = ([jnp.asarray(x) for x in xs_np] if isinstance(xs_np, list)
          else jnp.asarray(xs_np))
    init = jmod.init(jax.random.key(0), jx, train=False)
    variables = perturbed({"batch_stats": {}, **init}, 3)
    jout, new = jmod.apply(jnp_tree(variables), jx, train=train,
                           mutable=["batch_stats"])
    holder = nn.ModuleDict({"m": tmod})
    load_state_dict_checked(holder, carried(rule, variables))
    holder.train(train)
    if isinstance(xs_np, list):
        tx = [torch.from_numpy(x) for x in xs_np]
    else:
        tx = torch.from_numpy(xs_np).permute(0, 3, 1, 2)
    tout = tmod(tx)
    if not channels_last:
        tout = tout.permute(0, 2, 3, 1)
    want_state = carried(rule, {"params": variables["params"],
                                "batch_stats": jax.device_get(
                                    new.get("batch_stats", {}))})
    return (np.asarray(jout), tout.detach().numpy(), want_state,
            holder.state_dict())


GRID_BLOCKS = {
    "spatial_att": (lambda: jb.SpatialAtt(), lambda: tb.SpatialAtt(C),
                    lambda m: m.spatial_att((), "m")),
    "cs_att": (lambda: jb.CSAtt(C), lambda: tb.CSAtt(C),
               lambda m: m.cs_att((), "m")),
    "basic_block_v2": (lambda: jb.BasicBlockV2(C), lambda: tb.BasicBlockV2(C),
                       lambda m: m.basic_block_v2((), "m", att=True)),
    "basic_block_v2_dilated": (
        lambda: jb.BasicBlockV2(C, dilation=2),
        lambda: tb.BasicBlockV2(C, dilation=2),
        lambda m: m.basic_block_v2((), "m", att=True)),
    "basic_block_v2_no_att": (
        lambda: jb.BasicBlockV2(C, use_att=False),
        lambda: tb.BasicBlockV2(C, use_att=False),
        lambda m: m.basic_block_v2((), "m", att=False)),
}


def _check_stats(want_state, got_state):
    stats = [k for k in want_state if k.endswith(("running_mean",
                                                  "running_var"))]
    assert stats
    for k in stats:
        torch.testing.assert_close(got_state[k], want_state[k], **STAT_TOL,
                                   msg=k)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(GRID_BLOCKS))
def test_grid_block_matches_jax(name, train):
    jf, tf, rule = GRID_BLOCKS[name]
    x = np.random.RandomState(11).normal(size=(2, 12, 10, C)).astype(
        np.float32)
    jout, tout, want_state, got_state = run_block(jf(), tf(), rule, x, train,
                                                  channels_last=False)
    assert tout.shape == jout.shape
    np.testing.assert_allclose(tout, jout, **TOL)
    _check_stats(want_state, got_state)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("mode", MODES)
def test_fusion_matches_jax(mode, train):
    rng = np.random.RandomState(12)
    xs = [rng.normal(size=(2, 64, c)).astype(np.float32) for c in (4, 6, 5)]
    jmod = jb.make_fusion(mode, C, 0.0, jnp.float32, name=None)
    tmod = tb.make_fusion(mode, (4, 6, 5), C, 0.0)
    jout, tout, want_state, got_state = run_block(
        jmod, tmod, lambda m: m.fusion(mode, (), "m", 3), xs, train,
        channels_last=True)
    assert tout.shape == jout.shape == (2, 64, C)
    np.testing.assert_allclose(tout, jout, **TOL)
    _check_stats(want_state, got_state)


def model_cfgs(mode: str):
    """(JAX Config, port Config) of StreamMOS_tiny with `mode`, dropout
    off, no warmup."""
    out = []
    for get in (jax_get_config, get_config):
        cfg = get("StreamMOS_tiny")
        out.append(dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, fusion_mode=mode,
                                           dropout_rate=0.0),
            optimize=dataclasses.replace(cfg.optimize, pct_start=0.0)))
    return out


_MODELS = {}


def models(mode: str, stage2: bool):
    """(JAX cfg, port cfg, JAX model, perturbed JAX variables) of the
    unfolded network, built once a case."""
    key = (mode, stage2)
    if key not in _MODELS:
        jcfg, tcfg = model_cfgs(mode)
        jmodel = j_sm.StreamMOSNet(jcfg.model, with_refine=stage2,
                                   tta_fold=False)
        variables = jax.jit(lambda k: j_sm.init_model(
            k, jcfg.model, batch=1, num_points=N, with_refine=stage2)[1])(
                jax.random.PRNGKey(1))
        _MODELS[key] = (jcfg, tcfg, jmodel, perturbed(variables, 5))
    return _MODELS[key]


def port_net(tcfg, variables, stage2: bool) -> t_sm.StreamMOSNet:
    model = t_sm.StreamMOSNet(tcfg.model, with_refine=stage2, tta_fold=False)
    load_state_dict_checked(model, from_flax_variables(variables, tcfg.model,
                                                       stage2))
    return model


@pytest.mark.parametrize("stage2", [False, True], ids=["stage1", "stage2"])
@pytest.mark.parametrize("mode", MODES)
def test_weight_mapping_covers_the_fusion(mode, stage2):
    _, tcfg, _, variables = models(mode, stage2)
    sd = from_flax_variables(variables, tcfg.model, stage2)
    heads = ["point_post"] + (["refine.bf_point_post"] if stage2 else [])
    for h in heads:
        for i in range(3):
            assert f"{h}.feat_model{i}.layer.0.weight" in sd
        if mode == "branch_att":
            assert sd[f"{h}.weights"].shape == (3,)
        else:
            assert f"{h}.att_layer.3.bias" in sd
    model = port_net(tcfg, variables, stage2)
    assert set(model.state_dict()) - set(sd) == {
        k for k in model.state_dict() if k.endswith("num_batches_tracked")}


@pytest.mark.parametrize("stage2", [False, True], ids=["stage1", "stage2"])
@pytest.mark.parametrize("mode", MODES)
def test_unfolded_eval_step_matches_jax(mode, stage2):
    """`make_eval_step` on one stream's TTA fan stacked on the batch, a
    fresh and a carried frame."""
    jcfg, tcfg, jmodel, variables = models(mode, stage2)
    jstep = jax_make_eval_step(jmodel, jcfg, with_refine=stage2)
    tstep = t_train.make_eval_step(port_net(tcfg, variables, stage2), tcfg,
                                   with_refine=stage2)
    jvars = jnp_tree(variables)
    jmem = jnp.zeros(j_sm.memory_shape(jcfg.model, 4))
    tmem = torch.zeros(t_sm.memory_shape(tcfg.model, 4))
    for i, f in enumerate(lidar_points(np.random.RandomState(21),
                                       (2, 1, 3, N))):
        jbatch = j_sm.featurize(j_sm.tta_expand(jnp.asarray(f)), jcfg.model)
        tbatch = t_sm.featurize(t_sm.tta_expand(torch.from_numpy(f)),
                                tcfg.model)
        js, jbf, jmem = jstep(jvars, jbatch, jmem, jnp.asarray(i > 0))
        ts, tbf, tmem = tstep(tbatch, tmem, i > 0)
        assert ts.shape == (1, N, 3)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
        if stage2:
            np.testing.assert_allclose(tbf.numpy(), np.asarray(jbf), **TOL)
        np.testing.assert_allclose(tmem.numpy(), np.asarray(jmem), **TOL)


@pytest.mark.parametrize("mode", MODES)
def test_folded_model_raises(mode):
    jcfg, tcfg = model_cfgs(mode)
    with pytest.raises(NotImplementedError):
        t_sm.StreamMOSNet(tcfg.model, with_refine=True, tta_fold=True)
    with pytest.raises(NotImplementedError):  # traced, not run
        jax.eval_shape(lambda k: j_sm.init_model(
            k, jcfg.model, batch=4, num_points=16, with_refine=True,
            tta_fold=True)[1], jax.random.PRNGKey(0))
