"""The port's eval forwards beside the fused one: the unfolded network
(``tta_fold=False``, the layout training runs) and the folded network with
``fused_header=False`` (the full-grid scatter and the frame-split header),
each against JAX with the same weights over a fresh and a carried-memory
frame; the folded forward against the port's own unfolded TTA-as-batch
path; and `make_eval_step` in both layouts.

Tolerances: rtol = atol = 2e-3 against JAX, as `tests/test_torch_model.py`;
folded against unfolded TTA atol = rtol = 5e-3, as
`tests/test_tta_fold.py` (the folded gather's bilinear fractions differ by
an ulp).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streammos_tpu.config import get_config as jax_get_config
from streammos_tpu.models import stream_mos as j_sm
from streammos_tpu.train.trainer import make_eval_step as jax_make_eval_step

from streammos_tpu_torch import serve
from streammos_tpu_torch.config import get_config
from streammos_tpu_torch.models import stream_mos as t_sm
from streammos_tpu_torch.train import make_eval_step
from tests.test_torch_common import (jax_tiny_model, jnp_tree, lidar_points,
                                     port_model, tiny_cfgs, use_few_threads)

use_few_threads()

TOL = dict(rtol=2e-3, atol=2e-3)
N = 512
UNFOLDED_KEYS = ("pred", "bf_pred", "aux0", "aux1", "aux2", "memory")
FOLDED_KEYS = ("pred_folded", "bf_pred_folded", "aux0", "aux1", "aux2",
               "memory")


@pytest.fixture(scope="module")
def frames():
    return lidar_points(np.random.RandomState(21), (2, 1, 3, N))


def _run_pair(jmodel, jvars, tmodel, jbatches, tbatches, jmem, tmem, keys):
    """Both models over two frames, the memory carried: per frame
    (JAX outputs, port outputs) as numpy."""
    @jax.jit
    def jfwd(batch, mem, use_memory):
        return jmodel.apply(jvars, batch["points"], batch["bev_coord"],
                            batch["rv_coord"], mem, use_memory, train=False)

    outs = []
    for i in range(2):
        jo = jfwd(jbatches[i], jmem, jnp.asarray(i > 0))
        with torch.inference_mode():
            to = tmodel(tbatches[i]["points"], tbatches[i]["bev_coord"],
                        tbatches[i]["rv_coord"], tmem, i > 0)
        jmem, tmem = jo["memory"], to["memory"]
        outs.append(({k: np.asarray(jo[k]) for k in keys},
                     {k: to[k].numpy() for k in keys}))
    return outs


@pytest.fixture(scope="module")
def unfolded_pair(frames):
    jcfg, tcfg = tiny_cfgs()
    _, variables = jax_tiny_model(N)
    jmodel = j_sm.StreamMOSNet(jcfg, with_refine=True, tta_fold=False)
    tmodel = port_model(variables, tta_fold=False)
    jb = [j_sm.featurize(jnp.asarray(f), jcfg) for f in frames]
    tb = [t_sm.featurize(torch.from_numpy(f), tcfg) for f in frames]
    return _run_pair(jmodel, jnp_tree(variables), tmodel, jb, tb,
                     jnp.zeros(j_sm.memory_shape(jcfg, 1)),
                     torch.zeros(t_sm.memory_shape(tcfg, 1)), UNFOLDED_KEYS)


@pytest.fixture(scope="module")
def unfused_pair(frames):
    jcfg, tcfg = (dataclasses.replace(c, fused_header=False)
                  for c in tiny_cfgs())
    _, variables = jax_tiny_model(N)
    jmodel = j_sm.StreamMOSNet(jcfg, with_refine=True, tta_fold=True)
    tmodel = port_model(variables, tta_fold=True, cfg=tcfg)
    jb = [j_sm.featurize(j_sm.tta_expand_folded(jnp.asarray(f)), jcfg)
          for f in frames]
    tb = [t_sm.featurize(t_sm.tta_expand_folded(torch.from_numpy(f)), tcfg)
          for f in frames]
    return _run_pair(jmodel, jnp_tree(variables), tmodel, jb, tb,
                     jnp.zeros(j_sm.memory_shape(jcfg, 4)),
                     torch.zeros(t_sm.memory_shape(tcfg, 4)), FOLDED_KEYS)


@pytest.mark.parametrize("frame", [0, 1], ids=["fresh", "carried"])
@pytest.mark.parametrize("key", UNFOLDED_KEYS)
def test_unfolded_forward_matches_jax(unfolded_pair, frame, key):
    want, got = unfolded_pair[frame]
    assert got[key].shape == want[key].shape
    assert np.isfinite(got[key]).all()
    np.testing.assert_allclose(got[key], want[key], **TOL)


@pytest.mark.parametrize("frame", [0, 1], ids=["fresh", "carried"])
@pytest.mark.parametrize("key", FOLDED_KEYS)
def test_folded_unfused_header_matches_jax(unfused_pair, frame, key):
    want, got = unfused_pair[frame]
    assert got[key].shape == want[key].shape
    np.testing.assert_allclose(got[key], want[key], **TOL)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_folded_matches_unfolded_tta_batch(fused):
    """The folded forward against the same weights run unfolded on the
    TTA fan stacked on the batch axis (`tta_expand`), memory carried. The
    points stay inside the crop, as the eval pipeline keeps them: just
    outside it a flipped variant's bilinear tap reaches the grid's edge
    where the folded gather's does not (JAX's two paths differ there
    alike)."""
    frames = lidar_points(np.random.RandomState(22), (2, 1, 3, N),
                          extent=34.0)
    _, tcfg = tiny_cfgs()
    tcfg = dataclasses.replace(tcfg, fused_header=fused)
    _, variables = jax_tiny_model(N)
    folded = port_model(variables, tta_fold=True, cfg=tcfg)
    unfolded = port_model(variables, tta_fold=False, cfg=tcfg)
    mem_f = mem_u = torch.zeros(t_sm.memory_shape(tcfg, 4))
    with torch.inference_mode():
        for i, f in enumerate(frames):
            x = torch.from_numpy(f)
            bf = t_sm.featurize(t_sm.tta_expand_folded(x), tcfg)
            bu = t_sm.featurize(t_sm.tta_expand(x), tcfg)
            of = folded(bf["points"], bf["bev_coord"], bf["rv_coord"], mem_f,
                        i > 0)
            ou = unfolded(bu["points"], bu["bev_coord"], bu["rv_coord"],
                          mem_u, i > 0)
            mem_f, mem_u = of["memory"], ou["memory"]
            for k in ("pred", "bf_pred"):  # (1, N, V, C) vs (V, N, C)
                torch.testing.assert_close(of[k][0].movedim(1, 0), ou[k],
                                           rtol=5e-3, atol=5e-3)
            for k in ("aux0", "aux1", "aux2", "memory"):
                torch.testing.assert_close(of[k], ou[k], rtol=5e-3, atol=5e-3)


def test_tta_expand_matches_jax(frames):
    want = j_sm.tta_expand(jnp.asarray(frames[0]))
    got = t_sm.tta_expand(torch.from_numpy(frames[0]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unfolded_eval_step_matches_jax(frames):
    """`make_eval_step` on one stream's TTA fan stacked on the batch: the
    TTA mean of the softmax, fresh then carried."""
    jcfg, tcfg = tiny_cfgs()
    _, variables = jax_tiny_model(N)
    jmodel = j_sm.StreamMOSNet(jcfg, with_refine=True, tta_fold=False)
    jstep = jax_make_eval_step(jmodel, jax_get_config("StreamMOS_tiny"),
                               with_refine=True)
    tstep = make_eval_step(port_model(variables, tta_fold=False),
                           get_config("StreamMOS_tiny"), with_refine=True)
    jvars = jnp_tree(variables)
    jmem = jnp.zeros(j_sm.memory_shape(jcfg, 4))
    tmem = torch.zeros(t_sm.memory_shape(tcfg, 4))
    for i, f in enumerate(frames):
        jb = j_sm.featurize(j_sm.tta_expand(jnp.asarray(f)), jcfg)
        tb = t_sm.featurize(t_sm.tta_expand(torch.from_numpy(f)), tcfg)
        js, jbf, jmem = jstep(jvars, jb, jmem, jnp.asarray(i > 0))
        ts, tbf, tmem = tstep(tb, tmem, i > 0)
        assert ts.shape == (1, N, 3)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
        np.testing.assert_allclose(tbf.numpy(), np.asarray(jbf), **TOL)


def test_folded_eval_step_is_serve_s(frames):
    _, variables = jax_tiny_model(N)
    model = port_model(variables, tta_fold=True)
    step = make_eval_step(model, get_config("StreamMOS_tiny"),
                          with_refine=True)
    x = torch.from_numpy(frames[0])
    mem = serve.initial_memory(model)
    s, bf, m = step(t_sm.featurize(t_sm.tta_expand_folded(x), model.cfg),
                    mem, False)
    s2, bf2, m2 = serve.eval_step(model, x, mem, use_memory=False)
    assert torch.equal(s, s2) and torch.equal(bf, bf2) and torch.equal(m, m2)


def test_folded_model_is_eval_only():
    _, variables = jax_tiny_model(N)
    model = port_model(variables, tta_fold=True).train()
    b = t_sm.featurize(t_sm.tta_expand_folded(torch.zeros(1, 3, 8, 4)),
                       model.cfg)
    with pytest.raises(ValueError):
        model(b["points"], b["bev_coord"], b["rv_coord"],
              serve.initial_memory(model), False)
