"""The port's folded, fused eval forward of StreamMOS_tiny (refine head on)
against JAX `StreamMOSNet(tta_fold=True)` with the same weights, and the
port's eval step and streaming loop against JAX's `make_eval_step`.

Tolerance rtol = atol = 2e-3, as `tests/test_fused_header.py`: XLA and
torch convolutions and matmuls reassociate their float32 sums.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streammos_tpu.config import get_config as jax_get_config
from streammos_tpu.models import stream_mos as j_sm
from streammos_tpu.train.trainer import make_eval_step

from streammos_tpu_torch import serve
from streammos_tpu_torch.models import stream_mos as t_sm
from tests.test_torch_common import (jax_tiny_model, jnp_tree, lidar_points,
                                     port_model, tiny_cfgs, use_few_threads)

use_few_threads()

TOL = dict(rtol=2e-3, atol=2e-3)
N = 768
KEYS = ("pred_folded", "bf_pred_folded", "aux0", "aux1", "aux2", "memory")


@pytest.fixture(scope="module")
def models():
    jmodel, variables = jax_tiny_model(N)
    return jmodel, jnp_tree(variables), port_model(variables)


@pytest.fixture(scope="module")
def frames():
    return lidar_points(np.random.RandomState(11), (3, 1, 3, N))


@pytest.fixture(scope="module")
def forward_pair(models, frames):
    """Both models over two frames: fresh, then the carried memory."""
    jmodel, jvars, tmodel = models
    jcfg, tcfg = tiny_cfgs()

    @jax.jit
    def jfwd(x, mem, use_memory):
        b = j_sm.featurize(j_sm.tta_expand_folded(x), jcfg)
        return jmodel.apply(jvars, b["points"], b["bev_coord"], b["rv_coord"],
                            mem, use_memory, train=False)

    jmem = jnp.zeros(j_sm.memory_shape(jcfg, 4), jnp.float32)
    tmem = torch.zeros(t_sm.memory_shape(tcfg, 4))
    outs = []
    for i in range(2):
        jo = jfwd(jnp.asarray(frames[i]), jmem, jnp.asarray(i > 0))
        with torch.inference_mode():
            b = t_sm.featurize(t_sm.tta_expand_folded(torch.from_numpy(frames[i])),
                               tcfg)
            to = tmodel(b["points"], b["bev_coord"], b["rv_coord"], tmem, i > 0)
        jmem, tmem = jo["memory"], to["memory"]
        outs.append(({k: np.asarray(jo[k]) for k in KEYS},
                     {k: to[k].numpy() for k in KEYS}))
    return outs


@pytest.mark.parametrize("frame", [0, 1], ids=["fresh", "carried"])
@pytest.mark.parametrize("key", KEYS)
def test_forward_matches_jax(forward_pair, frame, key):
    want, got = forward_pair[frame]
    assert got[key].shape == want[key].shape
    assert np.isfinite(got[key]).all()
    np.testing.assert_allclose(got[key], want[key], **TOL)


@pytest.mark.parametrize("carry", [False, True], ids=["reset", "carry"])
def test_streaming_eval_matches_jax(models, frames, carry):
    """Three frames, the third from another sequence: the memory resets
    there unless it carries across sequences."""
    jmodel, jvars, tmodel = models
    jcfg, _ = tiny_cfgs()
    cfg = jax_get_config("StreamMOS_tiny")
    jstep = make_eval_step(jmodel, cfg, with_refine=True)
    seq_ids = ["00", "00", "01"]
    fresh = [True, False, not carry]
    jmem = jnp.zeros(j_sm.memory_shape(jcfg, 4), jnp.float32)
    want = []
    for i in range(3):
        batch = j_sm.featurize(j_sm.tta_expand_folded(jnp.asarray(frames[i])),
                               jcfg)
        s, bf, jmem = jstep(jvars, batch, jmem, jnp.asarray(not fresh[i]))
        want.append((np.asarray(s[0]), np.asarray(bf[0])))

    got = list(serve.stream_eval(
        tmodel, [{"xyzi": frames[i][0], "seq_id": seq_ids[i]} for i in range(3)],
        carry_across_sequences=carry))
    for (ws, wbf), (gs, gbf) in zip(want, got):
        np.testing.assert_allclose(gs.numpy(), ws, **TOL)
        np.testing.assert_allclose(gbf.numpy(), wbf, **TOL)


def test_eval_step_direct(models, frames):
    """`eval_step` on one frame equals the first frame of the stream, and
    its scores are per-point distributions."""
    _, _, tmodel = models
    mem = serve.initial_memory(tmodel)
    s, bf, new_mem = serve.eval_step(tmodel, torch.from_numpy(frames[0]), mem,
                                     use_memory=False)
    first = next(serve.stream_eval(tmodel, [{"xyzi": frames[0][0],
                                              "seq_id": "00"}]))
    assert s.shape == (1, N, 3) and new_mem.shape == mem.shape
    torch.testing.assert_close(s[0], first[0], rtol=0, atol=0)
    torch.testing.assert_close(s.sum(-1), torch.ones(1, N))


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        serve.build_model(jax_get_config("StreamMOS_tiny"), device="cuda")
