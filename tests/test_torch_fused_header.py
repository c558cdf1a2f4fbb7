"""The fused TTA header: the port's plain version against the JAX plain
version and the JAX Pallas kernel in interpret mode, the wrapper's
dispatch and shape checks. The CUDA kernel's own test, which needs a card,
is in `test_torch_cuda.py`.

Tolerance rtol = atol = 1e-4, as `tests/test_fused_header.py`: float32
convolutions summed in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streammos_tpu.ops import fused_header as j_fh

from streammos_tpu_torch.ops import fused_header as t_fh
from tests.test_torch_common import use_few_threads

use_few_threads()

TOL = dict(rtol=1e-4, atol=1e-4)


def _rand_inputs(rng, T=3, C=8, Cout=16, Bt=1, Hh=16, Wh=128):
    """The shapes of tests/test_fused_header.py; the padding rows are
    zero, as the scatter leaves them."""
    g = rng.randn(Bt * T, 4, Hh + 2, Wh, 4 * C).astype(np.float32)
    g[:, :, 0] = 0.0
    g[:, :, -1] = 0.0
    k3 = rng.randn(3, 3, T * C, Cout).astype(np.float32) * 0.1
    k1 = rng.randn(1, 1, T * C, Cout).astype(np.float32) * 0.1
    ca = (rng.uniform(0.5, 1.5, Cout).astype(np.float32),
          rng.randn(Cout).astype(np.float32) * 0.1)
    pa = (rng.uniform(-1.5, 1.5, Cout).astype(np.float32),
          rng.randn(Cout).astype(np.float32) * 0.1)
    return g, k3, k1, ca, pa


def _torch(args):
    g, k3, k1, ca, pa = args
    t = torch.from_numpy
    return t(g), t(k3), t(k1), tuple(map(t, ca)), tuple(map(t, pa))


def _jax(args):
    g, k3, k1, ca, pa = args
    j = jnp.asarray
    return j(g), j(k3), j(k1), tuple(map(j, ca)), tuple(map(j, pa))


@pytest.mark.parametrize("Bt,seed", [(1, 0), (2, 1)])
def test_reference_matches_jax(Bt, seed):
    args = _rand_inputs(np.random.RandomState(seed), Bt=Bt)
    got = t_fh.fused_header_reference(*_torch(args), 3).numpy()
    want_ref = np.asarray(j_fh.fused_header_reference(*_jax(args), 3))
    want_kernel = np.asarray(j_fh.fused_header_tta(*_jax(args), 3,
                                                   interpret=True))
    assert got.shape == (4, Bt, 16, 128, 16)
    np.testing.assert_allclose(got, want_ref, **TOL)
    np.testing.assert_allclose(got, want_kernel, **TOL)


def test_cpu_dispatch_is_the_plain_version():
    args = _torch(_rand_inputs(np.random.RandomState(2), Hh=6, Wh=10))
    before = t_fh.fused_header_tta.launches
    got = t_fh.fused_header_tta(*args, 3)
    assert t_fh.fused_header_tta.launches == before  # no kernel on the CPU
    torch.testing.assert_close(got, t_fh.fused_header_reference(*args, 3),
                               rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["width", "kernel", "frames", "phases"])
def test_wrapper_rejects_bad_shapes(bad):
    g, k3, k1, ca, pa = _torch(_rand_inputs(np.random.RandomState(3), Hh=4,
                                            Wh=8))
    T = 3
    if bad == "width":
        g = g[..., :-1]
    elif bad == "kernel":
        k3 = k3[:, :, :-1]
    elif bad == "frames":
        T = 2
    else:
        g = g[:, :3]
    with pytest.raises(ValueError):
        t_fh.fused_header_tta(g, k3, k1, ca, pa, T)
