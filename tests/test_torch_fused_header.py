"""The fused TTA header: the port's plain version against the JAX plain
version and the JAX Pallas kernel in interpret mode, the kernels' weight
packing and window arithmetic (mirrored here in torch) against the JAX
plain version, the float32 kernel's 3xTF32 products (TF32 rounding
emulated) against JAX's plain version and its kernel in interpret mode,
the wrapper's dispatch and shape checks. The CUDA kernels' own tests,
which need a card, are in `test_torch_cuda.py`.

Tolerance rtol = atol = 1e-4, as `tests/test_fused_header.py`: float32
convolutions summed in another order (and, for the 3xTF32 products, about
22 of float32's 24 mantissa bits a product).
"""
import itertools
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streammos_tpu.ops import fused_header as j_fh

from streammos_tpu_torch.ops import fused_header as t_fh
from streammos_tpu_torch.utils import profiling
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


# the bf16 kernel's tile (csrc/fused_header.cu, namespace tc)
TR, TW = 8, 16


def _axis_tap(flip: int, k: int):
    """The kernel's `axis_tap`: half-res offset and phase bit of tap k."""
    if k == 0:
        return (1, 0) if flip else (-1, 1)
    return 0, int((k == 1) == bool(flip))


def _local_tap(flip: int, k: int) -> int:
    """The kernel's `local_tap`: tap k's row in the full-res window, less
    twice the output row."""
    off, ph = _axis_tap(flip, k)
    return 2 * off + ph + 1 - flip


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """`cvt.rna.tf32.f32`: the 13 low mantissa bits rounded to nearest,
    ties away from zero (add half of their range to the magnitude, cut)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w.T as the float32 kernel forms it: each operand split into
    hi = tf32(x) and lo = tf32(x - hi), a_lo b_hi + a_hi b_lo + a_hi b_hi
    (a_lo b_lo dropped)."""
    ah, wh = _tf32(a), _tf32(w)
    al, wl = _tf32(a - ah), _tf32(w - wh)
    return al @ wh.T + ah @ wl.T + ah @ wh.T


def _mm_1xtf32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w.T as one TF32 product a term: hi x hi alone."""
    return _tf32(a) @ _tf32(w).T


def _kernel_mirror(g, k3p, k1p, ca, pa, T, kch=None, product=_mm_3xtf32):
    """The kernels' arithmetic in torch, tile by tile: stage the
    (2TR+1) x (2TW+1) full-res window at canonical origin (2*r0-1+fx,
    2*c0-1+fy), the phase of a position its row's and column's low bits,
    zero outside the grid by index (never reading the padding rows); the
    conv as one shifted window a tap times the packed (t, tap) slice; the
    pool as the 1x1 GEMM over every staged position, affine, -inf outside
    the grid, 3x3 stride-2 max; ragged tiles cut on store. Products are
    plain float32 over all C channels at once (the bf16 kernel's layout);
    with `kch`, the float32 kernel's: K in its order (frame t, then steps of
    kch channels, zero past C, then the 9 taps), each product `product`.
    Sums are float32 in torch's order: the tensor cores' own accumulation is
    held to the tolerance on the card (`test_torch_cuda.py`)."""
    BtT, _, Hp, Wh, VC = g.shape
    Hh, C, Cout = Hp - 2, VC // 4, k3p.shape[2]
    Bt = BtT // T
    gv = g.reshape(Bt, T, 4, Hp, Wh, 4, C)
    (cs, cb), (ps, pb) = ca, pa
    i, jj = torch.arange(TR)[:, None], torch.arange(TW)[None, :]
    steps = ([slice(None)] if kch is None
             else [slice(k, k + kch) for k in range(0, C, kch)])
    mm = (lambda a, w: a @ w.T) if kch is None else product
    out = torch.full((4, Bt, Hh, Wh, Cout), float("nan"))
    for v in range(4):
        fx, fy = v >> 1, v & 1
        for r0 in range(0, Hh, TR):
            for c0 in range(0, Wh, TW):
                r = 2 * r0 - 1 + fx + torch.arange(2 * TR + 1)
                q = 2 * c0 - 1 + fy + torch.arange(2 * TW + 1)
                inside = (((r >= 0) & (r < 2 * Hh))[:, None]
                          & ((q >= 0) & (q < 2 * Wh))[None, :])
                ph = 2 * (r[:, None] & 1) + (q[None, :] & 1)
                h = (r >> 1).clamp(0, Hh - 1)[:, None] + 1
                w = (q >> 1).clamp(0, Wh - 1)[None, :]
                win = torch.where(inside[..., None], gv[:, :, ph, h, w, v], 0.0)
                conv = torch.zeros(Bt, TR, TW, Cout)
                z = torch.zeros(Bt, 2 * TR + 1, 2 * TW + 1, Cout)
                for t, ch in itertools.product(range(T), steps):
                    for kr in range(3):
                        for kc in range(3):
                            a = win[:, t, 2 * i + _local_tap(fx, kr),
                                    2 * jj + _local_tap(fy, kc), ch]
                            conv += mm(a, k3p[t, 3 * kr + kc, :, ch])
                    z += mm(win[:, t, ..., ch], k1p[t, :, ch])
                z = torch.where(inside[..., None], z * ps + pb, -torch.inf)
                pooled = torch.stack([z[:, 2 * i + dr, 2 * jj + dc]
                                      for dr in range(3) for dc in range(3)])
                y = torch.relu(conv * cs + cb + pooled.amax(0))
                nr, nc = min(TR, Hh - r0), min(TW, Wh - c0)
                out[v, :, r0:r0 + nr, c0:c0 + nc] = y[:, :nr, :nc]
    return out


@pytest.mark.parametrize("shape", [dict(Bt=2), dict(Bt=2, Hh=9, Wh=20, C=16)],
                         ids=["unit", "ragged"])
def test_bf16_kernel_window_arithmetic_matches_jax(shape):
    """The packing and the window arithmetic of the bf16 kernel, all four
    variants, against JAX's plain version in float32. The padding rows hold
    NaN: neither side may read them."""
    g, k3, k1, ca, pa = _rand_inputs(np.random.RandomState(6), **shape)
    want = np.asarray(j_fh.fused_header_reference(*_jax((g, k3, k1, ca, pa)), 3))
    g[:, :, 0] = np.nan
    g[:, :, -1] = np.nan
    tg, tk3, tk1, tca, tpa = _torch((g, k3, k1, ca, pa))
    k3p, k1p = t_fh.pack_header_weights(tk3, tk1, 3)
    C, Cout = k3.shape[2] // 3, k3.shape[3]
    assert k3p.shape == (3, 9, Cout, C) and k1p.shape == (3, Cout, C)
    assert k3p.is_contiguous() and k1p.is_contiguous()
    for t, kr, kc in ((0, 0, 2), (2, 1, 0)):
        assert torch.equal(k3p[t, 3 * kr + kc], tk3[kr, kc, t * C:(t + 1) * C].T)
        assert torch.equal(k1p[t], tk1[0, 0, t * C:(t + 1) * C].T)
    got = _kernel_mirror(tg, k3p, k1p, tca, tpa, 3).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


# the float32 kernel's step: 16 float32 channels (csrc/fused_header.cu,
# namespace f32)
F32_KCH = 16


def test_tf32_rounding_is_cvt_rna():
    """Round to nearest on the 13 dropped bits, ties away from zero, carry
    into the exponent; the result has 10 explicit mantissa bits."""
    one = 1.0
    ulp = 2.0 ** -10  # TF32's spacing at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      2.0 - ulp / 2, 3.0, 0.0])
    want = torch.tensor([one + ulp, -(one + ulp), one, 2.0, 3.0, 0.0])
    assert torch.equal(_tf32(x), want)
    r = _tf32(torch.from_numpy(np.random.RandomState(0).randn(1000)
                               .astype(np.float32)))
    assert not (r.view(torch.int32) & 0x1FFF).any()


@pytest.mark.parametrize("shape", [
    dict(Bt=2), dict(Bt=2, Hh=9, Wh=20, C=16), dict(Bt=2, Hh=10, Wh=20, C=3)],
    ids=["unit", "ragged", "C3"])
def test_f32_kernel_split_arithmetic_matches_jax(shape):
    """The float32 kernel's window arithmetic with its 3xTF32 products in
    its K order, all four variants, against JAX's plain version and JAX's
    kernel in interpret mode (which takes the plain version where no row
    tile divides Hh, as at Hh = 9), in float32. The padding rows hold NaN:
    neither side may read them. A single TF32 product a term misses the
    tolerance at the unit shape."""
    g, k3, k1, ca, pa = _rand_inputs(np.random.RandomState(9), **shape)
    jargs = _jax((g, k3, k1, ca, pa))
    want = np.asarray(j_fh.fused_header_reference(*jargs, 3))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # JAX's note when it takes the plain version
        want_kernel = np.asarray(j_fh.fused_header_tta(*jargs, 3,
                                                       interpret=True))
    g[:, :, 0] = np.nan
    g[:, :, -1] = np.nan
    tg, tk3, tk1, tca, tpa = _torch((g, k3, k1, ca, pa))
    k3p, k1p = t_fh.pack_header_weights(tk3, tk1, 3)
    got = _kernel_mirror(tg, k3p, k1p, tca, tpa, 3, kch=F32_KCH).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, want_kernel, **TOL)
    if shape == dict(Bt=2):
        # one TF32 product (hi x hi) does not hold the float32 tolerance
        single = _kernel_mirror(tg, k3p, k1p, tca, tpa, 3, kch=F32_KCH,
                                product=_mm_1xtf32).numpy()
        assert not np.allclose(single, want, **TOL)


def test_cpu_dispatch_is_the_plain_version():
    args = _torch(_rand_inputs(np.random.RandomState(2), Hh=6, Wh=10))
    before = profiling.counters()
    got = t_fh.fused_header_tta(*args, 3)
    assert profiling.counters() == before  # no kernel on the CPU
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
