"""Tests of the port that need a CUDA card: the hand-written kernels
against their plain versions, on the card. They skip where there is no card.

This file imports neither jax nor the JAX package, so it also runs where
neither is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: float32 rtol = atol = 1e-4 (TF32 off; sums in another order);
bfloat16 rtol = atol = 1e-2 against the plain version run in float32 on the
same bfloat16 inputs (the kernel rounds its output to bfloat16).
"""
import numpy as np
import pytest
import torch

from streammos_tpu_torch.ops import fused_header as t_fh


def _header_inputs(rng, T=3, C=8, Cout=16, Bt=1, Hh=16, Wh=128):
    """A non-negative phase grid (the scatter of post-ReLU features) with
    empty padding rows, kernels, and affines whose pool scale may be
    negative."""
    g = np.maximum(rng.randn(Bt * T, 4, Hh + 2, Wh, 4 * C), 0).astype(np.float32)
    g[:, :, 0] = 0.0
    g[:, :, -1] = 0.0
    k3 = rng.randn(3, 3, T * C, Cout).astype(np.float32) * 0.1
    k1 = rng.randn(1, 1, T * C, Cout).astype(np.float32) * 0.1
    ca = (rng.uniform(0.5, 1.5, Cout).astype(np.float32),
          rng.randn(Cout).astype(np.float32) * 0.1)
    pa = (rng.uniform(-1.5, 1.5, Cout).astype(np.float32),
          rng.randn(Cout).astype(np.float32) * 0.1)
    return g, k3, k1, ca, pa


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", [
    ("float32", dict(Bt=1)), ("float32", dict(Bt=2, Hh=9, Wh=20, C=3)),
    ("bfloat16", dict(C=64, Cout=32, Hh=32, Wh=48))])
def test_cuda_kernel_matches_plain(cuda, dtype, shape):
    g, k3, k1, ca, pa = _header_inputs(np.random.RandomState(4), **shape)
    dt = getattr(torch, dtype)
    g, k3, k1 = (torch.from_numpy(x).to(cuda, dt) for x in (g, k3, k1))
    ca, pa = (tuple(torch.from_numpy(a).to(cuda) for a in aff)
              for aff in (ca, pa))
    before = t_fh.fused_header_tta.launches
    got = t_fh.fused_header_tta(g, k3, k1, ca, pa, 3)
    torch.cuda.synchronize()
    assert t_fh.fused_header_tta.launches == before + 1
    want = t_fh.fused_header_reference(g.float(), k3.float(), k1.float(),
                                       ca, pa, 3)
    tol = dict(rtol=1e-4, atol=1e-4) if dt == torch.float32 else \
        dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(got.float(), want, **tol)


@pytest.mark.cuda
def test_cuda_kernel_rejects_what_it_cannot_take(cuda):
    g, k3, k1, ca, pa = _header_inputs(np.random.RandomState(5), Cout=12,
                                       Hh=4, Wh=8)
    args = [torch.from_numpy(x).to(cuda) for x in (g, k3, k1)]
    affs = [tuple(torch.from_numpy(a).to(cuda) for a in aff) for aff in (ca, pa)]
    with pytest.raises(ValueError):  # Cout % 8 != 0
        t_fh.fused_header_tta(*args, *affs, 3)
    with pytest.raises(TypeError):
        t_fh.fused_header_tta(*(a.half() for a in args), *affs, 3)


@pytest.mark.cuda
def test_tiny_model_on_the_card_matches_the_cpu(cuda):
    """The folded, fused eval of StreamMOS_tiny (float32, refine head) on
    the card, through the kernel, against the same model on the CPU,
    through the plain versions, over a fresh and a carried-memory frame.
    Tolerance 2e-3, as the CPU tests against JAX."""
    from streammos_tpu_torch import serve
    from streammos_tpu_torch.config import get_config
    from streammos_tpu_torch.scans import skewed_scan_bank

    cfg = get_config("StreamMOS_tiny")
    frames = [{"xyzi": f[0], "seq_id": "00"} for f in skewed_scan_bank(
        np.random.default_rng(7), 2, cfg.model.seq_num, 1024)]
    outs = {}
    for dev in ("cpu", cuda):
        model = serve.build_model(cfg, device=dev, seed=3)
        outs[str(dev)] = [(s.cpu(), bf.cpu())
                          for s, bf in serve.stream_eval(model, frames)]
    for (want_s, want_bf), (got_s, got_bf) in zip(outs["cpu"], outs["cuda"]):
        torch.testing.assert_close(got_s, want_s, rtol=2e-3, atol=2e-3)
        torch.testing.assert_close(got_bf, want_bf, rtol=2e-3, atol=2e-3)
