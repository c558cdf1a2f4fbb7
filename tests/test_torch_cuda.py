"""Tests of the port that need a CUDA card: the hand-written kernels
against their plain versions, on the card. They skip where there is no card.

This file imports neither jax nor the JAX package, so it also runs where
neither is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: fused header float32 rtol = atol = 1e-4 (TF32 off in the plain
version; the kernel's 3xTF32 products keep about 22 mantissa bits, its sums
in another order); bfloat16 (the tensor-core kernel) rtol = atol = 1e-2
against the plain version run in float32 on the same bfloat16 inputs (the
kernel rounds its output to bfloat16). The scatter kernels are bit-exact against their plain versions
and `impl="auto"`, forward and backward: a max does not depend on order
(the folded TTA scatter: equal in value, +0 and -0 alike).
The kernels also run at StreamMOS_seg's production shapes, on the inputs
`streammos_tpu_torch/tools/kernel_times.py` times them on: the header in
both dtypes, the scatters at the five sites of a frame (the folded TTA
scatter also at Bt = 4 and in float32), the gather at the five sites of an
eager step.
The folded TTA gather kernel: float32 within 1e-6 of its plain version
(the same float32 ops, each rounded once, in the same order); bfloat16
within one rounding to bfloat16 (rtol 2**-8) of the plain version run in
float32 on the same grid (the kernel sums in float32 and rounds once), and
within 2**-5 of the sum of the kept taps' magnitudes of the plain bfloat16
version, which rounds its weights (each off by up to 2**-8 absolute: f
and 1 - f rounded), its products and its sums.
The eval BN epilogue kernel: equal in value to its plain version in
either dtype (the same float32 ops, each rounded once, in the same order,
then one rounding to the output dtype), and in bfloat16 within one
rounding to bfloat16 (rtol 2**-8) of the plain version run in float32 on
the same operands; at every site of a StreamMOS_seg step, Bt = 1 and 4,
in both dtypes and NCHW and channels-last.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from streammos_tpu_torch import build
from streammos_tpu_torch.config import get_config
from streammos_tpu_torch.ops import bn_act as t_bn
from streammos_tpu_torch.ops import fused_header as t_fh
from streammos_tpu_torch.ops import pallas_scatter as t_sorted
from streammos_tpu_torch.ops import pallas_scatter_vmem as t_vmem
from streammos_tpu_torch.ops import tta_fold as t_tta
from streammos_tpu_torch.ops import voxel_pool as t_vp
from streammos_tpu_torch.tools import kernel_times as kt
from streammos_tpu_torch.utils import profiling


def _by_path(name):
    """A numpy helper module of this directory, loaded by its path: an
    installed package named `tests` may shadow the directory."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(__file__), f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cases = _by_path("scatter_cases")
gather_cases = _by_path("gather_cases")


def _launched(before):
    """The hand kernels' launches since the counters read `before`."""
    now = profiling.counters()
    return {k: now[k] - before.get(k, 0) for k in now
            if k.startswith("kernel.") and now[k] != before.get(k, 0)}


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


def _header_on(dev, dtype, args):
    g, k3, k1, ca, pa = args
    g, k3, k1 = (torch.from_numpy(x).to(dev, dtype) for x in (g, k3, k1))
    return g, k3, k1, *(tuple(torch.from_numpy(a).to(dev) for a in aff)
                        for aff in (ca, pa))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", [
    ("float32", dict(Bt=1)), ("float32", dict(Bt=2, Hh=9, Wh=20, C=3)),
    # float32 (3xTF32): ragged grids, chunks of 16 channels cut short by
    # 16-byte units (C = 20) and by single channels (C = 18, 4-byte
    # copies), Cout below 32; the production shape
    ("float32", dict(Bt=2, C=48, Cout=24, Hh=13, Wh=33)),
    ("float32", dict(Bt=2, C=20, Cout=8, Hh=9, Wh=20)),
    ("float32", dict(Bt=1, C=18, Cout=16, Hh=10, Wh=17)),
    ("float32", dict(C=64, Cout=32, Hh=256, Wh=256)),
    ("bfloat16", dict(C=64, Cout=32, Hh=32, Wh=48)),
    # grids that are no multiple of the 8 x 16 tile; chunks of 32 channels
    # cut short (C = 16, 48); Cout below the 32 the B operand holds
    ("bfloat16", dict(Bt=2, C=64, Cout=32, Hh=37, Wh=45)),
    ("bfloat16", dict(Bt=2, C=16, Cout=8, Hh=9, Wh=20)),
    ("bfloat16", dict(Bt=2, C=48, Cout=24, Hh=13, Wh=33)),
    # the production shape (StreamMOS_seg's header)
    ("bfloat16", dict(C=64, Cout=32, Hh=256, Wh=256))])
def test_cuda_kernel_matches_plain(cuda, dtype, shape):
    dt = getattr(torch, dtype)
    g, k3, k1, ca, pa = _header_on(
        cuda, dt, _header_inputs(np.random.RandomState(4), **shape))
    before = profiling.counters()
    got = t_fh.fused_header_tta(g, k3, k1, ca, pa, 3)
    torch.cuda.synchronize()
    assert _launched(before) == {
        "kernel.fused_header." + ("f32" if dt == torch.float32 else "bf16"): 1}
    want = t_fh.fused_header_reference(g.float(), k3.float(), k1.float(),
                                       ca, pa, 3)
    tol = dict(rtol=1e-4, atol=1e-4) if dt == torch.float32 else \
        dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(got.float(), want, **tol)


@pytest.mark.cuda
def test_cuda_bf16_kernel_ignores_the_padding_rows(cuda):
    """NaN in the padding rows above and below each phase plane: the output
    is the same as with zero padding, and finite."""
    args = _header_on(cuda, torch.bfloat16, _header_inputs(
        np.random.RandomState(8), Bt=2, C=64, Cout=32, Hh=19, Wh=40))
    want = t_fh.fused_header_tta(*args, 3)
    g = args[0].clone()
    g[:, :, 0] = float("nan")
    g[:, :, -1] = float("nan")
    got = t_fh.fused_header_tta(g, *args[1:], 3)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [64, 3])
def test_cuda_f32_kernel_ignores_the_padding_rows(cuda, C):
    """The float32 kernel (16-byte copies at C = 64, 4-byte ones at C = 3):
    NaN in the padding rows leaves the output bit-equal to the one with
    zero padding, finite, and within 1e-4 of the plain version."""
    args = _header_on(cuda, torch.float32, _header_inputs(
        np.random.RandomState(8), Bt=2, C=C, Cout=32, Hh=19, Wh=40))
    want = t_fh.fused_header_tta(*args, 3)
    g = args[0].clone()
    g[:, :, 0] = float("nan")
    g[:, :, -1] = float("nan")
    got = t_fh.fused_header_tta(g, *args[1:], 3)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)
    torch.testing.assert_close(
        got, t_fh.fused_header_reference(*args, 3), rtol=1e-4, atol=1e-4)


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
    # the bf16 kernel's own limits
    for shape in (dict(C=8, Cout=16), dict(C=24, Cout=16),  # C % 16 != 0
                  dict(C=16, Cout=40)):                      # Cout > 32
        with pytest.raises(ValueError):
            t_fh.fused_header_tta(*_header_on(cuda, torch.bfloat16, _header_inputs(
                np.random.RandomState(5), Hh=4, Wh=8, **shape)), 3)
    g, k3, k1, ca, pa = _header_on(cuda, torch.bfloat16, _header_inputs(
        np.random.RandomState(5), C=16, Cout=16, Hh=4, Wh=8))
    shifted = torch.empty(g.numel() + 1, dtype=g.dtype, device=cuda)[1:]
    shifted = shifted.view(g.shape).copy_(g)  # contiguous, 2 bytes off
    with pytest.raises(ValueError):
        t_fh.fused_header_tta(shifted, k3, k1, ca, pa, 3)
    # the float32 kernel's: Cout > 32, a g_phase 4 bytes off 16
    with pytest.raises(ValueError):
        t_fh.fused_header_tta(*_header_on(cuda, torch.float32, _header_inputs(
            np.random.RandomState(5), C=3, Cout=40, Hh=4, Wh=8)), 3)
    g, k3, k1, ca, pa = _header_on(cuda, torch.float32, _header_inputs(
        np.random.RandomState(5), C=3, Cout=16, Hh=4, Wh=8))
    shifted = torch.empty(g.numel() + 1, dtype=g.dtype, device=cuda)[1:]
    shifted = shifted.view(g.shape).copy_(g)
    before = profiling.counters()
    with pytest.raises(ValueError):
        t_fh.fused_header_tta(shifted, k3, k1, ca, pa, 3)
    assert _launched(before) == {}


FORWARD_KEYS = ("pred_folded", "bf_pred_folded", "aux0", "aux1", "aux2",
                "memory")


@pytest.mark.cuda
def test_tiny_model_on_the_card_matches_the_cpu(cuda):
    """The folded, fused eval of StreamMOS_tiny (float32, refine head) on
    the card, through the kernel, against the same model on the CPU,
    through the plain versions, over a fresh and a carried-memory frame:
    the scores, and every output of the model's forward (logits, auxiliary
    heads, memory). Tolerance 2e-3, as the CPU tests against JAX."""
    from streammos_tpu_torch import serve
    from streammos_tpu_torch.scans import skewed_scan_bank

    cfg = get_config("StreamMOS_tiny")
    frames = [{"xyzi": f[0], "seq_id": "00"} for f in skewed_scan_bank(
        np.random.default_rng(7), 2, cfg.model.seq_num, 1024)]
    outs, forward = {}, {}
    for dev in ("cpu", cuda):
        model = serve.build_model(cfg, device=dev, seed=3)
        seen = forward[str(dev)] = []
        hook = model.register_forward_hook(lambda m, a, out: seen.append(
            {k: out[k].cpu() for k in FORWARD_KEYS}))
        outs[str(dev)] = [(s.cpu(), bf.cpu())
                          for s, bf in serve.stream_eval(model, frames)]
        hook.remove()
    for (want_s, want_bf), (got_s, got_bf) in zip(outs["cpu"], outs["cuda"]):
        torch.testing.assert_close(got_s, want_s, rtol=2e-3, atol=2e-3)
        torch.testing.assert_close(got_bf, want_bf, rtol=2e-3, atol=2e-3)
    assert len(forward["cpu"]) == len(forward["cuda"]) == 2
    for want, got in zip(forward["cpu"], forward["cuda"]):
        for k in FORWARD_KEYS:
            torch.testing.assert_close(got[k], want[k], rtol=2e-3, atol=2e-3)


def _sorted_rows(rng, R, C, n_cells, dev, dtype):
    """Rows sorted by id with negative values, sentinel ids, one crowded
    cell and empty cells."""
    feat = rng.normal(size=(R, C)).astype(np.float32)
    ids = rng.integers(0, n_cells + 1, R).astype(np.int32)
    ids[: R // 10] = n_cells
    ids[R // 10: R // 4] = n_cells // 2
    ids[ids == n_cells - 1] = n_cells
    feat[ids == 0] = -np.abs(feat[ids == 0])
    order = np.argsort(ids, kind="stable")
    return (torch.from_numpy(feat[order]).to(dev, dtype),
            torch.from_numpy(ids[order]).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_cells,C", [(1000, 8), (37, 5), (4100, 256),
                                       (17, 128)])
def test_sorted_scatter_kernel_matches_plain(cuda, dtype, n_cells, C):
    """Cell counts of no particular multiple, a partial last chunk of rows,
    the 16-byte and the one-channel paths."""
    feats, ids = _sorted_rows(np.random.default_rng(n_cells), 5000, C,
                              n_cells, cuda, getattr(torch, dtype))
    before = profiling.counters()
    got = t_sorted.sorted_scatter_max(feats, ids, n_cells)
    torch.cuda.synchronize()
    assert _launched(before) == {"kernel.sorted_scatter": 1}
    want = t_sorted.sorted_scatter_max_reference(feats, ids, n_cells)
    assert (want < 0).any()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,cells,C", [(1, 3000, 640, 128),
                                         (2, 2048, 1000, 256)])
def test_copy_scatter_kernel_matches_plain(cuda, dtype, B, N, cells, C):
    """The one-grid kernel: non-negative rows, ids out of range of either
    sign, cells not a multiple of 8, two batches."""
    rng = np.random.default_rng(cells)
    feat = torch.from_numpy(np.maximum(rng.normal(size=(B, N, C)), 0).astype(
        np.float32)).to(cuda, getattr(torch, dtype))
    ids = torch.from_numpy(rng.integers(-cells, 2 * cells, (B, N)).astype(
        np.int32)).to(cuda)
    before = profiling.counters()
    got = t_vmem.scatter_max_vmem(feat, ids, cells)
    torch.cuda.synchronize()
    assert _launched(before) == {"kernel.scatter_grid": 1}
    assert torch.equal(got, t_vmem.scatter_max_vmem_reference(feat, ids, cells))


def _adversarial_rows(kind, C, signed, rows):
    """A case of `tests/scatter_cases.py` at a size that crosses hundreds of
    the sorted kernel's 64-row chunks (200k rows in the one cell)."""
    rng = np.random.default_rng(cases.KINDS.index(kind))
    ids, n_cells = cases.scatter_case(
        kind, rng, 200_000 if kind == "one_cell" else rows)
    return ids, cases.scatter_rows(rng, ids, C, signed), n_cells


@pytest.mark.cuda
@pytest.mark.parametrize("C", [5, 8, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", cases.KINDS)
def test_sorted_scatter_kernel_adversarial(cuda, kind, dtype, C):
    """Signed rows (every even cell's maximum negative) in the distributions
    that broke the tile-per-thread design; C = 5 takes the one-channel
    path. Bit-exact against the plain version; one launch."""
    ids, rows, n_cells = _adversarial_rows(kind, C, True, 50_000)
    ids, rows = cases.sort_by_id(ids, rows)
    dt = getattr(torch, dtype)
    feats = torch.from_numpy(rows).to(cuda, dt)
    tids = torch.from_numpy(ids).to(cuda)
    before = profiling.counters()
    got = t_sorted.sorted_scatter_max(feats, tids, n_cells)
    torch.cuda.synchronize()
    assert _launched(before) == {"kernel.sorted_scatter": 1}
    want = t_sorted.sorted_scatter_max_reference(feats, tids, n_cells)
    assert torch.equal(got, want)
    assert (want[-1] == 0).all()
    assert kind == "sentinel" or (want < 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("C", [128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", cases.VMEM_KINDS)
def test_grid_scatter_kernel_adversarial(cuda, kind, dtype, C):
    """Non-negative rows in the same distributions, unsorted, over two
    batches (the second a permutation of the first; the batch offset is in
    the address), 20k rows where the grid has a cell a row (`fits_vmem`):
    bit-exact against the plain version; one launch."""
    ids, rows, cells = _adversarial_rows(kind, C, False, 20_000)
    perm = np.random.default_rng(1).permutation(len(ids))
    dt = getattr(torch, dtype)
    feat = torch.from_numpy(np.stack([rows, rows[perm]])).to(cuda, dt)
    tids = torch.from_numpy(np.stack([ids, ids[perm]])).to(cuda)
    before = profiling.counters()
    got = t_vmem.scatter_max_vmem(feat, tids, cells)
    torch.cuda.synchronize()
    assert _launched(before) == {"kernel.scatter_grid": 1}
    assert torch.equal(got, t_vmem.scatter_max_vmem_reference(feat, tids, cells))
    assert (got[:, -1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_kernels_edge_sizes(cuda, dtype):
    """No rows at all (both kernels, the sorted one on both channel paths),
    and a grid of one cell with negative rows and sentinels: bit-exact
    against the plain versions, one launch a call."""
    dt = getattr(torch, dtype)
    for P, n_cells, C in ((0, 1, 8), (0, 64, 5), (300, 1, 128), (300, 1, 5)):
        rows = -torch.rand(P, C, generator=torch.Generator().manual_seed(P))
        ids = torch.zeros(P, dtype=torch.int32)
        ids[P // 2:] = n_cells  # sentinel rows, sorted to the end
        feats, tids = rows.to(cuda, dt), ids.to(cuda)
        before = profiling.counters()
        got = t_sorted.sorted_scatter_max(feats, tids, n_cells)
        torch.cuda.synchronize()
        assert _launched(before) == {"kernel.sorted_scatter": 1}
        want = t_sorted.sorted_scatter_max_reference(feats, tids, n_cells)
        assert torch.equal(got, want), (P, n_cells, C)
        assert P == 0 or (got[0] < 0).all()
    feat = torch.empty((2, 0, 128), dtype=dt, device=cuda)
    before = profiling.counters()
    got = t_vmem.scatter_max_vmem(
        feat, torch.empty((2, 0), dtype=torch.int32, device=cuda), 640)
    torch.cuda.synchronize()
    assert _launched(before) == {"kernel.scatter_grid": 1}
    assert got.shape == (2, 640, 128) and (got == 0).all()


@pytest.mark.cuda
def test_scatter_kernels_reject_what_they_cannot_take(cuda):
    feats, ids = _sorted_rows(np.random.default_rng(0), 100, 128, 64, cuda,
                              torch.float32)
    with pytest.raises(TypeError):
        t_sorted.sorted_scatter_max(feats.half(), ids, 64)
    with pytest.raises(TypeError):
        t_sorted.sorted_scatter_max(feats, ids.long(), 64)
    with pytest.raises(ValueError):
        t_sorted.sorted_scatter_max(feats[:, ::2], ids, 64)
    feat, vids = feats[None], ids[None]
    with pytest.raises(TypeError):
        t_vmem.scatter_max_vmem(feat.half(), vids, 64)
    with pytest.raises(TypeError):
        t_vmem.scatter_max_vmem(feat, vids.long(), 64)
    with pytest.raises(ValueError):  # C % 128 != 0
        t_vmem.scatter_max_vmem(feat[..., :96].contiguous(), vids, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [(False, 0), (True, 1), ("outer", 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_voxel_max_pool_kernels_match_auto(cuda, layout, dtype):
    """Through the entry point, forward and gradients: "pallas" and "vmem"
    equal "auto" exactly; values from a few levels, so cells hold ties and
    zeros, each of which gets the full gradient."""
    phase_split, row_pad = layout
    rng = np.random.default_rng(1)
    B, N, C, size = 2, 4000, 128, (30, 26)
    feat = torch.from_numpy(rng.integers(0, 4, (B, N, C)).astype(
        np.float32)).to(cuda, getattr(torch, dtype))
    inds = torch.from_numpy(rng.uniform(-2, 64, (B, N, 2)).astype(
        np.float32)).to(cuda)
    cot = torch.from_numpy(rng.normal(size=(B, N, C)).astype(np.float32))
    results = {}
    for impl in ("auto", "pallas", "vmem"):
        x = feat.clone().requires_grad_()
        out = t_vp.voxel_max_pool(x, inds, size, (0.5, 0.5), True, phase_split,
                                  row_pad, impl=impl)
        g = cot.to(cuda, out.dtype).reshape(-1)[: out.numel()].reshape(out.shape)
        (out * g).sum().backward()
        results[impl] = (out.detach(), x.grad)
    for impl in ("pallas", "vmem"):
        assert torch.equal(results[impl][0], results["auto"][0]), impl
        assert torch.equal(results[impl][1], results["auto"][1]), impl


@pytest.mark.cuda
@pytest.mark.parametrize("stage2", [False, True], ids=["stage1", "stage2"])
def test_tiny_train_step_on_the_card_matches_the_cpu(cuda, stage2):
    """One train step of StreamMOS_tiny (float32, dropout off) on the card
    against the same step on the CPU, from the same weights and windows
    (1024 points). Tolerances: loss rtol 1e-4; gradient norm rtol 1e-3; BN
    statistics rtol = atol = 1e-3; the updates, all parameters together,
    within a relative L2 distance of 1e-2, each parameter's within 5e-2 (a
    ReLU input or a scatter's runner-up within ~1e-6 of its switch routes
    the gradient differently on the two devices; on the CPU, such a switch
    between the port and JAX moved the update by 1.4e-3 overall and 8e-3
    in its worst tensor); a parameter the CPU step leaves alone stays."""
    paths = _by_path("test_torch_card_paths")
    cfg = paths.tiny_cfg()
    runs = []
    for dev in ("cpu", cuda):
        model, state, step = paths.train_setup(cfg, stage2, dev, 3)
        before = {k: v.detach().cpu().clone()
                  for k, v in model.state_dict().items()}
        state, metrics = step(state, paths.train_windows(cfg, dev, stage2,
                                                         1024, 4))
        runs.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                     before, {k: v.detach().cpu()
                              for k, v in model.state_dict().items()},
                     [n for n, _ in model.named_parameters()]))
    (l0, g0, b0, a0, names), (l1, g1, _, a1, _) = runs
    assert abs(l1 - l0) <= 1e-4 * abs(l0)
    assert abs(g1 - g0) <= 1e-3 * abs(g0)
    for k in a0:
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(a1[k], a0[k], rtol=1e-3, atol=1e-3)
    num = den = worst = 0.0
    for n in names:
        d0, d1 = a0[n] - b0[n], a1[n] - b0[n]
        if not d0.any():
            assert not d1.any(), n
            continue
        dist = float((d1 - d0).norm())
        num, den = num + dist ** 2, den + float(d0.norm()) ** 2
        worst = max(worst, dist / float(d0.norm()))
    assert worst <= 5e-2 and (num / den) ** 0.5 <= 1e-2, (worst, num / den)


@pytest.mark.cuda
def test_dataset_stream_eval_on_the_card(cuda, tmp_path):
    """`train.evaluate.stream_eval` over a synthetic two-sequence tree
    (StreamMOS_tiny, float32, random weights from a seed) on the card: one
    fused-header launch a frame and one for the eager warm-up before the
    carried step's CUDA graphs are captured, and so five of the folded
    gather and five of the folded scatter and `bn_launches` of the eval BN
    epilogue, no other scatter kernel, one
    `.label` a frame; the metric within 1e-3 of the same run on the CPU, and at least
    99.5% of the label-file points equal to it (float32 sums in another
    order flip near-ties)."""
    import dataclasses
    import logging

    from streammos_tpu_torch import serve
    from streammos_tpu_torch.config import get_config
    from streammos_tpu_torch.data.dataset import EvalDataset
    from streammos_tpu_torch.train import evaluate
    make_sequence = _by_path("synthetic_kitti").make_sequence
    seqs = tmp_path / "sequences"
    for seq, seed in (("00", 0), ("08", 1)):
        make_sequence(str(seqs), seq, n_frames=4, n_points=3000, seed=seed)
    cfg = get_config("StreamMOS_tiny")
    cfg = dataclasses.replace(cfg, val=dataclasses.replace(
        cfg.val, seq_dir=str(seqs), frame_point_num=4096))
    results, labels = {}, {}
    for dev in ("cpu", cuda):
        model = serve.build_model(cfg, device=dev, seed=0)
        ds = EvalDataset(cfg.val, seq_ids=[0, 8])
        root = tmp_path / str(dev)
        before = profiling.counters()
        results[str(dev)] = evaluate.stream_eval(
            cfg, cfg.val, model, with_refine=True, with_labels=True,
            logger=logging.getLogger("test"), dataset=ds, save_root=str(root))
        if dev != "cpu":
            assert len(ds) == 8
            # a frame each, and the warm-up before the one capture
            assert _launched(before) == {
                "kernel.fused_header.f32": 8 + 1,
                "kernel.grid_gather_tta": 5 * (8 + 1),
                "kernel.scatter_tta": 5 * (8 + 1),
                "kernel.bn_act": kt.bn_launches(model) * (8 + 1)}
        labels[str(dev)] = np.concatenate([
            np.fromfile(root / s / "predictions" / f"{i:06d}.label",
                        dtype=np.uint32)
            for s in ("00", "08") for i in range(4)])
    a, b = results["cpu"], results[str(cuda)]
    assert a.keys() == b.keys()
    assert all(abs(a[k] - b[k]) <= 1e-3 for k in a), (a, b)
    assert labels["cpu"].shape == labels[str(cuda)].shape == (8 * 3000,)
    assert (labels["cpu"] == labels[str(cuda)]).mean() >= 0.995


# the five gather sites of a StreamMOS_seg frame: (name, kind, H, W, C, scale)
GATHER_SITES = [("bev0", "bev", 256, 256, 32, (0.5, 0.5)),
                ("rv0", "rv", 32, 1024, 32, (0.5, 0.5)),
                ("bev1", "bev", 128, 128, 64, (0.25, 0.25)),
                ("rv1", "rv", 16, 512, 64, (0.25, 0.25)),
                ("point", "bev", 256, 256, 64, (0.5, 0.5))]


def _gather_inputs(dev, dtype, Bt, H, W, C, N, scale, layout, seed=0):
    """Variant grids (4, Bt, H, W, C) as the model hands them over: views of
    (4 * Bt, C, H, W) conv outputs, channels-last ("nhwc") or not
    ("nchw"); coordinates with the cases of `gather_cases` first, viewed
    out of a wider array as the model's are."""
    rng = np.random.RandomState(seed)
    g = torch.from_numpy(rng.randn(4 * Bt, C, H, W).astype(np.float32))
    g = g.to(dev, dtype)
    if layout == "nhwc":
        g = g.contiguous(memory_format=torch.channels_last)
    grids = g.permute(0, 2, 3, 1).reshape(4, Bt, H, W, C)
    c = gather_cases.coords(rng, Bt, N, H, W, scale)
    wide = np.concatenate([c, rng.randn(Bt, N, 1).astype(np.float32)], -1)
    return grids, torch.from_numpy(wide).to(dev)[..., :2]


def _check_gather(grids, coords, scale, kind):
    before = profiling.counters()
    got = t_tta.grid_to_point_tta(grids, coords, scale, kind)
    assert _launched(before) == {"kernel.grid_gather_tta": 1}
    want32 = t_tta.grid_to_point_tta_reference(grids.float(), coords, scale,
                                               kind)
    torch.cuda.synchronize()
    assert got.shape == want32.shape and got.dtype == grids.dtype
    if grids.dtype == torch.float32:
        torch.testing.assert_close(got, want32, rtol=1e-6, atol=1e-6)
        return got
    torch.testing.assert_close(got.float(), want32, rtol=2 ** -8, atol=1e-30)
    # the sum of the kept taps' magnitudes: weights 1/4 each at the cell
    # centre of the same window keep the same taps
    centre = [(torch.floor(coords[..., i] * scale[i]) + 0.5) / scale[i]
              for i in range(2)]
    taps = 4 * t_tta.grid_to_point_tta_reference(
        grids.float().abs(), torch.stack(centre, -1), scale, kind)
    plain = t_tta.grid_to_point_tta_reference(grids, coords, scale, kind)
    assert bool(((got.float() - plain.float()).abs()
                 <= 2 ** -5 * taps + 1e-30).all())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Bt", [1, 4])
@pytest.mark.parametrize("site", GATHER_SITES, ids=[s[0] for s in GATHER_SITES])
def test_grid_gather_kernel_matches_plain(cuda, site, Bt, dtype):
    _, kind, H, W, C, scale = site
    for layout in ("nhwc", "nchw"):
        grids, coords = _gather_inputs(cuda, dtype, Bt, H, W, C, 160_000,
                                       scale, layout)
        got = _check_gather(grids, coords, scale, kind)
        far = coords.abs().amax(-1) >= gather_cases.FAR
        assert int(far.sum()) == Bt * 12 and not got[far].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N", [0, 1, 37, 1003])
def test_grid_gather_kernel_edge_sizes(cuda, dtype, N):
    for kind in ("bev", "rv"):
        for layout in ("nhwc", "nchw"):
            grids, coords = _gather_inputs(cuda, dtype, 2, 6, 16, 16, N,
                                           (0.5, 0.5), layout, seed=N)
            got = _check_gather(grids, coords, (0.5, 0.5), kind)
            assert got.shape == (2, N, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_grid_gather_kernel_replays_in_a_cuda_graph(cuda, layout):
    grids, coords = _gather_inputs(cuda, torch.bfloat16, 1, 32, 64, 32, 5000,
                                   (0.5, 0.5), layout)
    call = lambda: t_tta.grid_to_point_tta(grids, coords, (0.5, 0.5), "rv")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = profiling.counters()
    with torch.cuda.graph(graph):
        out = call()
    assert _launched(before) == {"kernel.grid_gather_tta": 1}
    for shift in (0.0, 3.25):
        coords.add_(shift)
        grids.mul_(1.5)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, call())


@pytest.mark.cuda
def test_grid_gather_kernel_rejects_what_it_cannot_take(cuda):
    grids, coords = _gather_inputs(cuda, torch.bfloat16, 1, 8, 16, 16, 50,
                                   (0.5, 0.5), "nhwc")
    gather = lambda g, c: t_tta.grid_to_point_tta(g, c, (0.5, 0.5), "bev")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gather(grids.half(), coords)
    with pytest.raises(TypeError, match="coordinates"):
        gather(grids, coords.double())
    with pytest.raises(ValueError, match="devices"):
        gather(grids, coords.cpu())
    with pytest.raises(ValueError, match="32 bytes"):
        gather(grids[..., :8], coords)   # 16 bytes of channels
    wide, _ = _gather_inputs(cuda, torch.bfloat16, 1, 8, 16, 24, 50,
                             (0.5, 0.5), "nhwc")
    with pytest.raises(ValueError, match="innermost"):
        gather(wide[..., 4:20], coords)  # starts 8 bytes into a slice
    _check_gather(wide[..., 8:24], coords, (0.5, 0.5), "bev")
    with pytest.raises(ValueError, match="innermost"):
        gather(grids.permute(0, 1, 3, 4, 2).contiguous()
               .permute(0, 1, 4, 2, 3), coords)  # rows innermost
    with pytest.raises(ValueError, match="grids"):
        gather(grids[:2], coords)
    with pytest.raises(ValueError, match="coords0"):
        gather(grids, coords[:, :, :1])


def _check_scatter_tta(feat, coords, size, scale, kind, layout):
    """The folded TTA scatter kernel, one launch, equal in value to its
    plain version run on the same card tensors."""
    args = (size, scale, kind, True, layout)
    before = profiling.counters()
    got = t_tta.voxel_max_pool_tta(feat, coords, *args)
    assert _launched(before) == {"kernel.scatter_tta": 1}
    want = t_tta.voxel_max_pool_tta_reference(feat, coords, *args)
    assert got.shape == want.shape and got.dtype == feat.dtype
    assert torch.equal(got, want)
    return got


def _scatter_tta_case(dev, dtype, kind_of_ids, P, C, W=64, seed=0):
    """A case of `tests/scatter_cases.py` as cells of a grid W cells wide:
    (feat (2, P, 4C), coords (2, P, 2) viewed out of a wider array, (H,
    W))."""
    rng = np.random.default_rng(seed)
    ids, n_cells = cases.scatter_case(kind_of_ids, rng, 2 * P)
    coords, H = cases.case_coords(ids, n_cells, W, (0.5, 0.5))
    feat = cases.scatter_rows(rng, ids, 4 * C, False).reshape(2, P, 4 * C)
    wide = np.concatenate([coords.reshape(2, P, 2),
                           np.zeros((2, P, 1), np.float32)], -1)
    return (torch.from_numpy(feat).to(dev, dtype),
            torch.from_numpy(wide).to(dev)[..., :2], (H, W))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["variants", "phase_outer"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", cases.KINDS)
def test_scatter_tta_kernel_adversarial(cuda, kind, dtype, layout):
    """The id distributions that stress the scatter kernels, at a size
    that crosses thousands of thread groups, in both grid kinds: equal in
    value to the plain version."""
    feat, coords, size = _scatter_tta_case(cuda, dtype, kind, 20_000, 16,
                                           seed=cases.KINDS.index(kind))
    for grid_kind in ("bev", "rv"):
        got = _check_scatter_tta(feat, coords, size, (0.5, 0.5), grid_kind,
                                 layout)
        if kind == "sentinel":
            assert not got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N", [0, 1, 7, 9, 1003])
def test_scatter_tta_kernel_edge_sizes(cuda, dtype, N):
    """Point counts below, at and across a thread's group of 8, rows of
    one 16-byte slice a variant, and batches that end inside a group."""
    C = 16 // torch.tensor([], dtype=dtype).element_size()
    gen = torch.Generator(device=cuda).manual_seed(N)
    for B in (1, 3):
        feat = torch.rand(B, N, 4 * C, generator=gen, device=cuda).to(dtype)
        coords = torch.rand(B, N, 3, generator=gen, device=cuda) * 14 - 2
        for kind in ("bev", "rv"):
            for layout in ("variants", "phase_outer"):
                got = _check_scatter_tta(feat, coords, (6, 10), (1.0, 1.0),
                                         kind, layout)
                if N == 0:
                    assert not got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["variants", "phase_outer"])
def test_scatter_tta_kernel_replays_in_a_cuda_graph(cuda, layout):
    feat, coords, size = _scatter_tta_case(cuda, torch.bfloat16, "runs_64",
                                           5000, 32)
    call = lambda: t_tta.voxel_max_pool_tta(feat, coords, size, (0.5, 0.5),
                                            "rv", True, layout)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = profiling.counters()
    with torch.cuda.graph(graph):
        out = call()
    assert _launched(before) == {"kernel.scatter_tta": 1}
    for shift in (0.0, 3.25):
        coords.add_(shift)
        feat.mul_(1.5)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, call())
        assert torch.equal(out, t_tta.voxel_max_pool_tta_reference(
            feat, coords, size, (0.5, 0.5), "rv", True, layout))


@pytest.mark.cuda
def test_scatter_tta_kernel_rejects_what_it_cannot_take(cuda):
    feat, coords, size = _scatter_tta_case(cuda, torch.bfloat16, "runs_64",
                                           50, 16)
    scatter = lambda f, c, **k: t_tta.voxel_max_pool_tta(
        f, c, k.pop("size", size), (0.5, 0.5), "bev", k.pop("nonneg", True),
        **k)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        scatter(feat.half(), coords)
    with pytest.raises(TypeError, match="coordinates"):
        scatter(feat, coords.double())
    with pytest.raises(ValueError, match="devices"):
        scatter(feat, coords.cpu())
    with pytest.raises(ValueError, match="devices"):
        scatter(feat.cpu(), coords)
    with pytest.raises(ValueError, match="nonneg"):
        scatter(feat, coords, nonneg=False)
    with pytest.raises(ValueError, match="16 bytes"):
        scatter(feat[..., :16].contiguous(), coords)  # 8 bytes a variant
    with pytest.raises(ValueError, match="16 bytes"):
        scatter(feat[..., 4:36], coords)  # rows start 8 bytes into a slice
    with pytest.raises(ValueError, match="16 bytes"):  # rows 136 bytes apart
        scatter(torch.cat([feat, feat[..., :4]], -1)[..., :64], coords)
    with pytest.raises(ValueError, match="even"):
        scatter(feat, coords, size=(size[0], 63))
    with pytest.raises(ValueError, match="layout"):
        scatter(feat, coords, layout="phase")
    _check_scatter_tta(torch.cat([feat, feat], -1)[..., 64:], coords, size,
                       (0.5, 0.5), "bev", "variants")


# ---- at StreamMOS_seg's production shapes ----------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("lib", ["sorted_scatter", "scatter_grid",
                                 "grid_gather_tta", "scatter_tta"])
def test_ptxas_reports_registers(cuda, lib):
    """A build keeps ptxas's registers and spills beside its library."""
    build.load_library(lib)
    assert any("registers" in line for line in build.ptxas_lines(lib))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,Bt,C,Cout,Hh,Wh,nan_pad,rtol,seed", [
    # the unit-test shape (tests/test_fused_header.py), absolute 1e-4
    ("float32", 1, 8, 16, 16, 128, False, 0.0, kt.SEED),
    ("float32", 2, 8, 16, 16, 128, False, 0.0, kt.SEED),
    # a grid that is no multiple of the 8 x 16 tile, NaN padding rows
    ("bfloat16", 2, 64, 32, 37, 45, True, 1e-2, kt.SEED),
    ("float32", 2, 48, 24, 37, 45, True, 1e-4, kt.SEED + 1),
    ("float32", 2, 3, 16, 37, 45, True, 1e-4, kt.SEED + 1),
    # StreamMOS_seg's header
    ("bfloat16", 1, 64, 32, 256, 256, False, 1e-2, kt.SEED),
    ("float32", 1, 64, 32, 256, 256, False, 1e-4, kt.SEED + 1)])
def test_header_on_the_timed_inputs(cuda, dtype, Bt, C, Cout, Hh, Wh,
                                    nan_pad, rtol, seed):
    """The header on `kernel_times.header_inputs` against the plain version
    run in float32 on the same inputs: |got - want| <= atol + rtol |want|,
    atol 1e-2 in bf16 (the kernel rounds its output to bf16), 1e-4 in
    float32; NaN in the padding rows leaves the output bit-equal."""
    args = kt.header_inputs(torch.Generator().manual_seed(seed), cuda, Bt, 3,
                            C, Cout, Hh, Wh, getattr(torch, dtype))
    g, k3, k1, ca, pa = args
    got = t_fh.fused_header_tta(*args, 3)
    want = t_fh.fused_header_reference(g.float(), k3.float(), k1.float(), ca,
                                       pa, 3)
    atol = 1e-2 if dtype == "bfloat16" else kt.F32_TOL
    assert torch.isfinite(got).all()
    assert bool(((got.float() - want).abs() <= atol + rtol * want.abs()).all())
    if nan_pad:
        g = g.clone()
        g[:, :, 0] = float("nan")
        g[:, :, -1] = float("nan")
        assert torch.equal(t_fh.fused_header_tta(g, *args[1:], 3), got)


@pytest.fixture(scope="module")
def frame_sites():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return kt.scatter_sites(get_config("StreamMOS_seg"), torch.device("cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("site", range(5), ids=[
    "full_grid", "stage0_rv", "stage0_bev", "stage1_rv", "stage1_bev"])
def test_scatter_kernels_at_a_site_of_a_frame(cuda, frame_sites, site):
    """`voxel_max_pool(impl="pallas")` at each of the five scatter sites of
    a frame and `impl="vmem"` at the four cascade sites (the full grid
    fails `fits_vmem`), one launch each, equal to impl="auto"; each kernel
    equal to its plain version on the rows it is handed; the sorted kernel
    also on signed rows, where maxima are negative, and the library call
    (the "auto" body) on the sorted rows."""
    s = frame_sites[site]
    feat, inds, (size, scale, _, split, pad) = s["feat"], s["inds"], s["args"]
    B, N, C = feat.shape
    auto = t_vp.voxel_max_pool(feat, inds, *s["args"])
    before = profiling.counters()
    assert torch.equal(t_vp.voxel_max_pool(feat, inds, *s["args"],
                                           impl="pallas"), auto)
    assert _launched(before) == {"kernel.sorted_scatter": 1}
    flat, valid, n = t_vp._cell_ids(inds, size, scale, split, pad)
    if site == 0:
        with pytest.raises(ValueError, match="fits_vmem"):
            t_vp.voxel_max_pool(feat, inds, *s["args"], impl="vmem")
    else:
        before = profiling.counters()
        assert torch.equal(t_vp.voxel_max_pool(feat, inds, *s["args"],
                                               impl="vmem"), auto)
        assert _launched(before) == {"kernel.scatter_grid": 1}
        ids = flat.to(torch.int32)
        assert torch.equal(t_vmem.scatter_max_vmem(feat, ids, n),
                           t_vmem.scatter_max_vmem_reference(feat, ids, n))
    off = torch.arange(B, device=cuda)[:, None] * n
    glob = torch.where(valid, flat + off, B * n).to(torch.int32).reshape(-1)
    ids_sorted, perm = torch.sort(glob)
    signed = torch.randn(B, N, C, generator=torch.Generator(
        device=cuda).manual_seed(kt.SEED), device=cuda).to(torch.bfloat16)
    for rows in (feat, signed):
        rows = rows.reshape(-1, C).index_select(0, perm)
        want = t_sorted.sorted_scatter_max_reference(rows, ids_sorted, B * n)
        assert torch.equal(
            t_sorted.sorted_scatter_max(rows, ids_sorted, B * n), want)
    assert (want < 0).any()
    assert torch.equal(
        t_vp.voxel_max_pool(signed, inds, size, scale, False, split, pad,
                            impl="pallas"),
        t_vp.voxel_max_pool(signed, inds, size, scale, False, split, pad))
    rows = feat.reshape(-1, C).index_select(0, perm)
    assert torch.equal(kt.scatter_library(rows, ids_sorted, B * n, False)
                       .reshape(auto.shape), auto)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Bt", [1, 4])
def test_scatter_tta_kernel_at_the_sites_of_a_step(cuda, Bt, dtype):
    """The folded TTA scatter at the five sites of a step of Bt streams, on
    the inputs `kernel_times` times (at Bt = 1, bf16): the full grid in the
    fused header's phase-outer layout, the four cascade grids each variant
    in its own orientation; equal in value to the plain version."""
    sites = kt.scatter_sites(get_config("StreamMOS_seg"), cuda, Bt, dtype)
    assert [s["span"] for s in sites] == [
        "smt.scatter." + n for n in ("bev_full", "rv0", "bev0", "rv1", "bev1")]
    with torch.inference_mode():
        for s in sites:
            size, scale = s["args"][:2]
            got = _check_scatter_tta(s["feat"], s["inds"], size, scale,
                                     s["kind"], s["layout"])
            outer = s["layout"] == "phase_outer"
            assert got.shape[:2] == ((Bt * 3, 4) if outer else (4, Bt))
            del got


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["sorted_one_cell", "sorted_runs_of_64",
                                  "grid_one_cell"])
def test_scatter_kernels_on_160k_rows(cuda, case):
    """160k bf16 rows of 256 channels: for the sorted kernel all in one
    cell (the first 128 channels negative, so the cell's maximum is
    negative there) and in runs of exactly 64 rows (every other cell
    negative); for the grid kernel all in one cell of a stage-1 BEV grid
    (non-negative). Bit-exact against the plain versions."""
    P = kt.POINTS
    rows = torch.randn(P, 256, generator=torch.Generator(
        device=cuda).manual_seed(kt.SEED + 5), device=cuda)
    if case == "grid_one_cell":
        x = rows.abs().to(torch.bfloat16)[None]
        ids = torch.full((1, P), 4321, dtype=torch.int32, device=cuda)
        assert torch.equal(
            t_vmem.scatter_max_vmem(x, ids, 128 * 128),
            t_vmem.scatter_max_vmem_reference(x, ids, 128 * 128))
        return
    if case == "sorted_one_cell":
        ids = torch.zeros(P, dtype=torch.int32, device=cuda)
        x = torch.cat([-rows[:, :128].abs(), rows[:, 128:]], 1)
    else:
        ids = torch.arange(P, device=cuda, dtype=torch.int32) // 64
        x = torch.where((ids % 2 == 0)[:, None], -rows.abs(), rows)
    x, cells = x.to(torch.bfloat16), int(ids[-1]) + 2
    want = t_sorted.sorted_scatter_max_reference(x, ids, cells)
    assert torch.equal(t_sorted.sorted_scatter_max(x, ids, cells), want)
    assert (want < 0).any()


@pytest.mark.cuda
def test_grid_gather_kernel_at_the_sites_of_a_frame(cuda):
    """The five folded gathers of an eager StreamMOS_seg step, on the grids
    and coordinates the model hands over (bf16, strides as they come):
    within one rounding to bf16 of the plain version run in float32 on the
    same grid, and within 1e-6 of it on the float32 grid."""
    sites = kt.gather_sites(get_config("StreamMOS_seg"), cuda)
    assert [name for name, _ in sites] == list(kt.GATHER_SITES)
    with torch.inference_mode():
        for name, (g, coords, scale, kind) in sites:
            want = t_tta.grid_to_point_tta_reference(g.float(), coords, scale,
                                                     kind)
            got = t_tta.grid_to_point_tta(g, coords, scale, kind).float()
            assert bool(((got - want).abs() <= 2 ** -8 * want.abs()).all())
            got32 = t_tta.grid_to_point_tta(g.float(), coords, scale, kind)
            assert float((got32 - want).abs().max()) <= 1e-6 * (
                1 + float(want.abs().max())), name


# ---- the eval BN epilogue ----------------------------------------------------

def _check_bn_act(args, launches=1):
    """The kernel against its plain version on the same operands."""
    x, w, b, m, v, eps, fold, act, r, g = args
    before = profiling.counters()
    got = t_bn.bn_act(*args)
    assert _launched(before) == {"kernel.bn_act": launches}
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.stride() == x.stride()
    assert torch.equal(got, t_bn.bn_act_reference(*args))
    if x.dtype == torch.bfloat16:
        f32 = lambda t: None if t is None else t.float()
        want = t_bn.bn_act_reference(f32(x), w, b, m, v, eps, fold, act,
                                     f32(r), f32(g))
        torch.testing.assert_close(got.float(), want, rtol=2 ** -8,
                                   atol=1e-30)


@pytest.fixture(scope="module")
def bn_sites():
    """`kernel_times.bn_sites` of StreamMOS_seg by Bt, found once."""
    found = {}

    def sites(dev, Bt):
        if Bt not in found:
            found[Bt] = kt.bn_sites(get_config("StreamMOS_seg"), dev, Bt)
        return found[Bt]
    return sites


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("Bt", [1, 4])
def test_bn_act_kernel_at_the_sites_of_a_step(cuda, bn_sites, Bt, dtype):
    """Every eval BN epilogue of a StreamMOS_seg step of Bt streams (58:
    53 BNs and the 5 channel-attention gates' BNs over their means), at
    its shape, act, residual and gate, in `dtype` (the gates' mean BNs stay
    float32 in a bfloat16 step), the encoder's in NCHW and channels last,
    on operands from the seed."""
    sites = bn_sites(cuda, Bt)
    assert len(sites) == 58
    assert sum(s["gate"] is not None for s in sites) == 5
    gen = torch.Generator(device=cuda).manual_seed(kt.SEED + Bt)
    with torch.inference_mode():
        for site in sites:
            dt = torch.float32 if dtype == "float32" else site["dtype"]
            for layout in (("nchw",) if site["fold"] else ("nchw", "nhwc")):
                _check_bn_act(kt.bn_operands(site, gen, dt, layout))


def _bn_site(shape, C, fold, act="relu", residual=True, gate=False):
    return dict(shape=list(shape), strides=None, dtype=torch.bfloat16,
                fold=fold, C=C, act=act, residual=residual,
                gate=[shape[0], C, 1, 1] if gate else None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", [
    "ragged_point", "leaky_nchw", "misaligned", "gate_nchw", "gate_nhwc",
    "one_by_one", "wide"])
def test_bn_act_kernel_edge_cases(cuda, case, dtype):
    """Rows of 28 (C = 7, fold 4) and a total no multiple of a vector,
    pointers off 16-byte alignment (one element a thread), gates in both
    layouts, 1 x 1 maps, and 4096 channels."""
    layout = "nhwc" if case == "gate_nhwc" else "nchw"
    site = {"ragged_point": _bn_site((3, 5, 28), 7, 4),
            "leaky_nchw": _bn_site((2, 6, 5, 7), 6, 0, "leaky_relu", False),
            "misaligned": _bn_site((2, 6, 5, 7), 6, 0),
            "gate_nchw": _bn_site((3, 12, 7, 9), 12, 0, gate=True),
            "gate_nhwc": _bn_site((3, 12, 7, 9), 12, 0, gate=True),
            "one_by_one": _bn_site((5, 16, 1, 1), 16, 0, "none", gate=True),
            "wide": _bn_site((2, 4096, 3, 5), 4096, 0)}[case]
    gen = torch.Generator(device=cuda).manual_seed(kt.SEED)
    args = list(kt.bn_operands(site, gen, dtype, layout))
    if case == "misaligned":
        for i in (0, 8):
            t = args[i]
            off = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
            args[i] = off[1:].view(t.shape).copy_(t)
            assert args[i].data_ptr() % 16
    with torch.inference_mode():
        _check_bn_act(tuple(args))


@pytest.mark.cuda
def test_bn_act_kernel_cuts_large_tensors_into_launches(cuda):
    """3 samples of 2^29 bf16 elements with a gate and a residual: launches
    of whole samples, at most 2^30 elements each (two), each sample equal
    to the plain version's."""
    site = _bn_site((3, 64, 2048, 4096), 64, 0, gate=True)
    gen = torch.Generator(device=cuda).manual_seed(kt.SEED)
    x, w, b, m, v, eps, fold, act, r, g = kt.bn_operands(site, gen,
                                                         layout="nchw")
    with torch.inference_mode():
        before = profiling.counters()
        got = t_bn.bn_act(x, w, b, m, v, eps, fold, act, r, g)
        assert _launched(before) == {"kernel.bn_act": 2}
        for n in range(3):
            one = slice(n, n + 1)
            assert torch.equal(got[one], t_bn.bn_act_reference(
                x[one], w, b, m, v, eps, fold, act, r[one], g[one])), n


@pytest.mark.cuda
def test_bn_act_kernel_rejects_what_it_cannot_take(cuda):
    """bfloat16 buffers, more than 4096 channels, an input recording a
    gradient (x, or BN's weight outside inference mode): raised, nothing
    launched."""
    from streammos_tpu_torch.nn.blocks import BN

    x = torch.randn(2, 8, 4, 4, device=cuda)
    bn = BN(8).to(cuda).eval()
    before = profiling.counters()
    with torch.inference_mode():
        with pytest.raises(TypeError, match="float32"):
            t_bn.bn_act(x, bn.weight.bfloat16(), bn.bias, bn.running_mean,
                        bn.running_var, bn.eps)
        wide = BN(4100).to(cuda).eval()
        with pytest.raises(ValueError, match="4096"):
            wide(torch.randn(1, 4100, 2, 2, device=cuda))
    for t in (x.clone().requires_grad_(True), x):
        with pytest.raises(RuntimeError, match="no backward"):
            bn.act(t, "relu")
    assert _launched(before) == {}


@pytest.mark.cuda
def test_bn_act_graph_replay_reads_weights_written_in_place(cuda):
    """A CUDA graph of the epilogue, replayed after `running_var`,
    `running_mean` and `weight` are written in place (as `load_state_dict`
    writes them), applies the new values."""
    from streammos_tpu_torch.nn.blocks import BN

    bn = BN(16).to(cuda).eval()
    x = torch.randn(2, 16, 8, 8, device=cuda).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    with torch.inference_mode():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            bn.act(x, "relu")  # the build, outside the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = bn.act(x, "relu")
        graph.replay()
        first = y.clone()
    with torch.no_grad():
        bn.running_var.mul_(3.0)
        bn.running_mean.add_(0.25)
        bn.weight.add_(0.5)
    graph.replay()
    torch.cuda.synchronize()
    want = t_bn.bn_act_reference(x, bn.weight, bn.bias, bn.running_mean,
                                 bn.running_var, bn.eps, 0, "relu")
    assert torch.equal(y, want) and not torch.equal(y, first)
