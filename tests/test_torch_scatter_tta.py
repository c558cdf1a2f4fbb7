"""The folded TTA scatter's kernel arithmetic and its CPU path, on the CPU.

`csrc/scatter_tta.cu` computes each point's cell from its float32
coordinates (the product rounded to float32, truncated toward zero, kept
iff inside the grid) and maxes each variant's channels straight into the
layout the next consumer reads: the variant's own grid at the cell its
orientation maps the point's to (rev: size-1-c, roll: (c + size/2) mod
size, revroll: (size/2 - 1 - c) mod size), or the whole row at the
canonical cell of the fused header's phase-outer, row-padded grid.
`_kernel_mirror` repeats that index arithmetic in numpy, so a fault in the
mapping shows here before a chip run. It must equal the plain version
(`voxel_max_pool_tta_reference`, which the CPU path runs) exactly, and
both must equal the composition the plain version stands for:
`voxel_max_pool`, then `orient_grid` and `torch.stack` of the variants,
or `voxel_max_pool(..., phase_split="outer", row_pad=1)`. The card tests
hold the kernel itself to the plain version (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

from streammos_tpu_torch.config import get_config
from streammos_tpu_torch.models.stream_mos import featurize, tta_expand_folded
from streammos_tpu_torch.ops import tta_fold as t_tta
from streammos_tpu_torch.ops.voxel_pool import voxel_max_pool
from streammos_tpu_torch.utils import profiling
from tests import scatter_cases
from tests.test_torch_common import use_few_threads

use_few_threads()

LAYOUTS = ("variants", "phase_outer")
# each variant's (row, column) transform, as the kernel's `transforms`
TRANSFORMS = {
    "bev": [("rev" if v >> 1 else "id", "rev" if v & 1 else "id")
            for v in range(4)],
    "rv": [("id", t) for t in ("id", "revroll", "rev", "roll")]}


def _orient(tr, c, size):
    """The variant's cell of canonical cells c, as the kernel's `orient`."""
    half = size // 2
    if tr == "id":
        return c
    if tr == "rev":
        return size - 1 - c
    if tr == "roll":
        return np.where(c < half, c + half, c - half)
    return np.where(c < half, half - 1 - c, size + half - 1 - c)


def _kernel_mirror(feat, coords, out_size, scale, kind, layout):
    """The kernel's output, in numpy: feat (B, N, 4C) >= 0, coords (B, N,
    >= 2) float32."""
    B, N, VC = feat.shape
    C, (H, W) = VC // 4, out_size
    r = np.trunc(coords[..., 0].astype(np.float32) * np.float32(scale[0]))
    q = np.trunc(coords[..., 1].astype(np.float32) * np.float32(scale[1]))
    b, n = np.nonzero((r >= 0) & (r < H) & (q >= 0) & (q < W))
    r, q, rows = r[b, n].astype(np.int64), q[b, n].astype(np.int64), feat[b, n]
    if layout == "phase_outer":
        out = np.zeros((B, 4, H // 2 + 2, W // 2, VC), feat.dtype)
        np.maximum.at(out, (b, 2 * (r & 1) + (q & 1), (r >> 1) + 1, q >> 1),
                      rows)
        return out
    out = np.zeros((4, B, H, W, C), feat.dtype)
    for v, (tr, tq) in enumerate(TRANSFORMS[kind]):
        np.maximum.at(out, (v, b, _orient(tr, r, H), _orient(tq, q, W)),
                      rows[:, v * C:(v + 1) * C])
    return out


def _composition(feat, coords, out_size, scale, kind, layout):
    """The port's path before the kernel: `voxel_max_pool` over the
    variant-0 cells, then each variant's grid oriented and the four
    stacked, or the phase-outer layout straight."""
    if layout == "phase_outer":
        return voxel_max_pool(feat, coords[..., :2], out_size, scale, True,
                              phase_split="outer", row_pad=1)
    B, N, VC = feat.shape
    grid = voxel_max_pool(feat, coords[..., :2], out_size, scale, True)
    grid = grid.reshape(B, *out_size, 4, VC // 4)
    return torch.stack([t_tta.orient_grid(grid[..., v, :], v, kind, (1, 2))
                        for v in range(4)])


def _check(feat, coords, out_size, scale, kind, layout):
    """Plain version == composition == mirror; the CPU path is the plain
    version and launches no kernel."""
    before = profiling.counters().get("kernel.scatter_tta", 0)
    got = t_tta.voxel_max_pool_tta(feat, coords, out_size, scale, kind,
                                   nonneg=True, layout=layout)
    assert profiling.counters().get("kernel.scatter_tta", 0) == before
    plain = t_tta.voxel_max_pool_tta_reference(feat, coords, out_size, scale,
                                               kind, True, layout)
    assert torch.equal(got, plain)
    assert torch.equal(plain, _composition(feat, coords, out_size, scale,
                                           kind, layout))
    want = _kernel_mirror(feat.float().numpy(), coords.numpy(), out_size,
                          scale, kind, layout)
    np.testing.assert_array_equal(plain.float().numpy(), want)
    return plain


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind", ["bev", "rv"])
@pytest.mark.parametrize("case", scatter_cases.KINDS)
def test_plain_version_on_the_scatter_cases(case, kind, layout):
    """The id distributions that stress the scatter kernels
    (tests/scatter_cases.py: one cell, a cell a row, runs ending on block
    boundaries, a 10^5-cell gap, all invalid), as cells of a grid 64 cells
    wide, two batches, each variant's channels of its own values."""
    rng = np.random.default_rng(scatter_cases.KINDS.index(case))
    P, C, W, scale = 1500, 4, 64, (0.5, 0.5)
    ids, n_cells = scatter_cases.scatter_case(case, rng, 2 * P)
    coords, H = scatter_cases.case_coords(ids, n_cells, W, scale)
    rows = scatter_cases.scatter_rows(rng, ids, 4 * C, False)
    feat = torch.from_numpy(rows.reshape(2, P, 4 * C))
    got = _check(feat, torch.from_numpy(coords.reshape(2, P, 2)), (H, W),
                 scale, kind, layout)
    if case == "sentinel":
        assert not got.any()


def _scan_coords(seed, T=3, N=3000):
    """(bev, rv) coordinates of `featurize(tta_expand_folded(xyzi))` at
    StreamMOS_tiny's grids, for points spread over the BEV range, a tenth
    of them on its edges or just outside them, a tenth far outside."""
    cfg = get_config("StreamMOS_tiny").model
    (x0, x1), (y0, y1) = cfg.voxel.range_x, cfg.voxel.range_y
    rng = np.random.default_rng(seed)
    x = rng.uniform(x0, x1, (1, T, N))
    y = rng.uniform(y0, y1, (1, T, N))
    edge = np.array([x0, x1, np.nextafter(np.float32(x0), -np.inf),
                     np.nextafter(np.float32(x1), -np.inf), x1 + 1e-3, 0.0])
    k = N // 10
    x[..., :k] = rng.choice(edge, (1, T, k))
    y[..., k:2 * k] = rng.choice(edge, (1, T, k))
    x[..., 2 * k:3 * k] = rng.choice([-1.0, 1.0], (1, T, k)) * rng.uniform(
        x1 + 1, 4 * x1, (1, T, k))
    z = rng.uniform(-3.0, 1.5, (1, T, N))
    i = rng.uniform(0, 1, (1, T, N))
    xyzi = torch.from_numpy(np.stack([x, y, z, i], -1).astype(np.float32))
    batch = featurize(tta_expand_folded(xyzi), cfg)
    return cfg, batch["bev_coord"], batch["rv_coord"]


# the five scatter sites of a folded frame: (name, kind, layout, grid
# divisor, scale)
SITES = [("bev_full", "bev", "phase_outer", 1, (1.0, 1.0)),
         ("rv0", "rv", "variants", 2, (0.5, 0.5)),
         ("bev0", "bev", "variants", 2, (0.5, 0.5)),
         ("rv1", "rv", "variants", 4, (0.25, 0.25)),
         ("bev1", "bev", "variants", 4, (0.25, 0.25))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", SITES, ids=[s[0] for s in SITES])
def test_plain_version_at_the_sites_of_a_frame(site, dtype):
    """Coordinates from `featurize(tta_expand_folded(...))` as the model
    hands them over (strided views of the folded coordinates), with points
    on the grid's edges and outside it; the full grid takes every frame."""
    name, kind, layout, div, scale = site
    cfg, bev, rv = _scan_coords(SITES.index(site))
    T, N = bev.shape[1], bev.shape[2]
    if name == "bev_full":
        coords = bev[..., 0, :].reshape(T, N, 3)
        size = cfg.voxel.bev_wl
    else:
        coords = (bev[:, 0, :, 0, :2] if kind == "bev" else rv[:, 0, :, 0])
        full = cfg.voxel.bev_wl if kind == "bev" else cfg.voxel.rv_shape
        size = (full[0] // div, full[1] // div)
    gen = torch.Generator().manual_seed(SITES.index(site))
    feat = torch.relu(torch.randn(coords.shape[0], N, 4 * 8, generator=gen))
    feat = feat.to(dtype)
    r = coords[..., 0] * scale[0]
    q = coords[..., 1] * scale[1]
    inside = (r >= 0) & (r < size[0]) & (q >= 0) & (q < size[1])
    assert 0 < int(inside.sum()) < inside.numel()  # points dropped, and kept
    got = _check(feat, coords, size, scale, kind, layout)
    if layout == "phase_outer":
        assert not got[:, :, 0].any() and not got[:, :, -1].any()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_cpu_path_keeps_negative_maxima(layout):
    """Without nonneg the CPU path is `voxel_max_pool`'s: an occupied
    cell takes only its points' max, negative or not."""
    feat = -torch.rand(1, 6, 8) - 0.5
    coords = torch.tensor([[[0.5, 0.5], [0.5, 0.7], [1.5, 2.5], [3.5, 3.5],
                            [9.0, 0.5], [-2.0, 1.0]]])
    got = t_tta.voxel_max_pool_tta(feat, coords, (4, 4), (1.0, 1.0), "bev",
                                   layout=layout)
    assert torch.equal(got, t_tta.voxel_max_pool_tta_reference(
        feat, coords, (4, 4), (1.0, 1.0), "bev", False, layout))
    assert (got < 0).sum() == 3 * 8


def test_wrapper_rejects_what_no_path_takes():
    feat, coords = torch.rand(1, 5, 8), torch.rand(1, 5, 2)
    call = lambda f, c, **k: t_tta.voxel_max_pool_tta(
        f, c, (4, 4), (1.0, 1.0), k.pop("kind", "bev"), True, **k)
    with pytest.raises(ValueError, match="layout"):
        call(feat, coords, layout="phase_inner")
    with pytest.raises(ValueError, match="kind"):
        call(feat, coords, kind="xy")
    with pytest.raises(ValueError, match="feat"):
        call(feat[..., :6], coords)
    with pytest.raises(ValueError, match="coords0"):
        call(feat, coords[:, :4])
    with pytest.raises(ValueError, match="coords0"):
        call(feat, coords[..., :1])
