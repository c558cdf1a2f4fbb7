"""The folded TTA gather's kernel arithmetic and its CPU path, on the CPU.

`csrc/grid_gather_tta.cu` reads each variant's taps straight from the
variant's own grid: it maps a canonical tap to the variant's cell (rev:
size-1-q, roll: (q + size/2) mod size, revroll: size-1-((q + size/2) mod
size)) and keeps or drops it by `_axis_weights`' validity. `_kernel_mirror`
repeats that arithmetic op for op in float32 torch, so a fault in the
mapping shows here before a chip run: it must equal the plain version
(`grid_to_point_tta_reference`, extended tables) bit for bit, since both
round each product and sum once, in the same order. The card tests hold
the kernel itself to the plain version (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

from streammos_tpu_torch.ops import tta_fold as t_tta
from streammos_tpu_torch.utils import profiling
from tests import gather_cases
from tests.test_torch_common import use_few_threads

use_few_threads()


def _cell(tr, size, q):
    half = size // 2
    if tr == "id":
        return q
    if tr == "rev":
        return size - 1 - q
    if tr == "roll":
        return (q + half) % size
    return size - 1 - (q + half) % size


def _taps(tr, size, x0, f):
    """(weight, cell) of the axis' two taps, as the kernel's `axis_taps`."""
    inb = (x0 >= 0) & (x0 <= size - 1)
    q0 = x0 - 1 if tr in ("rev", "revroll") else x0
    keep0 = {"id": inb, "rev": (x0 >= 1) & (x0 <= size), "roll": inb,
             "revroll": inb & (x0 != size // 2)}[tr]
    keep1 = {"id": (x0 >= -1) & (x0 <= size - 2), "rev": inb,
             "roll": inb & (x0 != size // 2 - 1), "revroll": inb}[tr]
    zero = torch.zeros_like(f)
    return ((torch.where(keep0, 1 - f, zero), _cell(tr, size, q0)),
            (torch.where(keep1, f, zero), _cell(tr, size, q0 + 1)))


def _kernel_mirror(grids, coords0, scale, kind):
    V, B, H, W, C = grids.shape
    py = coords0[..., 0] * float(np.float32(scale[0]))
    px = coords0[..., 1] * float(np.float32(scale[1]))
    fy, fx = torch.floor(py), torch.floor(px)
    guard = (fy >= -1) & (fy <= H) & (fx >= -1) & (fx <= W)
    y0 = torch.where(guard, fy, 0).to(torch.int64)
    x0 = torch.where(guard, fx, 0).to(torch.int64)
    b = torch.arange(B)[:, None]
    out = []
    for v, (ty, tx) in enumerate(t_tta._transforms(kind)):
        acc = torch.zeros(*py.shape, C)
        for wy, cy in _taps(ty, H, y0, py - fy):
            for wx, cx in _taps(tx, W, x0, px - fx):
                w = wy * wx
                val = grids[v][b, cy.clamp(0, H - 1), cx.clamp(0, W - 1)]
                val = torch.where((w != 0)[..., None], val, 0)
                acc = acc + val * w[..., None]
        out.append(torch.where(guard[..., None], acc, 0))
    return torch.stack(out, 2).reshape(B, -1, V * C)


@pytest.mark.parametrize("kind,hw", [("bev", (10, 12)), ("rv", (6, 16)),
                                     ("bev", (7, 9)), ("rv", (5, 15))])
def test_kernel_arithmetic_is_the_plain_version(kind, hw):
    H, W = hw
    rng = np.random.RandomState(11)
    grids = torch.from_numpy(rng.randn(4, 2, H, W, 8).astype(np.float32))
    scale = (0.5, 0.25)
    coords = torch.from_numpy(gather_cases.coords(rng, 2, 400, H, W, scale))
    want = t_tta.grid_to_point_tta_reference(grids, coords, scale, kind)
    got = _kernel_mirror(grids, coords, scale, kind)
    assert torch.equal(got, want)
    far = coords.abs().amax(-1) * 0.25 > 2 * max(H, W)
    assert far.sum() > 0 and not got[far].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_plain_version(dtype):
    rng = np.random.RandomState(12)
    grids = torch.from_numpy(rng.randn(4, 1, 8, 16, 16)).to(dtype)
    coords = torch.from_numpy(gather_cases.coords(rng, 1, 200, 8, 16,
                                                  (0.5, 0.5)))
    # a strided view, as the model hands over (NCHW conv outputs)
    grids = grids.permute(0, 1, 4, 2, 3).contiguous().permute(0, 1, 3, 4, 2)
    before = profiling.counters().get("kernel.grid_gather_tta", 0)
    got = t_tta.grid_to_point_tta(grids, coords, (0.5, 0.5), "rv")
    assert profiling.counters().get("kernel.grid_gather_tta", 0) == before
    want = t_tta.grid_to_point_tta_reference(grids, coords, (0.5, 0.5), "rv")
    assert got.dtype == dtype and torch.equal(got, want)


def test_rejects_what_no_path_takes():
    grids = torch.zeros(4, 1, 4, 8, 8)
    coords = torch.zeros(1, 5, 2)
    with pytest.raises(ValueError, match="variants|grids"):
        t_tta.grid_to_point_tta(grids[:3], coords, (1, 1), "bev")
    with pytest.raises(ValueError, match="coords0"):
        t_tta.grid_to_point_tta(grids, coords[..., :1], (1, 1), "bev")
    with pytest.raises(ValueError, match="kind"):
        t_tta.grid_to_point_tta(grids, coords, (1, 1), "xyz")
    with pytest.raises(ValueError, match="devices"):
        t_tta.grid_to_point_tta(grids.to("meta"), coords.to("meta"), (1, 1),
                                "bev")
