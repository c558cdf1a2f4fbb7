"""The port's scatter kernels' plain versions and `voxel_max_pool`'s `impl`
dispatch and backward, against the JAX package on the CPU.

On CPU tensors the port runs each kernel's plain version
(`sorted_scatter_max_reference`, `scatter_max_vmem_reference`); the CUDA
kernels themselves are held against those in `tests/test_torch_cuda.py`.
JAX's `scatter_max_vmem` runs in Pallas interpret mode here. JAX's
`sorted_scatter_max` has no interpret mode and cannot run on the CPU, so the
sorted scatter is held against JAX `voxel_max_pool(impl="xla")` and
`voxel_max_pool_ref`, which compute the same function.

Tolerances: forward results are exact (a max does not depend on order).
Gradients are exact too in structure (every point equal to its cell's max
gets the cell's full gradient); they are compared at rtol = atol = 1e-6 in
float32.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streammos_tpu.ops import pallas_scatter_vmem as j_vmem
from streammos_tpu.ops import voxel_pool as j_vp

from streammos_tpu_torch.ops import pallas_scatter as t_sorted
from streammos_tpu_torch.ops import pallas_scatter_vmem as t_vmem
from streammos_tpu_torch.ops import voxel_pool as t_vp
from tests.scatter_cases import (KINDS, VMEM_KINDS, scatter_case,
                                 scatter_rows, sort_by_id)
from tests.test_torch_common import use_few_threads

use_few_threads()

# (phase_split, row_pad) layouts of `_cell_ids`
LAYOUTS = [(False, 0), (True, 0), (True, 1), ("outer", 0), ("outer", 1)]
IMPLS = ["auto", "xla", "pallas", "vmem"]
# every impl x layout x nonneg the op takes ("vmem" needs nonneg)
CASES = [(impl, layout, nonneg) for impl in IMPLS for layout in LAYOUTS
         for nonneg in (True, False) if nonneg or impl != "vmem"]
GRID, SCALE = (16, 12), (0.5, 0.5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16(a):
    """float32 numpy values that bfloat16 holds exactly."""
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _points(rng, B=2, N=600, C=128, nonneg=True, levels=None):
    """Many points per cell, some outside the grid, some exactly on cell
    boundaries. levels: draw values from that many levels, so cells hold
    ties."""
    if levels:
        feat = rng.randint(0, levels, (B, N, C)).astype(np.float32) - (
            0 if nonneg else levels // 2)
    else:
        feat = rng.randn(B, N, C).astype(np.float32)
        if nonneg:
            feat = np.abs(feat)
    hi = np.array(GRID, np.float32) / np.array(SCALE, np.float32)
    inds = rng.uniform(-0.1, 1.1, (B, N, 2)).astype(np.float32) * hi
    inds[:, :40] = np.floor(inds[:, :40])  # integral coordinates
    return feat, inds


def _vmem_ref(feat, ids, cells):
    B, N, C = feat.shape
    out = np.zeros((B, cells, C), feat.dtype)
    for b in range(B):
        for n in range(N):
            if 0 <= ids[b, n] < cells:
                out[b, ids[b, n]] = np.maximum(out[b, ids[b, n]], feat[b, n])
    return out


# --- the K-copy scatter (impl="vmem") -------------------------------------

@pytest.mark.parametrize("B,N,cells,C,dtype,signed_ids", [
    (1, 3000, 640, 128, "float32", False),   # N not a multiple of the block
    (2, 2048, 1000, 256, "float32", False),  # cells not a multiple of 8
    (1, 2048, 512, 128, "bfloat16", False),
    (2, 2048, 1000, 128, "float32", True),   # ids out of range, either sign
    (1, 2048, 512, 128, "bfloat16", True),
])
def test_scatter_max_vmem_matches_jax(B, N, cells, C, dtype, signed_ids):
    rng = np.random.default_rng(3)
    feat = rng.uniform(0, 5, (B, N, C)).astype(np.float32)
    lo, hi = (-cells, 2 * cells) if signed_ids else (0, cells + 1)
    ids = rng.integers(lo, hi, (B, N)).astype(np.int32)
    if dtype == "bfloat16":
        feat = _bf16(feat)
    jfeat = jnp.asarray(feat).astype(getattr(jnp, dtype))
    want = np.asarray(j_vmem.scatter_max_vmem(jfeat, jnp.asarray(ids), cells,
                                              True).astype(jnp.float32))
    got = t_vmem.scatter_max_vmem(_t(feat).to(getattr(torch, dtype)), _t(ids),
                                  cells)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(want, _vmem_ref(feat, ids, cells))


@pytest.mark.parametrize("cells,C", [
    (256 * 256, 128), (32 * 1024, 128), (128 * 128, 256), (16 * 512, 256),
    (4 * 258 * 256, 256),  # the full-res header grid, phase-outer, row-padded
    (1024, 96)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_fits_vmem_matches_jax(cells, C, itemsize):
    pad = -(-(cells + 1) // 8) * 8
    assert t_vmem._num_copies(pad, C, itemsize) == j_vmem._num_copies(
        pad, C, itemsize)
    assert t_vmem.fits_vmem(cells, C, itemsize) == j_vmem.fits_vmem(
        cells, C, itemsize)


def test_fits_vmem_gate():
    """The four cascade shapes pass in bf16; the full-res header grid and a
    width that is not a multiple of 128 fail, in both packages."""
    for cells, C in [(256 * 256, 128), (32 * 1024, 128), (128 * 128, 256),
                     (16 * 512, 256)]:
        assert t_vmem.fits_vmem(cells, C, 2)
    assert not t_vmem.fits_vmem(4 * 258 * 256, 256, 2)
    assert not t_vmem.fits_vmem(1024, 96, 2)
    with pytest.raises(ValueError):
        t_vmem.scatter_max_vmem(torch.zeros(1, 8, 96), torch.zeros(
            1, 8, dtype=torch.int32), 1024)


# --- the sorted scatter (impl="pallas") -----------------------------------

@pytest.mark.parametrize("n_cells", [1024, 2048, 1000, 1537, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_max_pallas_matches_jax(n_cells, dtype):
    """Negative values (negative maxima are kept), the sentinel id, cells
    with many rows and empty cells; cell counts that are and are not
    multiples of JAX's 1024-cell tile."""
    rng = np.random.default_rng(n_cells)
    R, C = 3000, 6
    feat = _bf16(rng.normal(size=(R, C)).astype(np.float32))
    ids = rng.integers(0, n_cells + 1, R).astype(np.int32)
    ids[: R // 10] = n_cells  # invalid rows
    ids[R // 10: R // 5] = 0  # one crowded cell
    ids[ids == n_cells - 1] = n_cells  # the last cell stays empty
    feat[ids == 1] = -np.abs(feat[ids == 1])  # a negative maximum
    # the same cells as 1-D grid coordinates: cell + 0.5, the sentinel off
    # the grid
    inds = (ids.astype(np.float32) + 0.5)[None, :, None]
    jdt = getattr(jnp, dtype)
    want = np.asarray(j_vp.voxel_max_pool(
        jnp.asarray(feat[None]).astype(jdt), jnp.asarray(inds), (n_cells,),
        (1.0,), "xla").astype(jnp.float32))[0]
    np.testing.assert_array_equal(
        want, j_vp.voxel_max_pool_ref(feat[None], inds, (n_cells,), (1.0,))[0])
    assert (want < 0).any() and (want == 0).all(-1).any()

    tdt = getattr(torch, dtype)
    got = t_sorted.scatter_max_pallas(_t(feat).to(tdt), _t(ids), n_cells)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)
    order = np.argsort(ids, kind="stable")
    direct = t_sorted.sorted_scatter_max(_t(feat[order]).to(tdt),
                                         _t(ids[order]), n_cells)
    np.testing.assert_array_equal(direct.float().numpy(), want)


def test_sorted_scatter_reference_drops_out_of_range_ids():
    feats = torch.tensor([[-4.0], [-1.0], [-2.0], [7.0], [9.0]])
    ids = torch.tensor([-3, 1, 1, 3, 4], dtype=torch.int32)
    got = t_sorted.sorted_scatter_max_reference(feats, ids, 3)
    assert got.flatten().tolist() == [0.0, -1.0, 0.0]


# --- the id distributions that stress the kernels ------------------------

ADV_ROWS = 2048  # 32 chunks of the sorted kernel's 64 rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_sorted_scatter_adversarial_matches_jax(kind, dtype):
    """`tests/scatter_cases.py`'s distributions, rows signed (every even
    cell's maximum negative): the port's sorted scatter (front end and
    sorted entry) equals JAX `voxel_max_pool(impl="xla")` on the same cells
    as 1-D grid coordinates, and `voxel_max_pool_ref`."""
    rng = np.random.default_rng(KINDS.index(kind))
    ids, n_cells = scatter_case(kind, rng, ADV_ROWS)
    feat = scatter_rows(rng, ids, 6, signed=True)
    inds = (ids.astype(np.float32) + 0.5)[None, :, None]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(j_vp.voxel_max_pool(
        jnp.asarray(feat[None]).astype(jdt), jnp.asarray(inds), (n_cells,),
        (1.0,), "xla").astype(jnp.float32))[0]
    np.testing.assert_array_equal(
        want, j_vp.voxel_max_pool_ref(feat[None], inds, (n_cells,), (1.0,))[0])
    assert (want[-1] == 0).all()
    if kind != "sentinel":
        assert (want < 0).any()

    got = t_sorted.scatter_max_pallas(_t(feat).to(tdt), _t(ids), n_cells)
    np.testing.assert_array_equal(got.float().numpy(), want)
    sids, srows = sort_by_id(ids, feat)
    direct = t_sorted.sorted_scatter_max(_t(srows).to(tdt), _t(sids), n_cells)
    np.testing.assert_array_equal(direct.float().numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sorted_scatter_one_cell_grid_matches_jax(dtype):
    """A grid of one cell: negative rows in it, the rest sentinel rows (the
    sentinel id is 1 here); the cell keeps its negative maximum, as JAX's."""
    rng = np.random.default_rng(7)
    ids = np.where(rng.uniform(size=ADV_ROWS) < 0.5, 0, 1).astype(np.int32)
    feat = -scatter_rows(rng, ids, 6, signed=False) - 1 / 64
    inds = (ids.astype(np.float32) + 0.5)[None, :, None]
    want = np.asarray(j_vp.voxel_max_pool(
        jnp.asarray(feat[None]).astype(getattr(jnp, dtype)), jnp.asarray(inds),
        (1,), (1.0,), "xla").astype(jnp.float32))[0]
    assert want.shape == (1, 6) and (want < 0).all()
    tdt = getattr(torch, dtype)
    got = t_sorted.scatter_max_pallas(_t(feat).to(tdt), _t(ids), 1)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", VMEM_KINDS)
def test_scatter_max_vmem_adversarial_matches_jax(kind, dtype):
    """The same distributions, non-negative rows, two batches (the batch's
    offset is in the address), each batch its own permutation: the port's
    plain version equals JAX's `scatter_max_vmem` in interpret mode."""
    rng = np.random.default_rng(10 + KINDS.index(kind))
    ids, cells = scatter_case(kind, rng, ADV_ROWS)
    ids = np.stack([ids, rng.permutation(ids)])
    feat = np.stack([scatter_rows(rng, ids[b], 128, signed=False)
                     for b in range(2)])
    jfeat = jnp.asarray(feat).astype(getattr(jnp, dtype))
    want = np.asarray(j_vmem.scatter_max_vmem(jfeat, jnp.asarray(ids), cells,
                                              True).astype(jnp.float32))
    got = t_vmem.scatter_max_vmem(_t(feat).to(getattr(torch, dtype)), _t(ids),
                                  cells)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert (want[:, -1] == 0).all()


# --- voxel_max_pool: impl dispatch ----------------------------------------

@pytest.mark.parametrize("impl,layout,nonneg", CASES)
def test_voxel_max_pool_impl_matches_jax(impl, layout, nonneg):
    phase_split, row_pad = layout
    rng = np.random.RandomState(1)
    feat, inds = _points(rng, nonneg=nonneg)
    want = j_vp.voxel_max_pool(jnp.asarray(feat), jnp.asarray(inds), GRID,
                               SCALE, "xla", nonneg, phase_split, row_pad)
    got = t_vp.voxel_max_pool(_t(feat), _t(inds), GRID, SCALE, nonneg,
                              phase_split, row_pad, impl=impl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if not nonneg:
        assert (got.numpy() < 0).any()


def test_voxel_max_pool_matches_ref_every_impl():
    rng = np.random.RandomState(2)
    feat, inds = _points(rng, N=300)
    want = j_vp.voxel_max_pool_ref(feat, inds, GRID, SCALE)
    for impl in IMPLS:
        got = t_vp.voxel_max_pool(_t(feat), _t(inds), GRID, SCALE, True,
                                  impl=impl)
        np.testing.assert_array_equal(got.numpy(), want)


def test_voxel_max_pool_rejects():
    rng = np.random.RandomState(3)
    feat, inds = _points(rng, N=50)
    with pytest.raises(ValueError, match="nonneg"):
        t_vp.voxel_max_pool(_t(feat), _t(inds), GRID, SCALE, False,
                            impl="vmem")
    with pytest.raises(ValueError, match="fits_vmem"):
        t_vp.voxel_max_pool(_t(feat[..., :96]), _t(inds), GRID, SCALE, True,
                            impl="vmem")
    with pytest.raises(ValueError, match="impl"):
        t_vp.voxel_max_pool(_t(feat), _t(inds), GRID, SCALE, impl="sorted")


# --- voxel_max_pool: backward ---------------------------------------------

def test_backward_ties_get_the_full_gradient():
    """tests/test_voxel_pool.py's tie case, and torch's own split of a tied
    gradient ([0, .5, .5, 1]) is not what the op does."""
    feat = np.repeat(np.array([[[2.0], [2.0], [1.0]]], np.float32), 128, -1)
    inds = np.array([[[0.1, 0.1], [0.4, 0.2], [0.2, 0.3]]], np.float32)
    for impl in IMPLS:
        x = _t(feat).requires_grad_()
        t_vp.voxel_max_pool(x, _t(inds), (2, 2), (1.0, 1.0), True,
                            impl=impl).sum().backward()
        np.testing.assert_array_equal(x.grad[0].numpy(),
                                      np.repeat([[1.0], [1.0], [0.0]], 128, -1))
    x = torch.tensor([[[1.0], [3.0], [3.0], [2.0]]], requires_grad=True)
    inds = torch.tensor([[[0.1, 0.1], [0.2, 0.3], [0.5, 0.5], [1.2, 0.1]]])
    t_vp.voxel_max_pool(x, inds, (2, 2), (1.0, 1.0)).sum().backward()
    assert x.grad.flatten().tolist() == [0.0, 1.0, 1.0, 1.0]


@functools.lru_cache(maxsize=None)
def _jax_grad(layout, nonneg, levels):
    phase_split, row_pad = layout
    feat, inds = _points(np.random.RandomState(4), nonneg=nonneg,
                         levels=levels, C=128)
    out_shape = j_vp.voxel_max_pool(jnp.asarray(feat), jnp.asarray(inds), GRID,
                                    SCALE, "xla", nonneg, phase_split,
                                    row_pad).shape
    cot = np.random.RandomState(5).randn(*out_shape).astype(np.float32)

    def loss(x):
        out = j_vp.voxel_max_pool(x, jnp.asarray(inds), GRID, SCALE, "xla",
                                  nonneg, phase_split, row_pad)
        return (out * jnp.asarray(cot)).sum()

    return feat, inds, cot, np.asarray(jax.grad(loss)(jnp.asarray(feat)))


@pytest.mark.parametrize("levels", [None, 3])
@pytest.mark.parametrize("impl,layout,nonneg", CASES)
def test_backward_matches_jax(impl, layout, nonneg, levels):
    """Random cotangents, with random values (levels=None) and with values
    from three levels, so most cells hold ties and, with nonneg, zeros."""
    phase_split, row_pad = layout
    feat, inds, cot, want = _jax_grad(layout, nonneg, levels)
    x = _t(feat).requires_grad_()
    out = t_vp.voxel_max_pool(x, _t(inds), GRID, SCALE, nonneg, phase_split,
                              row_pad, impl=impl)
    (out * _t(cot)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-6, atol=1e-6)
    if levels:  # more points than occupied cells got a gradient: ties
        flat, valid, _ = t_vp._cell_ids(_t(inds), GRID, SCALE, phase_split,
                                        row_pad)
        occupied = sum(len(torch.unique(f[v])) for f, v in zip(flat, valid))
        assert np.count_nonzero(want[..., 0]) > occupied
