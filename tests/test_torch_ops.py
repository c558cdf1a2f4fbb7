"""The port's point<->grid ops against the JAX ops and the numpy refs.

Tolerances: scatter-max and the orientation permutations are exact (a max
does not depend on order, a permutation moves values); the bilinear
gathers, the resize and the deformable sampling are float32 sums taken in
another order, held to 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streammos_tpu.ops import deform_attn as j_deform
from streammos_tpu.ops import resize as j_resize
from streammos_tpu.ops import sample as j_sample
from streammos_tpu.ops import tta_fold as j_tta
from streammos_tpu.ops import voxel_pool as j_vp

from streammos_tpu_torch.ops import deform_attn as t_deform
from streammos_tpu_torch.ops import resize as t_resize
from streammos_tpu_torch.ops import sample as t_sample
from streammos_tpu_torch.ops import tta_fold as t_tta
from streammos_tpu_torch.ops import voxel_pool as t_vp
from tests import gather_cases
from tests.test_torch_common import use_few_threads

use_few_threads()

TOL = dict(rtol=1e-5, atol=1e-5)

# (phase_split, row_pad) layouts of `_cell_ids`
LAYOUTS = [(False, 0), (True, 0), (True, 1), ("outer", 0), ("outer", 1)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _points(rng, B=2, N=600, size=(16, 12), scale=(0.5, 0.5), nonneg=True,
            C=5):
    """Many points per cell (collisions), some outside the grid, some
    exactly on cell boundaries."""
    feat = rng.randn(B, N, C).astype(np.float32)
    if nonneg:
        feat = np.abs(feat)
    hi = np.array(size, np.float32) / np.array(scale, np.float32)
    inds = rng.uniform(-0.1, 1.1, (B, N, 2)).astype(np.float32) * hi
    inds[:, :40] = np.floor(inds[:, :40])  # integral coordinates
    return feat, inds


@pytest.mark.parametrize("layout", LAYOUTS)
def test_cell_ids_match_jax(layout):
    phase_split, row_pad = layout
    rng = np.random.RandomState(0)
    _, inds = _points(rng)
    jf, jv = j_vp._cell_ids(jnp.asarray(inds), (16, 12), (0.5, 0.5),
                            phase_split, row_pad)
    tf, tv, n = t_vp._cell_ids(_t(inds), (16, 12), (0.5, 0.5), phase_split,
                               row_pad)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert not np.asarray(jv).all()  # invalid ids are the cell count
    assert n == int(np.asarray(jf).max())


@pytest.mark.parametrize("nonneg", [True, False])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_voxel_max_pool_matches_jax(layout, nonneg):
    phase_split, row_pad = layout
    rng = np.random.RandomState(1)
    feat, inds = _points(rng, nonneg=nonneg)
    want = j_vp.voxel_max_pool(jnp.asarray(feat), jnp.asarray(inds), (16, 12),
                               (0.5, 0.5), "auto", nonneg, phase_split, row_pad)
    got = t_vp.voxel_max_pool(_t(feat), _t(inds), (16, 12), (0.5, 0.5),
                              nonneg, phase_split, row_pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("nonneg", [True, False])
def test_voxel_max_pool_matches_ref(nonneg):
    rng = np.random.RandomState(2)
    feat, inds = _points(rng, N=300, nonneg=nonneg)
    want = j_vp.voxel_max_pool_ref(feat, inds, (16, 12), (0.5, 0.5))
    got = t_vp.voxel_max_pool(_t(feat), _t(inds), (16, 12), (0.5, 0.5), nonneg)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        t_vp.voxel_max_pool_ref(feat, inds, (16, 12), (0.5, 0.5)), want)
    if not nonneg:  # occupied cells keep negative maxima
        assert (got.numpy() < 0).any()


def test_voxel_max_pool_3d():
    rng = np.random.RandomState(3)
    feat = rng.randn(1, 400, 3).astype(np.float32)
    inds = rng.uniform(-1, 9, (1, 400, 3)).astype(np.float32)
    want = j_vp.voxel_max_pool_ref(feat, inds, (8, 6, 4), (1.0, 0.75, 0.5))
    got = t_vp.voxel_max_pool(_t(feat), _t(inds), (8, 6, 4), (1.0, 0.75, 0.5))
    np.testing.assert_array_equal(got.numpy(), want)


def test_grid_to_point():
    rng = np.random.RandomState(4)
    grid = rng.randn(2, 9, 11, 6).astype(np.float32)
    coords = rng.uniform(-3, 25, (2, 200, 2)).astype(np.float32)
    coords[:, :20] = np.floor(coords[:, :20])
    want = j_sample.grid_to_point(jnp.asarray(grid), jnp.asarray(coords),
                                  (0.5, 0.5))
    got = t_sample.grid_to_point(_t(grid), _t(coords), (0.5, 0.5))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ref = t_sample.grid_to_point_ref(grid, coords, (0.5, 0.5))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_array_equal(ref, j_sample.grid_to_point_ref(
        grid, coords, (0.5, 0.5)))


@pytest.mark.parametrize("hw,out", [((4, 5), (9, 13)), ((8, 8), (8, 8)),
                                    ((1, 3), (4, 7))])
def test_resize_bilinear_align_corners(hw, out):
    rng = np.random.RandomState(5)
    x = rng.randn(2, *hw, 3).astype(np.float32)
    want = j_resize.resize_bilinear_align_corners(jnp.asarray(x), out)
    got = t_resize.resize_bilinear_align_corners(_t(x), out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(t_resize._interp_matrix(hw[0], out[0]),
                                  j_resize._interp_matrix(hw[0], out[0]))


def test_deform_attn_sample():
    rng = np.random.RandomState(6)
    B, H, W, M, Dh, Lq, P = 2, 6, 7, 3, 4, 10, 4
    value = rng.randn(B, H, W, M, Dh).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, (B, Lq, M, P, 2)).astype(np.float32)
    w = rng.uniform(0, 1, (B, Lq, M, P)).astype(np.float32)
    want = j_deform.deform_attn_sample(jnp.asarray(value), jnp.asarray(loc),
                                       jnp.asarray(w))
    got = t_deform.deform_attn_sample(_t(value), _t(loc), _t(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ref = t_deform.deform_attn_sample_ref(value, loc, w)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_array_equal(ref, j_deform.deform_attn_sample_ref(value, loc, w))


@pytest.mark.parametrize("kind", ["bev", "rv"])
@pytest.mark.parametrize("v", range(4))
def test_orient_grid(kind, v):
    rng = np.random.RandomState(7)
    grid = rng.randn(2, 6, 10, 3).astype(np.float32)
    want = j_tta.orient_grid(jnp.asarray(grid), v, kind, (1, 2))
    got = t_tta.orient_grid(_t(grid), v, kind, (1, 2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind,size", [("bev", (16, 12)), ("rv", (8, 16))])
def test_voxel_max_pool_tta(kind, size):
    rng = np.random.RandomState(8)
    feat, inds = _points(rng, size=size, C=4 * 3)
    want = j_tta.voxel_max_pool_tta(jnp.asarray(feat), jnp.asarray(inds),
                                    size, (0.5, 0.5), kind, nonneg=True)
    got = t_tta.voxel_max_pool_tta(_t(feat), _t(inds), size, (0.5, 0.5),
                                   kind, nonneg=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind,hw", [("bev", (10, 12)), ("rv", (6, 16))])
def test_grid_to_point_tta(kind, hw):
    H, W = hw
    rng = np.random.RandomState(9)
    grids = rng.randn(4, 2, H, W, 3).astype(np.float32)
    scale = (0.5, 0.5)
    px = rng.uniform(-2, W + 2, (2, 300)).astype(np.float32)
    py = rng.uniform(-2, H + 2, (2, 300)).astype(np.float32)
    # the rolled RV axes' wrap seams: x0 == W/2 and x0 == W/2 - 1
    px[:, :8] = W // 2 + rng.uniform(0.05, 0.95, 8)
    px[:, 8:16] = W // 2 - 1 + rng.uniform(0.05, 0.95, 8)
    px[:, 16:20] = [0.0, W - 1.0, W / 2, W / 2 - 1]
    coords = np.stack([py / scale[0], px / scale[1]], -1).astype(np.float32)
    want = j_tta.grid_to_point_tta(jnp.asarray(grids), jnp.asarray(coords),
                                   scale, kind)
    got = t_tta.grid_to_point_tta(_t(grids), _t(coords), scale, kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind,hw", [("bev", (10, 12)), ("rv", (6, 16))])
def test_grid_to_point_tta_far_outside(kind, hw):
    """Points far outside the grid (+-1e4: the clamp moves the window and the
    guard must zero the row), on one axis or both, beside the seams, edges
    and integers of `tests/gather_cases.py`."""
    H, W = hw
    rng = np.random.RandomState(10)
    grids = rng.randn(4, 2, H, W, 3).astype(np.float32)
    scale = (0.5, 0.5)
    coords = gather_cases.coords(rng, 2, 300, H, W, scale)
    far = np.abs(coords).max(-1) >= gather_cases.FAR
    want = j_tta.grid_to_point_tta(jnp.asarray(grids), jnp.asarray(coords),
                                   scale, kind)
    got = t_tta.grid_to_point_tta(_t(grids), _t(coords), scale, kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert far.sum() == 2 * 12 and not got.numpy()[far].any()
