"""The port's native loader (`streammos_tpu_torch/native`) against the JAX
package's numpy path, bit for bit, on a synthetic SemanticKITTI tree; its
build directory; and no silent fall-back when the build fails."""
import dataclasses
import os

import numpy as np
import pytest

from streammos_tpu import geometry as jax_geometry
from streammos_tpu_torch import native
from streammos_tpu_torch import host_geometry
from streammos_tpu_torch.config import get_config
from streammos_tpu_torch.data.dataset import EvalDataset
from streammos_tpu_torch.native import api as native_api
from streammos_tpu_torch.native import build as native_build
from tests.synthetic_kitti import make_sequence

LIMS = (-20, 20, -20, 20, -4, 2)


@pytest.fixture(scope="module")
def seq_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_native_kitti")
    make_sequence(str(root), "00", n_frames=4, n_points=2000)
    return str(root / "00")


def _rotation(deg: float, t=(2.0, -1.0, 0.5)) -> np.ndarray:
    c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
    return np.array([[c, -s, 0, t[0]], [s, c, 0, t[1]], [0, 0, 1, t[2]],
                     [0, 0, 0, 1.0]])


def test_build_lands_under_build_dir():
    path = native_build.build()
    assert path.exists()
    assert path.parent == native_build.BUILD_DIR
    assert native_build.BUILD_DIR.parts[-2:] == ("build", "native")
    assert native_build.SOURCE.parent not in path.parents


def test_load_scan_and_labels_match_numpy(seq_dir):
    path = f"{seq_dir}/velodyne/000000.bin"
    a = native.load_scan(path)
    assert a.dtype == np.float32 and a.shape == (2000, 4)
    np.testing.assert_array_equal(
        a, np.fromfile(path, dtype=np.float32).reshape(-1, 4))
    path = f"{seq_dir}/labels/000000.label"
    np.testing.assert_array_equal(native.load_labels(path),
                                  np.fromfile(path, dtype=np.uint32))
    with pytest.raises(OSError):
        native.load_scan(f"{seq_dir}/velodyne/999999.bin")


@pytest.mark.parametrize("deg", [0.0, 30.0, -117.5])
def test_transform_matches_numpy(seq_dir, deg):
    """float64 arithmetic rounded to float32 on both sides: equal up to
    the last float32 place (the dot product's order differs)."""
    pts = native.load_scan(f"{seq_dir}/velodyne/000001.bin")
    mat = _rotation(deg)
    got = native.transform(pts, mat)
    want = jax_geometry.np_transform(pts, mat).astype(np.float32)
    np.testing.assert_array_equal(
        host_geometry.np_transform(pts, mat).astype(np.float32), want)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    if deg == 0.0:  # a pure translation is exact both ways
        np.testing.assert_array_equal(got, want)


def test_filter_matches_numpy(seq_dir):
    pts = native.load_scan(f"{seq_dir}/velodyne/000000.bin")
    kept, mask = native.filter_points(pts, LIMS)
    ref = jax_geometry.np_filter_mask(pts, (-20, 20), (-20, 20), (-4, 2))
    np.testing.assert_array_equal(
        host_geometry.np_filter_mask(pts, (-20, 20), (-20, 20), (-4, 2)), ref)
    np.testing.assert_array_equal(mask, ref)
    np.testing.assert_array_equal(kept, pts[ref])


def test_resample_distribution():
    idx = native.resample_indices(1000, 50000, seed=7)
    assert idx.min() >= 0 and idx.max() < 1000
    counts = np.bincount(idx, minlength=1000)
    assert counts.mean() == 50.0
    assert counts.std() < 25
    np.testing.assert_array_equal(idx, native.resample_indices(1000, 50000, 7))
    assert not np.array_equal(idx, native.resample_indices(1000, 50000, 8))


def test_assemble_eval_frame_matches_numpy(seq_dir):
    path = f"{seq_dir}/velodyne/000002.bin"
    frame, n_valid, mask = native.assemble_eval_frame(path, np.eye(4), LIMS,
                                                      4096)
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    ref_mask = jax_geometry.np_filter_mask(raw, (-20, 20), (-20, 20), (-4, 2))
    want = np.full((4096, 4), -1000.0, np.float32)
    want[:ref_mask.sum()] = raw[ref_mask]
    want[ref_mask.sum():, 2] = -4000.0
    assert n_valid == ref_mask.sum() and mask.shape[0] == raw.shape[0]
    np.testing.assert_array_equal(mask, ref_mask)
    np.testing.assert_array_equal(frame, want)
    with pytest.raises(ValueError, match="frame_point_num"):
        native.assemble_eval_frame(path, np.eye(4), LIMS, 16)


def test_broken_source_raises(tmp_path, monkeypatch, seq_dir):
    """A build that fails raises, directly and through a dataset on the
    native path; nothing falls back to numpy."""
    broken = tmp_path / "loader.cpp"
    broken.write_text("extern \"C\" int smt_load_scan( {\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ exit"):
        native_build.build(broken)
    assert not native_build.library_path(broken).exists()

    cfg = dataclasses.replace(get_config("StreamMOS_tiny").val,
                              seq_dir=os.path.dirname(seq_dir),
                              frame_point_num=4096)
    monkeypatch.setattr(native_build, "SOURCE", broken)
    native_api._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="native loader"):
            EvalDataset(cfg, seq_ids=[0])[0]
        # the numpy path runs only when asked for
        sample = EvalDataset(cfg, seq_ids=[0], native=False)[0]
        assert sample["xyzi"].shape == (3, cfg.frame_point_num, 4)
    finally:
        native_api._lib.cache_clear()
