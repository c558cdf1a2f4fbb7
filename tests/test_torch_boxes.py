"""The port's box helpers and offline visualization against the JAX
package's, on the same numpy inputs from a seed (exact)."""
import numpy as np
import pytest

from streammos_tpu.utils import boxes as jax_boxes
from streammos_tpu.utils import visualize as jax_visualize
from streammos_tpu_torch.data import semantic_kitti as sk
from streammos_tpu_torch.utils import boxes, visualize


def _boxes(rng, n=5):
    return np.concatenate([rng.uniform(-20, 20, (n, 3)),
                           rng.uniform(0.5, 4, (n, 3)),
                           rng.uniform(-np.pi, np.pi, (n, 1))], 1)


@pytest.mark.parametrize("hull", ["box", "random", "flat", "collinear"])
def test_in_hull_matches_jax(hull):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-3, 3, (500, 3))
    if hull == "box":
        corners = boxes.boxes_to_corners_3d(
            np.array([[0.5, 0, 0, 3, 2, 1.5, 0.4]]))[0]
    elif hull == "random":
        corners = rng.uniform(-2, 2, (12, 3))
    elif hull == "flat":  # degenerate: all corners in one plane
        corners = np.concatenate([rng.uniform(-2, 2, (8, 2)),
                                  np.zeros((8, 1))], 1)
    else:  # degenerate: on one line
        corners = np.outer(np.linspace(-1, 1, 6), [1.0, 2.0, 3.0])
    got = boxes.in_hull(pts, corners)
    np.testing.assert_array_equal(got, jax_boxes.in_hull(pts, corners))
    if hull in ("flat", "collinear"):
        assert not got.any()
    else:
        assert 0 < got.sum() < len(pts)


def test_rotate_points_along_z_matches_jax():
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(4, 50, 5))
    angle = rng.uniform(-np.pi, np.pi, 4)
    got = boxes.rotate_points_along_z(pts, angle)
    np.testing.assert_array_equal(got, jax_boxes.rotate_points_along_z(pts,
                                                                       angle))
    np.testing.assert_array_equal(got[..., 3:], pts[..., 3:].astype(np.float32))


def test_box_corners_and_wireframe_match_jax():
    b = _boxes(np.random.default_rng(2))
    np.testing.assert_array_equal(boxes.boxes_to_corners_3d(b),
                                  jax_boxes.boxes_to_corners_3d(b))
    np.testing.assert_array_equal(boxes.BOX_EDGES, jax_boxes.BOX_EDGES)
    verts, edges = boxes.box_wireframe(b)
    jverts, jedges = jax_boxes.box_wireframe(b)
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(edges, jedges)
    assert verts.shape == (40, 3) and edges.shape == (60, 2)


@pytest.mark.parametrize("hw", [(64, 2048), (16, 256)])
def test_range_view_image_matches_jax(hw):
    rng = np.random.default_rng(3)
    pts = np.concatenate([rng.uniform(-40, 40, (4000, 2)),
                          rng.uniform(-3, 2, (4000, 1))], 1).astype(np.float32)
    labels = rng.integers(0, 3, 4000)
    got = visualize.range_view_image(pts, labels, hw)
    np.testing.assert_array_equal(got,
                                  jax_visualize.range_view_image(pts, labels,
                                                                 hw))
    assert got.shape == hw + (3,) and got.any()


@pytest.mark.parametrize("with_pred", [False, True])
def test_save_frame_writes_png(tmp_path, with_pred):
    rng = np.random.default_rng(4)
    pts = np.concatenate([rng.uniform(-40, 40, (2000, 2)),
                          rng.uniform(-3, 2, (2000, 2))], 1).astype(np.float32)
    pts.tofile(tmp_path / "scan.bin")
    inv = sk.label_lut(sk.LEARNING_MAP_INV)
    inv[rng.integers(0, 3, 2000)].astype(np.uint32).tofile(
        tmp_path / "gt.label")
    inv[rng.integers(0, 3, 2000)].astype(np.uint32).tofile(
        tmp_path / "pred.label")
    out = visualize.save_frame(
        str(tmp_path / "scan.bin"), str(tmp_path / "gt.label"),
        str(tmp_path / "frame.png"),
        str(tmp_path / "pred.label") if with_pred else None)
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
