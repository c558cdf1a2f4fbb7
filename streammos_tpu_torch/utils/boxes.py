"""3-D box and hull helpers (numpy and scipy).

A copy of `streammos_tpu/utils/boxes.py`: convex-hull membership, yaw
rotation, box corners, and a box wireframe as vertex and edge arrays that
`streammos_tpu_torch.utils.visualize` can draw.
"""
from __future__ import annotations

import numpy as np


def in_hull(points: np.ndarray, hull: np.ndarray) -> np.ndarray:
    """Membership of (N, K) ``points`` in the convex hull of (M, K) ``hull``
    corners. Returns (N,) bool; a degenerate hull yields
    all-False rather than raising."""
    from scipy.spatial import Delaunay, QhullError

    try:
        tri = hull if isinstance(hull, Delaunay) else Delaunay(hull)
        return tri.find_simplex(points) >= 0
    except QhullError:
        return np.zeros(points.shape[0], dtype=bool)


def rotate_points_along_z(points: np.ndarray, angle: np.ndarray) -> np.ndarray:
    """Rotate (B, N, 3+C) points by per-batch yaw ``angle`` (B,), x toward y
    for positive angles. Extra channels pass through."""
    points = np.asarray(points, dtype=np.float32)
    angle = np.asarray(angle, dtype=np.float32)
    cosa, sina = np.cos(angle), np.sin(angle)
    zeros = np.zeros_like(angle)
    ones = np.ones_like(angle)
    rot = np.stack((cosa, sina, zeros,
                    -sina, cosa, zeros,
                    zeros, zeros, ones), axis=1).reshape(-1, 3, 3)
    xyz = np.matmul(points[:, :, 0:3], rot)
    return np.concatenate((xyz, points[:, :, 3:]), axis=-1)


def boxes_to_corners_3d(boxes3d: np.ndarray) -> np.ndarray:
    """(N, 7) [cx, cy, cz, dx, dy, dz, heading] -> (N, 8, 3) corners in the
    reference's corner order."""
    boxes3d = np.asarray(boxes3d, dtype=np.float32)
    template = np.array(
        [[1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
         [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1]],
        dtype=np.float32) / 2.0
    corners = boxes3d[:, None, 3:6] * template[None, :, :]
    corners = rotate_points_along_z(corners, boxes3d[:, 6])
    return corners + boxes3d[:, None, 0:3]


# Edges of the 8-corner box in the order above, as an index list for a line
# plot.
BOX_EDGES = np.array(
    [(0, 1), (1, 2), (2, 3), (3, 0),
     (4, 5), (5, 6), (6, 7), (7, 4),
     (0, 4), (1, 5), (2, 6), (3, 7)], dtype=np.int32)


def box_wireframe(boxes3d: np.ndarray):
    """(N, 7) boxes -> (vertices (N*8, 3), edges (N*12, 2)) line set."""
    corners = boxes_to_corners_3d(boxes3d)
    n = corners.shape[0]
    verts = corners.reshape(-1, 3)
    edges = (BOX_EDGES[None, :, :] + 8 * np.arange(n)[:, None, None])
    return verts, edges.reshape(-1, 2).astype(np.int32)
