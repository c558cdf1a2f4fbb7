"""Long-term-memory refinement: voxel voting and instance voting.

Counterpart of `streammos_tpu/postprocess/voting.py`:

* **voxel voting** — the last ``frames_num_max=8`` frames' predictions,
  ego-aligned with the current frame and cropped to the BEV field of view,
  vote by majority in each cell of the (512, 512, 30) grid, and the current
  frame's points take their cell's majority. `voxel_vote` counts on the
  host with ``np.add.at``; `voxel_vote_device` counts on a torch device with
  one ``bincount`` over ``cell * classes + label``, an argmax and a gather.
  Both quantize on the host in float64 (`_quantize_int`): a float32
  quantization on the device would move points that lie on cell boundaries.
* **instance voting** — DBSCAN(eps=0.3, min_samples=5) over the points the
  stage-2 head called movable; each cluster of more than 30 points gets an
  axis-aligned box (bottom lifted by 0.2 m), and the local-map points inside
  it vote the whole cluster static or dynamic. A dynamic vote counts twice
  (``dynamic_vote_weight=2``), as in the reference, which summed label
  values. The DBSCAN is this package's own (`postprocess/dbscan.py`).

Numpy and scipy only at import: a spawned voting worker imports this module
without torch, which `voxel_vote_device` imports when it is called.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from streammos_tpu_torch.config import VoxelConfig
from streammos_tpu_torch.postprocess.dbscan import dbscan


def _quantize_int(points: np.ndarray, voxel: VoxelConfig) -> np.ndarray:
    """float xyz -> integer voxel coords (float64 arithmetic, truncated by
    the cast to int64 as the reference's casts do)."""
    size = voxel.bev_shape
    dx = (voxel.range_x[1] - voxel.range_x[0]) / size[0]
    dy = (voxel.range_y[1] - voxel.range_y[0]) / size[1]
    dz = (voxel.range_z[1] - voxel.range_z[0]) / size[2]
    q = np.stack([(points[:, 0] - voxel.range_x[0]) / dx,
                  (points[:, 1] - voxel.range_y[0]) / dy,
                  (points[:, 2] - voxel.range_z[0]) / dz], axis=-1)
    return q.astype(np.int64)


def _linear_cells(points: np.ndarray, voxel: VoxelConfig
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(linear cell id, inside-the-grid mask) of each point."""
    size = voxel.bev_shape
    coords = _quantize_int(points, voxel)
    lin = coords[:, 0] * size[1] * size[2] + coords[:, 1] * size[2] + coords[:, 2]
    ok = ((coords >= 0).all(axis=1) & (coords[:, 0] < size[0])
          & (coords[:, 1] < size[1]) & (coords[:, 2] < size[2]))
    return lin, ok


def crop_mask(points: np.ndarray, voxel: VoxelConfig) -> np.ndarray:
    """Field-of-view crop: min-inclusive, max-exclusive on each axis."""
    return ((points[:, 0] >= voxel.range_x[0]) & (points[:, 0] < voxel.range_x[1])
            & (points[:, 1] >= voxel.range_y[0]) & (points[:, 1] < voxel.range_y[1])
            & (points[:, 2] >= voxel.range_z[0]) & (points[:, 2] < voxel.range_z[1]))


def voxel_vote(local_points: np.ndarray, local_preds: np.ndarray,
               cur_points: np.ndarray, cur_preds: np.ndarray,
               voxel: VoxelConfig, num_classes: int = 3) -> np.ndarray:
    """NumPy voxel majority vote.

    ``local_points/preds``: all voting points, already cropped to the field
    of view and ego-aligned with the current frame (history and current).
    ``cur_points/preds``: the cropped current frame. Returns the refined
    current-frame predictions: the argmax vote of each point's cell, ties to
    the lowest class id; a point whose cell lies outside the grid keeps its
    own prediction.
    """
    size = voxel.bev_shape
    n_cells = size[0] * size[1] * size[2]
    lin, _ = _linear_cells(local_points, voxel)
    votes = np.zeros((n_cells, num_classes), np.int64)
    np.add.at(votes, (lin, local_preds.astype(np.int64)), 1)
    voxel_labels = votes.argmax(axis=-1)

    cur_lin, ok = _linear_cells(cur_points, voxel)
    out = cur_preds.copy()
    out[ok] = voxel_labels[cur_lin[ok]]
    return out


def voxel_vote_device(local_points: np.ndarray, local_preds: np.ndarray,
                      cur_points: np.ndarray, cur_preds: np.ndarray,
                      voxel: VoxelConfig, num_classes: int = 3,
                      capacity: int = 1 << 21, device="cuda") -> np.ndarray:
    """`voxel_vote` with the counting on a torch `device`: one ``bincount``
    of ``cell * num_classes + label`` (int64 counters, n_cells x classes),
    an argmax (the first maximal class, so ties go to the lowest id), a
    gather at the current points' cells and a ``where`` on their mask.

    ``capacity`` is the JAX call's contract (its jitted vote is padded to
    it); eager torch needs no padding, but the same inputs are refused.
    A vote id outside the counters is dropped, as JAX's ``segment_sum``
    drops it."""
    import torch

    size = voxel.bev_shape
    n_cells = size[0] * size[1] * size[2]
    P, K = local_points.shape[0], cur_points.shape[0]
    assert P <= capacity and K <= capacity, (P, K, capacity)
    n_seg = n_cells * num_classes

    lin, _ = _linear_cells(local_points, voxel)
    cur_lin, cur_ok = _linear_cells(cur_points, voxel)
    seg = lin * num_classes + local_preds.astype(np.int64)
    seg = torch.from_numpy(seg[(seg >= 0) & (seg < n_seg)]).to(device)
    votes = torch.bincount(seg, minlength=n_seg)
    voxel_labels = votes.view(n_cells, num_classes).argmax(dim=-1)
    cur_lin = torch.from_numpy(np.clip(cur_lin, 0, n_cells - 1)).to(device)
    picked = voxel_labels[cur_lin]
    out = torch.where(torch.from_numpy(cur_ok).to(device), picked,
                      torch.from_numpy(cur_preds.astype(np.int64)).to(device))
    return out.cpu().numpy().astype(cur_preds.dtype)


def _aabb_corners(points: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    lo = lo.copy()
    lo[2] += 0.2  # lift the box bottom off the ground
    return lo, hi


def instance_vote(cur_points: np.ndarray, cur_preds: np.ndarray,
                  cur_bf_preds: np.ndarray, local_points: np.ndarray,
                  local_preds: np.ndarray, eps: float = 0.3,
                  min_samples: int = 5, min_cluster: int = 30,
                  dynamic_vote_weight: int = 2) -> np.ndarray:
    """DBSCAN-cluster the stage-2 'movable' points; each cluster of more
    than ``min_cluster`` points is wholly relabeled by the local map's vote
    inside its box (dynamic only when the weighted dynamic votes exceed the
    static ones, so a tie stays static)."""
    fg_idx = np.where(cur_bf_preds == 2)[0]
    out = cur_preds.copy()
    if len(fg_idx) == 0:
        return out
    fg_points = cur_points[fg_idx][:, :3]
    cluster_ids = dbscan(fg_points, eps, min_samples)

    for cid in np.unique(cluster_ids):
        if cid == -1:
            continue
        member = cluster_ids == cid
        if member.sum() <= min_cluster:
            continue
        pts = fg_points[member]
        lo, hi = _aabb_corners(pts)
        inside = ((local_points[:, :3] >= lo) & (local_points[:, :3] <= hi)).all(axis=1)
        votes = local_preds[inside]
        n_static = (votes == 1).sum()
        n_dynamic = (votes == 2).sum() * dynamic_vote_weight
        label = 2 if n_dynamic > n_static else 1
        out[fg_idx[member]] = label
    return out


def gather_history(frame_id: int, num_frames: int, frames_num_max: int = 8
                   ) -> Sequence[int]:
    """History frame ids for voting: the previous ``frames_num_max`` frames;
    for early frames, the first ``frames_num_max`` frames of the sequence
    (clipped to its length) without the current one."""
    if frame_id >= frames_num_max:
        return list(range(frame_id - 1, frame_id - frames_num_max - 1, -1))
    ids = list(range(min(frames_num_max, num_frames)))
    ids.remove(frame_id)
    return ids
