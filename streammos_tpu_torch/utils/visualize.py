"""Offline point-cloud / prediction visualization (headless-friendly).

Counterpart of `streammos_tpu/utils/visualize.py`: matplotlib images (a
BEV scatter and a range-view image colored by MOS label, and a side-by-side
prediction / ground-truth comparison) in place of the reference's
interactive OpenGL viewer. matplotlib is imported only by the functions
that draw, so the module imports without it.

    python -m streammos_tpu_torch.utils.visualize --scan x.bin \
        --label y.label --out frame.png
"""
from __future__ import annotations

from typing import Optional

import numpy as np

MOS_COLORS = {
    0: (0.6, 0.6, 0.6),  # unlabeled: gray
    1: (0.12, 0.47, 0.71),  # static: blue
    2: (0.89, 0.10, 0.11),  # moving: red
}


def _colors(labels: np.ndarray) -> np.ndarray:
    out = np.zeros((labels.shape[0], 3))
    for k, c in MOS_COLORS.items():
        out[labels == k] = c
    return out


def bev_figure(points: np.ndarray, labels: np.ndarray, ax=None,
               lim: float = 50.0, point_size: float = 0.3):
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(8, 8))
    ax.scatter(points[:, 0], points[:, 1], s=point_size, c=_colors(labels),
               linewidths=0)
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    return ax


def range_view_image(points: np.ndarray, labels: np.ndarray,
                     hw=(64, 2048), theta_range=(-25.0, 3.0)) -> np.ndarray:
    """(H, W, 3) range image colored by label (uses the same spherical
    projection as the network's RV branch)."""
    from streammos_tpu_torch.host_geometry import np_sphere_quantize

    coords = np_sphere_quantize(points, (-180.0, 180.0), theta_range,
                                         hw)
    img = np.zeros(hw + (3,))
    r = coords[:, 0].astype(int)
    c = coords[:, 1].astype(int)
    ok = (r >= 0) & (r < hw[0]) & (c >= 0) & (c < hw[1])
    img[r[ok], c[ok]] = _colors(labels)[ok]
    return img


def save_frame(scan_path: str, label_path: Optional[str], out_path: str,
               pred_path: Optional[str] = None):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from streammos_tpu_torch.data import semantic_kitti as sk

    pts = np.fromfile(scan_path, dtype=np.float32).reshape(-1, 4)

    def load(path):
        raw = np.fromfile(path, dtype=np.uint32)
        return sk.relabel((raw & 0xFFFF).astype(np.int64), sk.LEARNING_MAP)

    panels = []
    if label_path:
        panels.append(("ground truth", load(label_path)))
    if pred_path:
        panels.append(("prediction", load(pred_path)))
    if not panels:
        panels.append(("scan", np.zeros(pts.shape[0], np.int64)))

    fig, axes = plt.subplots(1, len(panels), figsize=(8 * len(panels), 8))
    axes = np.atleast_1d(axes)
    for ax, (title, lab) in zip(axes, panels):
        bev_figure(pts, lab, ax=ax)
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--scan", required=True)
    ap.add_argument("--label", default=None)
    ap.add_argument("--pred", default=None)
    ap.add_argument("--out", default="frame.png")
    a = ap.parse_args()
    print(save_frame(a.scan, a.label, a.out, a.pred))
