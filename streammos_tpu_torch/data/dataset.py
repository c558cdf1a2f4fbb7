"""SemanticKITTI streaming datasets.

A copy of `streammos_tpu/data/dataset.py` in numpy: the host does file IO,
ego-motion alignment, copy-paste augmentation, range filtering,
fixed-size resampling/padding and the shared geometric augmentation, and
ships raw float32 ``xyzi`` arrays; quantization, projection, point
features and eval TTA run on the device (`models.stream_mos.featurize`).
The random draws are taken in the same order as there, so the same tree
and seed give the same arrays.

No torch here: `SampleWorkerPool` workers import this module, and the
parent makes the tensors.

Sample layouts:
  train sample: xyzi (S=3, T=3, N, 4), targets (S, N) [, bf_targets (S, N)]
  eval sample:  xyzi (T, N, 4), targets (N,) [, bf_targets (N,)],
                valid_mask (raw_n,), pad_length, seq_id, file_id

``native=True`` (the default) reads scans and labels, and assembles eval
frames, through the C++ loader (`streammos_tpu_torch.native`, which raises
if it cannot build); ``native=False`` takes the numpy path. Both give the
same arrays.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from streammos_tpu_torch import host_geometry as geometry
from streammos_tpu_torch import native as native_lib
from streammos_tpu_torch.config import DatasetConfig
from streammos_tpu_torch.data import augment as aug_lib
from streammos_tpu_torch.data import semantic_kitti as sk


@dataclasses.dataclass
class FrameMeta:
    pcd_path: str
    label_path: Optional[str]
    pose_diff: np.ndarray  # 4x4: maps this frame into the anchor frame
    seq_id: str
    file_id: str


def _seq_dirs(seq_dir: str, seq_id: str):
    fpath = os.path.join(seq_dir, seq_id)
    return (os.path.join(fpath, "velodyne"), os.path.join(fpath, "labels"),
            os.path.join(fpath, "calib.txt"), os.path.join(fpath, "poses.txt"))


def _history_ids(i: int, total: int, span: int) -> List[int]:
    """History frame indices for anchor ``i``: interior and late frames
    look backward [i, i-1, ...]; the first frames of a sequence mirror
    forward."""
    if i < span - 1:
        return [i + ht for ht in range(span)]
    return [i - ht for ht in range(span)]


def _seq_poses(cfg: DatasetConfig, seq_id: str):
    """(velodyne dir, labels dir, poses) of one sequence, or None when it
    has no poses file."""
    vel, lab, calib_f, pose_f = _seq_dirs(cfg.seq_dir, seq_id)
    if not os.path.exists(pose_f):
        return None
    calib = geometry.parse_calibration(calib_f)
    return vel, lab, geometry.parse_poses(pose_f, calib)


def _load_scan(path: str, native: bool) -> np.ndarray:
    if native:
        return native_lib.load_scan(path)
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def _load_labels(path: str, native: bool) -> Tuple[np.ndarray, np.ndarray]:
    if native:
        raw = native_lib.load_labels(path)
    else:
        raw = np.fromfile(path, dtype=np.uint32).reshape(-1)
    return sk.split_label(raw)


class TrainDataset:
    """Stage-1/2 training windows.

    Per anchor frame: 5 ego-aligned history scans; 3 sliding windows of 3
    frames, each re-expressed in its own leading frame; per-window range
    filter, resample-with-replacement to ``frame_point_num``, shared-draw
    augmentation. Stage 2 (``with_bf_labels``) also carries movable labels.
    """

    def __init__(self, cfg: DatasetConfig, copy_paste=None,
                 drop_list_path: Optional[str] = None,
                 seq_ids: Optional[Sequence[int]] = None, seed: int = 0,
                 native: bool = True):
        self.cfg = cfg
        self.native = native
        self.span = cfg.seq_num + 2  # 5 frames -> 3 windows of 3
        self.windows_per_sample = self.span - cfg.seq_num + 1
        self.cp_aug = copy_paste
        self.rng = np.random.default_rng(seed)
        self.samples: List[Tuple[List[FrameMeta], List[np.ndarray]]] = []

        seq_ids = seq_ids if seq_ids is not None else sk.SPLITS["train"]
        per_seq: Dict[str, List] = {}
        per_seq_poses: Dict[str, List] = {}
        for seq in seq_ids:
            seq_id = str(seq).rjust(2, "0")
            found = _seq_poses(cfg, seq_id)
            if found is None:
                continue
            vel, lab, poses = found
            entries, entry_poses = [], []
            for i in range(len(poses)):
                ids = _history_ids(i, len(poses), self.span)
                inv = np.linalg.inv(poses[i])
                metas, plist = [], []
                for j in ids:
                    fid = str(j).rjust(6, "0")
                    metas.append(FrameMeta(
                        os.path.join(vel, f"{fid}.bin"),
                        os.path.join(lab, f"{fid}.label"),
                        inv @ poses[j], seq_id, fid))
                    plist.append(poses[j])
                entries.append(metas)
                entry_poses.append(plist)
            per_seq[seq_id] = entries
            per_seq_poses[seq_id] = entry_poses

        if cfg.drop_few_static_frames and drop_list_path and \
                os.path.exists(drop_list_path):
            keep: Dict[str, List[int]] = {}
            with open(drop_list_path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    seq, fid, _ = line.split()
                    keep.setdefault(seq, []).append(int(fid))
            for seq_id in list(per_seq):
                if seq_id in keep:
                    idx = keep[seq_id]
                    per_seq[seq_id] = [per_seq[seq_id][i] for i in idx]
                    per_seq_poses[seq_id] = [per_seq_poses[seq_id][i]
                                             for i in idx]

        for seq_id in per_seq:
            for metas, plist in zip(per_seq[seq_id], per_seq_poses[seq_id]):
                self.samples.append((metas, plist))

    def __len__(self):
        return len(self.samples)

    def reseed(self, seed: int) -> None:
        """Give this copy its own augmentation stream (each
        `SampleWorkerPool` worker calls it once)."""
        self.rng = np.random.default_rng(seed)

    def _form_seq(self, metas: List[FrameMeta]):
        scans, labels, bf_labels, roads, raw_sems = [], [], [], [], []
        for meta in metas:
            pc = geometry.np_transform(_load_scan(meta.pcd_path, self.native),
                                       meta.pose_diff).astype(np.float32)
            sem, _inst = _load_labels(meta.label_path, self.native)
            scans.append(pc)
            roads.append(pc[sem == sk.ROAD_LABEL])
            labels.append(sk.relabel(sem, sk.LEARNING_MAP))
            bf_labels.append(sk.relabel(sem, sk.BF_LEARNING_MAP))
            raw_sems.append(sem)
        return scans, labels, bf_labels, roads, raw_sems

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        metas, plist = self.samples[index]
        scans, labels, bf_labels, roads, raw_sems = self._form_seq(metas)

        if self.cp_aug is not None:
            scans, labels, bf_labels = self.cp_aug(
                scans, labels, bf_labels, roads, raw_sems, self.rng)

        params = aug_lib.draw_params(self.rng, cfg.aug)
        T, N = cfg.seq_num, cfg.frame_point_num
        S = self.windows_per_sample

        xyzi = np.zeros((S, T, N, 4), np.float32)
        targets = np.zeros((S, N), np.int32)
        bf_targets = np.zeros((S, N), np.int32)
        for w in range(S):
            win_scans = [scans[w + t] for t in range(T)]
            win_labels = [labels[w + t] for t in range(T)]
            win_bf = [bf_labels[w + t] for t in range(T)]
            if w > 0:
                # re-express the window in its own leading frame
                rebase = np.linalg.inv(plist[w]) @ plist[0]
                win_scans = [geometry.np_transform(s, rebase)
                             for s in win_scans]
            for t in range(T):
                pc = win_scans[t]
                mask = geometry.np_filter_mask(pc, cfg.voxel.range_x,
                                               cfg.voxel.range_y,
                                               cfg.voxel.range_z)
                pc = pc[mask]
                lw = win_labels[t][mask]
                bw = win_bf[t][mask]
                choice = self.rng.choice(pc.shape[0], N, replace=True)
                pc = pc[choice].astype(np.float32)
                pc = aug_lib.apply(pc, params, cfg.aug, self.rng)
                xyzi[w, t] = pc
                if t == 0:
                    targets[w] = lw[choice]
                    bf_targets[w] = bw[choice]

        out = {"xyzi": xyzi, "targets": targets}
        if cfg.with_bf_labels:
            out["bf_targets"] = bf_targets
        return out

    @staticmethod
    def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        """Stack the batch on axis 1: (S, B, T, N, 4) / (S, B, N)."""
        return {key: np.stack([s[key] for s in samples], axis=1)
                for key in samples[0]}


class EvalDataset:
    """Streaming evaluation frames in sequence order.

    Pads each frame to ``frame_point_num`` with sentinel points (xyz=-1000,
    z=-4000, intensity -1000) that land outside every grid; carries the
    raw-order valid mask so predictions can be scattered back for KITTI
    `.label` output. TTA happens on the device.
    """

    def __init__(self, cfg: DatasetConfig, split: str = "valid",
                 with_labels: bool = True,
                 seq_ids: Optional[Sequence[int]] = None,
                 native: bool = True):
        self.cfg = cfg
        self.with_labels = with_labels
        self.native = native
        self.samples: List[List[FrameMeta]] = []
        seq_ids = seq_ids if seq_ids is not None else sk.SPLITS[split]
        for seq in seq_ids:
            seq_id = str(seq).rjust(2, "0")
            found = _seq_poses(cfg, seq_id)
            if found is None:
                continue
            vel, lab, poses = found
            for i in range(len(poses)):
                ids = _history_ids(i, len(poses), cfg.seq_num)
                inv = np.linalg.inv(poses[i])
                metas = [FrameMeta(
                    os.path.join(vel, f"{str(j).rjust(6, '0')}.bin"),
                    os.path.join(lab, f"{str(j).rjust(6, '0')}.label")
                    if with_labels else None,
                    inv @ poses[j], seq_id, str(j).rjust(6, "0"))
                    for j in ids]
                self.samples.append(metas)

    def __len__(self):
        return len(self.samples)

    def _frame(self, meta: FrameMeta, lims, N: int):
        """(frame (N, 4), n_valid, valid mask over the raw scan)."""
        if self.native:
            return native_lib.assemble_eval_frame(meta.pcd_path,
                                                  meta.pose_diff, lims, N)
        cfg = self.cfg
        pc = geometry.np_transform(_load_scan(meta.pcd_path, False),
                                   meta.pose_diff).astype(np.float32)
        mask = geometry.np_filter_mask(pc, cfg.voxel.range_x,
                                       cfg.voxel.range_y, cfg.voxel.range_z)
        kept = pc[mask]
        n_valid = kept.shape[0]
        if n_valid > N:
            raise ValueError(
                f"{meta.pcd_path}: more in-range points ({n_valid}) than "
                f"frame_point_num={N}; raise DatasetConfig.frame_point_num "
                f"(CLI: --points)")
        frame = np.full((N, 4), -1000.0, np.float32)
        frame[:n_valid] = kept
        frame[n_valid:, 2] = -4000.0
        return frame, n_valid, mask

    def __getitem__(self, index: int) -> Dict[str, object]:
        cfg = self.cfg
        metas = self.samples[index]
        T, N = cfg.seq_num, cfg.frame_point_num
        xyzi = np.zeros((T, N, 4), np.float32)
        targets = np.zeros((N,), np.int32)
        bf_targets = np.zeros((N,), np.int32)
        valid_mask = None
        pad_length = 0
        lims = (cfg.voxel.range_x[0], cfg.voxel.range_x[1],
                cfg.voxel.range_y[0], cfg.voxel.range_y[1],
                cfg.voxel.range_z[0], cfg.voxel.range_z[1])
        for t, meta in enumerate(metas):
            xyzi[t], n_valid, mask = self._frame(meta, lims, N)
            if t == 0:
                valid_mask = mask
                pad_length = N - n_valid
                if self.with_labels and meta.label_path:
                    sem, _ = _load_labels(meta.label_path, self.native)
                    targets[:n_valid] = sk.relabel(sem, sk.LEARNING_MAP)[mask]
                    bf_targets[:n_valid] = sk.relabel(
                        sem, sk.BF_LEARNING_MAP)[mask]

        out = {
            "xyzi": xyzi,
            "targets": targets,
            "valid_mask": valid_mask,
            "pad_length": pad_length,
            "seq_id": metas[0].seq_id,
            "file_id": metas[0].file_id,
        }
        if cfg.with_bf_labels:
            out["bf_targets"] = bf_targets
        return out
