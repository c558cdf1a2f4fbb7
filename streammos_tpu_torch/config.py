"""Declarative configuration for the PyTorch port of StreamMOS-TPU.

A standalone copy of the dataclasses and registry of `streammos_tpu/config.py`
(importing that module would run `streammos_tpu/__init__.py`, which imports
jax). Field names, defaults and the registered configs are the same, so a
config built here describes the same network as its JAX namesake.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class VoxelConfig:
    rv_theta: Tuple[float, float] = (-25.0, 3.0)
    range_x: Tuple[float, float] = (-50.0, 50.0)
    range_y: Tuple[float, float] = (-50.0, 50.0)
    range_z: Tuple[float, float] = (-4.0, 2.0)
    bev_shape: Tuple[int, int, int] = (512, 512, 30)
    rv_shape: Tuple[int, int] = (64, 2048)

    @property
    def bev_wl(self) -> Tuple[int, int]:
        return self.bev_shape[:2]


@dataclasses.dataclass(frozen=True)
class AugConfig:
    noise_mean: float = 0.0
    noise_std: float = 0.0001
    theta_range: Tuple[float, float] = (-180.0, 180.0)
    shift_range: Tuple[Tuple[float, float], ...] = ((-3, 3), (-3, 3), (-0.4, 0.4))
    size_range: Tuple[float, float] = (0.95, 1.05)


@dataclasses.dataclass(frozen=True)
class CopyPasteConfig:
    is_use: bool = True
    obj_bank_dir: str = "object_bank_semkitti"
    paste_max_obj_num: int = 20


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    seq_dir: str = "SemanticKITTI/dataset/sequences"
    frame_point_num: int = 130000
    seq_num: int = 3  # K + 1 consecutive aligned frames fed to the network
    voxel: VoxelConfig = VoxelConfig()
    aug: AugConfig = AugConfig()
    copy_paste: CopyPasteConfig = CopyPasteConfig()
    drop_few_static_frames: bool = True
    num_workers: int = 4
    with_bf_labels: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "stream_mos"  # stream_mos | stream_mos_seg
    class_num: int = 3  # {unlabeled, static, moving}
    seq_num: int = 3
    point_feat_out_channels: int = 64
    fusion_mode: str = "cat"
    context_layers: Tuple[int, int, int, int] = (64, 32, 64, 128)
    layers: Tuple[int, int, int] = (2, 3, 4)
    grid2point_scale: Tuple[float, float] = (0.5, 0.5)
    query_hw: Tuple[int, int] = (64, 64)
    d_model: int = 128
    ffn_dim: int = 512
    n_heads: int = 4
    n_points: int = 4
    n_attn_layers: int = 2
    attn_dropout: float = 0.0
    dropout_rate: float = 0.2
    loss_mode: str = "ohem"
    voxel: VoxelConfig = VoxelConfig()
    # compute dtype of the conv/matmul stages; parameters and BN/LN
    # statistics stay float32
    compute_dtype: str = "bfloat16"
    # eval: the full-grid scatter emits the phase-outer layout and the
    # header DownSample2D of all four TTA variants runs as one fused kernel
    fused_header: bool = True


@dataclasses.dataclass(frozen=True)
class OptimizeConfig:
    optimizer: str = "sgd"
    base_lr: float = 0.02
    momentum: float = 0.9
    nesterov: bool = True
    weight_decay: float = 1e-3
    schedule: str = "step"
    begin_epoch: int = 0
    end_epoch: int = 48
    pct_start: float = 0.01
    final_lr: float = 1e-6
    step_epochs: int = 10
    decay_factor: float = 0.1


@dataclasses.dataclass(frozen=True)
class Config:
    name: str = "StreamMOS"
    batch_size_per_device: int = 3
    log_frequency: int = 100
    category_list: Tuple[str, ...] = ("static", "moving")
    train: DatasetConfig = DatasetConfig()
    val: DatasetConfig = DatasetConfig(frame_point_num=160000,
                                       copy_paste=CopyPasteConfig(is_use=False))
    test: DatasetConfig = DatasetConfig(frame_point_num=160000,
                                        copy_paste=CopyPasteConfig(is_use=False))
    model: ModelConfig = ModelConfig()
    optimize: OptimizeConfig = OptimizeConfig()
    learning_map_inv: Tuple[Tuple[int, int], ...] = ((0, 0), (1, 9), (2, 251))
    freeze_except: Optional[str] = None
    pretrain_epoch: int = 40
    seed: int = 50051


_REGISTRY: Dict[str, Callable[[], Config]] = {}


def register(name: str):
    def deco(fn: Callable[[], Config]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str, **overrides) -> Config:
    if name not in _REGISTRY:
        raise KeyError(f"unknown config '{name}'; known: {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def list_configs() -> Sequence[str]:
    return sorted(_REGISTRY)


@register("StreamMOS")
def _stream_mos() -> Config:
    """Stage-1 MOS config."""
    return Config()


@register("StreamMOS_seg")
def _stream_mos_seg() -> Config:
    """Stage-2 movable-segmentation config (refine head on)."""
    base = Config()
    return dataclasses.replace(
        base,
        name="StreamMOS_seg",
        batch_size_per_device=4,
        train=dataclasses.replace(base.train, with_bf_labels=True,
                                  drop_few_static_frames=False),
        val=dataclasses.replace(base.val, with_bf_labels=True),
        model=dataclasses.replace(base.model, name="stream_mos_seg"),
        optimize=dataclasses.replace(base.optimize, end_epoch=10, step_epochs=2),
        freeze_except="refine",
    )


@register("StreamMOS_tiny")
def _stream_mos_tiny() -> Config:
    """Tiny grids in float32, for CPU tests and smoke runs."""
    voxel = VoxelConfig(bev_shape=(64, 64, 30), rv_shape=(16, 256))
    model = ModelConfig(voxel=voxel, query_hw=(8, 8), compute_dtype="float32")
    base = Config()
    return dataclasses.replace(
        base,
        name="StreamMOS_tiny",
        batch_size_per_device=1,
        model=model,
        train=dataclasses.replace(base.train, frame_point_num=1024, voxel=voxel,
                                  copy_paste=CopyPasteConfig(is_use=False)),
        val=dataclasses.replace(base.val, frame_point_num=1024, voxel=voxel),
        test=dataclasses.replace(base.test, frame_point_num=1024, voxel=voxel),
    )
