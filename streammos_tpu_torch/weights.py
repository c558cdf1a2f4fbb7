"""Carry weights into the port.

The port's modules name their parameters and buffers as the reference torch
`AttNet` state_dict does, so a reference-format checkpoint loads directly.
`from_flax_variables` turns a JAX `StreamMOSNet` variables tree
(``{"params", "batch_stats"}`` as nested dicts of numpy arrays) into such a
state_dict, through this module's own copy of the rule set of
`streammos_tpu/train/port_torch.py:build_mapping` and its inverse layout
rules (numpy only):

  flax nn.Conv kernel (kh, kw, I, O)  ->  torch Conv2d (O, I, kh, kw)
  flax Dense kernel (I, O) of a point 1x1 conv  ->  (O, I, 1, 1)
  flax Dense kernel (I, O) of a Linear  ->  (O, I)
  BN scale/bias + batch_stats mean/var  ->  weight/bias/running_{mean,var}

JAX's `build_mapping` has no rules for the attention fusions
(`fusion_mode` "branch_att", "point_att"); this copy names their keys
after the flax modules (`point_post.feat_model{i}.…`,
`point_post.weights`, `point_post.att_layer.…`, the same under
`refine.bf_point_post`).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from streammos_tpu_torch.config import ModelConfig

PathT = Tuple[str, ...]
Array = np.ndarray

# reference state_dict keys that carry no live compute (modules the
# reference constructs but never calls, aliases, BN step counters)
DEAD_KEY_MARKERS = (
    ".up1.", ".up2.", ".self_attn.", ".normx.",
    "header_unbalance_conv.", "res1_unbalance_conv.",
    "num_batches_tracked",
)


def _conv(w: Array) -> Array:
    """flax HWIO -> torch (O, I, kh, kw)."""
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))


def _dense_to_1x1(w: Array) -> Array:
    """flax Dense (I, O) -> torch 1x1 Conv2d (O, I, 1, 1)."""
    return np.ascontiguousarray(w.T)[:, :, None, None]


def _dense_to_linear(w: Array) -> Array:
    return np.ascontiguousarray(w.T)


def _identity(w: Array) -> Array:
    return np.ascontiguousarray(w)


class _Mapping:
    """(flax path -> torch key + layout rule) for the params and the
    batch_stats collections."""

    def __init__(self) -> None:
        self.params: List[Tuple[PathT, str, Callable[[Array], Array]]] = []
        self.stats: List[Tuple[PathT, str, Callable[[Array], Array]]] = []

    def p(self, path: PathT, key: str, fn: Callable[[Array], Array]) -> None:
        self.params.append((path, key, fn))

    def bn(self, path: PathT, key: str) -> None:
        inner = path + ("BatchNorm_0",)
        self.p(inner + ("scale",), key + ".weight", _identity)
        self.p(inner + ("bias",), key + ".bias", _identity)
        self.stats.append((inner + ("mean",), key + ".running_mean", _identity))
        self.stats.append((inner + ("var",), key + ".running_var", _identity))

    def pointnet(self, fp: PathT, tp: str, pre_bn: bool) -> None:
        if pre_bn:
            self.bn(fp + ("BN_0",), tp + ".layer.0")
            self.p(fp + ("Dense_0", "kernel"), tp + ".layer.1.weight", _dense_to_1x1)
            self.bn(fp + ("BN_1",), tp + ".layer.2")
        else:
            self.p(fp + ("Dense_0", "kernel"), tp + ".layer.0.weight", _dense_to_1x1)
            self.bn(fp + ("BN_0",), tp + ".layer.1")

    def downsample(self, fp: PathT, tp: str) -> None:
        self.p(fp + ("conv3_kernel",), tp + ".conv_branch.0.weight", _conv)
        self.bn(fp + ("BN_0",), tp + ".conv_branch.1")
        self.p(fp + ("conv1_kernel",), tp + ".pool_branch.0.weight", _conv)
        self.bn(fp + ("BN_1",), tp + ".pool_branch.1")

    def channel_att(self, fp: PathT, tp: str) -> None:
        self.p(fp + ("Conv_0", "kernel"), tp + ".cnet.1.weight", _conv)
        self.p(fp + ("Conv_0", "bias"), tp + ".cnet.1.bias", _identity)
        self.p(fp + ("Conv_1", "kernel"), tp + ".cnet.3.weight", _conv)
        self.p(fp + ("Conv_1", "bias"), tp + ".cnet.3.bias", _identity)

    def basic_block(self, fp: PathT, tp: str, att: bool) -> None:
        self.p(fp + ("Conv_0", "kernel"), tp + ".layer.0.weight", _conv)
        self.bn(fp + ("BN_0",), tp + ".layer.1")
        self.p(fp + ("Conv_1", "kernel"), tp + ".layer.3.weight", _conv)
        self.bn(fp + ("BN_1",), tp + ".layer.4")
        if att:
            self.channel_att(fp + ("ChannelAtt_0",), tp + ".channel_att")

    def unbalance(self, fp: PathT, tp: str) -> None:
        self.p(fp + ("Conv_0", "kernel"), tp + ".layer7x3.0.weight", _conv)
        self.bn(fp + ("BN_0",), tp + ".layer7x3.1")
        self.p(fp + ("Conv_1", "kernel"), tp + ".layer3x7.0.weight", _conv)
        self.bn(fp + ("BN_1",), tp + ".layer3x7.1")
        self.p(fp + ("Conv_2", "kernel"), tp + ".layer3x3.0.weight", _conv)
        self.bn(fp + ("BN_2",), tp + ".layer3x3.1")

    def conv_stage(self, fp: PathT, tp: str, num_blocks: int,
                   unbalance: bool) -> None:
        self.downsample(fp + ("DownSample2D_0",), tp + ".0")
        bb = 0
        for i in range(num_blocks):
            if i == 0 and unbalance:
                self.unbalance(fp + ("UnbalanceBasicBlock_0",), tp + f".{1 + i}")
            else:
                self.basic_block(fp + (f"BasicBlock_{bb}",), tp + f".{1 + i}",
                                 att=False)
                bb += 1
        self.basic_block(fp + (f"BasicBlock_{bb}",), tp + f".{1 + num_blocks}",
                         att=True)

    def cat_fusion(self, fp: PathT, tp: str) -> None:
        self.p(fp + ("Dense_0", "kernel"), tp + ".merge_layer.0.weight", _dense_to_1x1)
        self.bn(fp + ("BN_0",), tp + ".merge_layer.1")
        self.p(fp + ("Dense_1", "kernel"), tp + ".merge_layer.3.weight", _dense_to_1x1)
        self.bn(fp + ("BN_1",), tp + ".merge_layer.4")

    def branch_att_fusion(self, fp: PathT, tp: str, n: int) -> None:
        self.p(fp + ("weights",), tp + ".weights", _identity)
        for i in range(n):
            self.pointnet(fp + (f"feat_model{i}",), f"{tp}.feat_model{i}",
                          pre_bn=False)

    def point_att_fusion(self, fp: PathT, tp: str, n: int) -> None:
        for i in range(n):
            self.pointnet(fp + (f"feat_model{i}",), f"{tp}.feat_model{i}",
                          pre_bn=False)
        self.p(fp + ("Dense_0", "kernel"), tp + ".att_layer.0.weight", _dense_to_1x1)
        self.bn(fp + ("BN_0",), tp + ".att_layer.1")
        self.p(fp + ("Dense_1", "kernel"), tp + ".att_layer.3.weight", _dense_to_1x1)
        self.p(fp + ("Dense_1", "bias"), tp + ".att_layer.3.bias", _identity)

    def fusion(self, mode: str, fp: PathT, tp: str, n: int) -> None:
        """The rules of `nn/blocks.py:make_fusion`'s module for `mode`."""
        if mode in ("cat", "CatFusion"):
            self.cat_fusion(fp, tp)
        elif mode in ("point_att", "PointAttFusion"):
            self.point_att_fusion(fp, tp, n)
        elif mode in ("branch_att", "BranchAttFusion"):
            self.branch_att_fusion(fp, tp, n)
        else:
            raise KeyError(f"unknown fusion_mode {mode!r}")

    def spatial_att(self, fp: PathT, tp: str) -> None:
        self.p(fp + ("Conv_0", "kernel"), tp + ".snet.0.weight", _conv)
        self.bn(fp + ("BN_0",), tp + ".snet.1")
        self.p(fp + ("Conv_1", "kernel"), tp + ".snet.3.weight", _conv)
        self.p(fp + ("Conv_1", "bias"), tp + ".snet.3.bias", _identity)

    def cs_att(self, fp: PathT, tp: str) -> None:
        self.channel_att(fp + ("ChannelAtt_0",), tp + ".channel_att")
        self.spatial_att(fp + ("SpatialAtt_0",), tp + ".spatial_att")

    def basic_block_v2(self, fp: PathT, tp: str, att: bool) -> None:
        self.p(fp + ("Conv_0", "kernel"), tp + ".layer.0.weight", _conv)
        self.bn(fp + ("BN_0",), tp + ".layer.1")
        self.p(fp + ("Conv_1", "kernel"), tp + ".layer.3.weight", _conv)
        self.bn(fp + ("BN_1",), tp + ".layer.4")
        if att:
            self.cs_att(fp + ("CSAtt_0",), tp + ".channel_att")

    def pred_branch(self, fp: PathT, tp: str) -> None:
        self.p(fp + ("Dense_0", "kernel"), tp + ".pred_layer.0.weight", _dense_to_1x1)
        self.p(fp + ("Dense_0", "bias"), tp + ".pred_layer.0.bias", _identity)

    def ms_deform_attn(self, fp: PathT, tp: str) -> None:
        for nm in ("value_proj", "sampling_offsets", "attention_weights",
                   "output_proj"):
            self.p(fp + (nm, "kernel"), f"{tp}.{nm}.weight", _dense_to_linear)
            self.p(fp + (nm, "bias"), f"{tp}.{nm}.bias", _identity)

    def deform_layer(self, fp: PathT, tp: str) -> None:
        self.ms_deform_attn(fp + ("cross_attn",), tp + ".cross_attn")
        self.p(fp + ("LayerNorm_0", "scale"), tp + ".norm1.weight", _identity)
        self.p(fp + ("LayerNorm_0", "bias"), tp + ".norm1.bias", _identity)
        self.p(fp + ("Dense_0", "kernel"), tp + ".linear1.weight", _dense_to_linear)
        self.p(fp + ("Dense_0", "bias"), tp + ".linear1.bias", _identity)
        self.p(fp + ("Dense_1", "kernel"), tp + ".linear2.weight", _dense_to_linear)
        self.p(fp + ("Dense_1", "bias"), tp + ".linear2.bias", _identity)
        self.p(fp + ("LayerNorm_1", "scale"), tp + ".norm2.weight", _identity)
        self.p(fp + ("LayerNorm_1", "bias"), tp + ".norm2.bias", _identity)

    def basic_conv2d(self, fp: PathT, tp: str) -> None:
        self.p(fp + ("Conv_0", "kernel"), tp + ".conv.weight", _conv)
        self.bn(fp + ("BN_0",), tp + ".bn")


def build_mapping(cfg: ModelConfig, with_refine: bool = False) -> _Mapping:
    """The complete JAX StreamMOSNet -> reference AttNet rule set."""
    n1, n2, n3 = cfg.layers
    m = _Mapping()
    m.pointnet(("point_pre", "PointNet_0"), "point_pre.layer.0", pre_bn=True)
    m.pointnet(("point_pre", "PointNet_1"), "point_pre.layer.1", pre_bn=False)
    m.conv_stage(("bev_net", "header_bev"), "bev_net.header_bev", n1, True)
    m.conv_stage(("bev_net", "header_rv"), "bev_net.header_rv", n1 - 1, False)
    m.conv_stage(("bev_net", "res1_bev"), "bev_net.res1_bev", n2, True)
    m.conv_stage(("bev_net", "res1_rv"), "bev_net.res1_rv", n2 - 1, False)
    m.conv_stage(("bev_net", "res2"), "bev_net.res2", n3, False)
    m.p(("bev_net", "query_embed"), "bev_net.query_embed.weight", _identity)
    for i in range(cfg.n_attn_layers):
        m.deform_layer(("bev_net", "deformattn", f"layer{i}"),
                       f"bev_net.deformattn_module.deformattn_layers.{i}")
    m.basic_conv2d(("bev_net", "conv_1"), "bev_net.conv_1")
    m.basic_conv2d(("bev_net", "conv_2"), "bev_net.conv_2")
    for i in (1, 2, 3):
        m.p(("bev_net", f"aux_head{i}", "kernel"), f"bev_net.aux_head{i}.weight", _conv)
        m.p(("bev_net", f"aux_head{i}", "bias"), f"bev_net.aux_head{i}.bias", _identity)
    m.fusion(cfg.fusion_mode, ("point_post",), "point_post", 3)
    m.pred_branch(("pred_layer",), "pred_layer")
    if with_refine:
        m.fusion(cfg.fusion_mode, ("refine", "bf_point_post"),
                 "refine.bf_point_post", 3)
        m.pred_branch(("refine", "bf_pred_layer"), "refine.bf_pred_layer")
    return m


def _get(tree: Mapping[str, Any], path: PathT) -> Array:
    node: Any = tree
    for name in path:
        node = node[name]
    return node


def from_flax_variables(variables: Mapping[str, Any], cfg: ModelConfig,
                        with_refine: bool = False) -> Dict[str, torch.Tensor]:
    """JAX variables tree (nested dicts of numpy arrays) -> the port's
    state_dict (float32 CPU tensors; `num_batches_tracked` absent)."""
    return apply_mapping(build_mapping(cfg, with_refine), variables)


def apply_mapping(mapping: _Mapping, variables: Mapping[str, Any]
                  ) -> Dict[str, torch.Tensor]:
    """The state_dict that `mapping`'s rules make of a JAX variables tree
    (a whole network's, or a single block's with a `_Mapping` of its
    own)."""
    out: Dict[str, torch.Tensor] = {}
    for tree_name, rules in (("params", mapping.params),
                             ("batch_stats", mapping.stats)):
        tree = variables[tree_name]
        for path, key, fn in rules:
            val = np.array(_get(tree, path), dtype=np.float32)  # a writable copy
            out[key] = torch.from_numpy(fn(val))
    return out


def load_state_dict_checked(model: nn.Module,
                            state_dict: Mapping[str, torch.Tensor]) -> None:
    """`load_state_dict(strict=False)` that accepts as missing only the
    BatchNorm step counters and as unexpected only dead reference keys (and
    the refine head's keys when the model has none)."""
    result = model.load_state_dict(dict(state_dict), strict=False)
    missing = [k for k in result.missing_keys if "num_batches_tracked" not in k]
    unexpected = [k for k in result.unexpected_keys
                  if not any(mk in k for mk in DEAD_KEY_MARKERS)
                  and not k.startswith("refine.")]
    if missing or unexpected:
        raise KeyError(f"state_dict mismatch: missing {missing[:8]}, "
                       f"unexpected {unexpected[:8]}")


def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter and BatchNorm statistic from `generator`
    (on the CPU, so a seed gives the same weights on every device):
    weights N(0, 1/fan_in), biases N(0, 0.01^2), BN and LayerNorm affines
    near the identity, running variances in [0.5, 1.5]."""
    from streammos_tpu_torch.nn.deform import rotational_offset_bias

    def draw(shape, std=1.0, mean=0.0):
        return torch.randn(shape, generator=generator) * std + mean

    with torch.no_grad():
        for name, t in model.state_dict().items():
            owner = model.get_submodule(name.rsplit(".", 1)[0])
            shape = tuple(t.shape)
            if name.endswith("num_batches_tracked"):
                continue
            if name.endswith("running_var"):
                val = torch.rand(shape, generator=generator) + 0.5
            elif name.endswith("running_mean"):
                val = draw(shape, 0.1)
            elif isinstance(owner, (nn.BatchNorm2d, nn.LayerNorm)):
                val = draw(shape, 0.1, 1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("sampling_offsets.bias"):
                heads = model.cfg.n_heads
                val = torch.from_numpy(rotational_offset_bias(
                    heads, shape[0] // (2 * heads)))
            elif name.endswith("query_embed.weight"):
                val = draw(shape)
            elif len(shape) == 1:
                val = draw(shape, 0.01)
            else:
                val = draw(shape, int(np.prod(shape[1:])) ** -0.5)
            t.copy_(val.to(t.dtype))
    return model
