"""Network building blocks.

Counterparts of `streammos_tpu/nn/blocks.py`. Dense grids are NCHW inside
the modules; point tensors are (..., N, C), or (..., N, fold*C) with the TTA
variants folded v-major on channels (an eval-only layout, as in JAX).
Parameters and buffers carry the names of the reference torch `AttNet`
state_dict (the keys `streammos_tpu_torch/weights.py:build_mapping` emits),
and stay float32; each module casts its weights to the activation dtype, so
a bfloat16 input runs in bfloat16 as the JAX modules do. Train mode is the
module's `training` flag: batch-statistics BatchNorm and active dropout.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from streammos_tpu_torch import parallel
from streammos_tpu_torch.ops.bn_act import activate, bn_act, memory_format
from streammos_tpu_torch.ops.fused_header import fused_header_tta
from streammos_tpu_torch.ops.tta_fold import V_TTA, orient_grid

BN_EPS = 1e-5


class BN(nn.BatchNorm2d):
    """flax `nn.BatchNorm` (momentum 0.9, eps 1e-5) as `BN` of the JAX
    blocks runs it.

    Eval: the per-channel affine, scale = weight / sqrt(running_var + eps),
    shift = bias - running_mean * scale, applied in float32 and rounded once
    to the activation dtype, in one pass with what follows the BN (`act`):
    `ops/bn_act.py:bn_act`, the hand kernel on a card.

    Train: batch statistics in float32 over every axis but the channel
    axis, the variance as E[x^2] - E[x]^2 clipped at 0 (biased), the
    normalization in float32 and the result cast back to the input dtype.
    The running statistics move to 0.9 * old + 0.1 * batch, with the biased
    variance (torch's BatchNorm uses the unbiased one), unless
    `update_stats` is off, as it is while a checkpointed forward runs again.
    While a process group is active the statistics are the global batch's
    (`_global_moments`), as JAX's mesh computes them.

    fold == 0: NCHW input, channels on dim 1. fold >= 1: channels last, as
    `fold` v-major blocks that share the (C,) statistics (the folded TTA
    point layout, eval only when fold > 1)."""

    def __init__(self, num_features: int, fold: int = 0):
        super().__init__(num_features, eps=BN_EPS, momentum=0.1)
        self.fold = fold
        self.update_stats = True

    def eval_affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scale, shift) in float32, for the fused TTA header kernel."""
        scale = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
        return scale, self.bias.float() - self.running_mean.float() * scale

    def _train_forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fold > 1:
            raise ValueError("folded BN is an eval-only layout")
        ch = x.ndim - 1 if self.fold else 1
        axes = [d for d in range(x.ndim) if d != ch]
        shape = [1] * x.ndim
        shape[ch] = -1
        xf = x.float()
        if parallel.active():
            mean, var = self._global_moments(xf, axes, xf.shape[ch])
        else:
            mean = xf.mean(axes)
            var = torch.clamp(xf.square().mean(axes) - mean.square(), min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        if self.update_stats:
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * var)
        return y.to(x.dtype)

    @staticmethod
    def _global_moments(xf: torch.Tensor, axes, C: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """E[x] and the clipped E[x^2] - E[x]^2 over every rank's batch:
        the per-channel sums of x and x^2 and the element count summed over
        the ranks in one differentiable all-reduce, so the gradient of the
        normalization sees the global batch, as under JAX's mesh."""
        count = xf.new_full((1,), xf.numel() // C)
        sums = parallel.all_reduce_sum(torch.cat(
            [xf.sum(axes), xf.square().sum(axes), count]))
        mean = sums[:C] / sums[-1]
        var = torch.clamp(sums[C:2 * C] / sums[-1] - mean.square(), min=0.0)
        return mean, var

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(x)

    def act(self, x: torch.Tensor, act: str = "none",
            residual: Optional[torch.Tensor] = None,
            gate: Optional[torch.Tensor] = None) -> torch.Tensor:
        """act(BN(x) * gate + residual), act "none", "relu" or "leaky_relu";
        the gate per (sample, channel), eval only. Train: the batch-
        statistics BN, then the residual add and the activation, each its
        own op. Eval: one `bn_act` pass, which reads the running statistics
        and the affine where they lie (a CUDA graph replay sees weights
        written in place)."""
        if self.training:
            if gate is not None:
                raise ValueError("the BN gate is an eval-only fusion")
            y = self._train_forward(x)
            return activate(y if residual is None else y + residual, act)
        return bn_act(x, self.weight, self.bias, self.running_mean,
                      self.running_var, self.eps, self.fold, act, residual,
                      gate)


class Dropout(nn.Module):
    """flax `nn.Dropout` in train mode: each element kept with probability
    1 - rate and scaled by 1 / (1 - rate), the mask drawn from `generator`,
    an explicit `torch.Generator` on the input's device that the caller
    sets (`set_dropout_generator`). The identity in eval and at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("dropout in train mode draws from an explicit "
                               "generator: call set_dropout_generator first")
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def set_dropout_generator(module: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Point every Dropout under `module` at `generator`."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose weights follow the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Linear(nn.Linear):
    """nn.Linear whose weights follow the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class PointConv(nn.Module):
    """The reference's 1x1 Conv2d over points, weight (cout, cin, 1, 1),
    applied to (..., N, fold*cin) with the shared weight per v-major block.
    Takes a list of inputs: per variant, their channel concat (in list
    order) is the conv's input, as in the reference CatFusion."""

    def __init__(self, cin: int, cout: int, bias: bool = False, fold: int = 1):
        super().__init__()
        self.fold = fold
        self.weight = nn.Parameter(torch.empty(cout, cin, 1, 1))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, xs) -> torch.Tensor:
        if isinstance(xs, torch.Tensor):
            xs = [xs]
        dt = xs[0].dtype
        lead = xs[0].shape[:-1]
        parts = [x.reshape(*lead, self.fold, x.shape[-1] // self.fold) for x in xs]
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
        bias = None if self.bias is None else self.bias.to(dt)
        y = F.linear(x, self.weight[:, :, 0, 0].to(dt), bias)
        return y.reshape(*lead, -1)


def maxpool3x3(x: torch.Tensor, stride: int) -> torch.Tensor:
    """3x3 max-pool, padding 1 with -inf, on NCHW, as JAX's `maxpool3x3`
    computes it: pairwise maxima along W, then along H. Its gradient then
    is JAX's too: `torch.maximum`, like `jax.lax.max`, halves the gradient
    between tied inputs, where `F.max_pool2d` gives it to one element."""
    xp = F.pad(x, (1, 1, 1, 1), value=float("-inf"))
    m = torch.maximum(torch.maximum(xp[..., :-2], xp[..., 1:-1]), xp[..., 2:])
    m = torch.maximum(torch.maximum(m[..., :-2, :], m[..., 1:-1, :]),
                      m[..., 2:, :])
    return m[..., ::stride, ::stride]


class DownSample2D(nn.Module):
    """3x3 conv + BN in parallel with 1x1 conv + BN + 3x3 max-pool, sum,
    ReLU. `forward` takes NCHW, or the frame-split (B, T, H, W, c) channels-
    last stack of T frames, which it runs as the conv over their frame-major
    channel concat (channel t*c + i); `forward_tta_fused` takes the
    phase-outer scatter output and runs the fused TTA header."""

    def __init__(self, in_planes: int, out_planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv_branch = nn.Sequential(
            Conv2d(in_planes, out_planes, 3, stride, 1, bias=False), BN(out_planes))
        self.pool_branch = nn.Sequential(
            Conv2d(in_planes, out_planes, 1, bias=False), BN(out_planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 5:
            B, T, H, W, c = x.shape
            x = x.permute(0, 1, 4, 2, 3).reshape(B, T * c, H, W)
        if self.training:
            return torch.relu(self.conv_branch(x)
                              + maxpool3x3(self.pool_branch(x), self.stride))
        conv, bn = self.conv_branch
        conv_b = conv(x)
        # the eval epilogue reads the pool branch in conv_b's layout
        pool_b = maxpool3x3(self.pool_branch(x), self.stride).contiguous(
            memory_format=memory_format(conv_b))
        return bn.act(conv_b, "relu", residual=pool_b)

    def forward_tta_fused(self, g_phase: torch.Tensor, T: int) -> torch.Tensor:
        """(Bt*T, 4, Hh+2, Wh, V*C) phase-outer, canonical -> (V*Bt, Cout,
        Hh, Wh): each variant's output in its own orientation, variants on
        the batch axis in variant order."""
        dt = g_phase.dtype
        k3 = self.conv_branch[0].weight.to(dt).permute(2, 3, 1, 0)  # HWIO
        k1 = self.pool_branch[0].weight.to(dt).permute(2, 3, 1, 0)
        y = fused_header_tta(g_phase, k3, k1, self.conv_branch[1].eval_affine(),
                             self.pool_branch[1].eval_affine(), T)
        y = torch.stack([orient_grid(y[v], v, "bev", (1, 2))
                         for v in range(V_TTA)])
        V, Bt, Hh, Wh, C = y.shape
        return y.reshape(V * Bt, Hh, Wh, C).permute(0, 3, 1, 2)


class ChannelAtt(nn.Module):
    """SE channel attention: mean over H, W (in float32), 1x1 conv, ReLU,
    1x1 conv, sigmoid, scale."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        self.cnet = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            Conv2d(channels, channels // reduction, 1),
            nn.ReLU(),
            Conv2d(channels // reduction, channels, 1),
            nn.Sigmoid())

    def gate(self, mean: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The (N, C, 1, 1) scale from the float32 mean over H, W of the
        attended tensor, in `dtype`."""
        ca = mean.to(dtype)
        return torch.sigmoid(self.cnet[3](torch.relu(self.cnet[1](ca))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gate(x.float().mean(dim=(2, 3), keepdim=True),
                             x.dtype)


class BasicBlock(nn.Module):
    """Residual 3x3-3x3 block, optional channel attention before the
    residual add."""

    def __init__(self, planes: int, use_att: bool = True):
        super().__init__()
        self.layer = nn.Sequential(
            Conv2d(planes, planes, 3, 1, 1, bias=False), BN(planes), nn.ReLU(),
            Conv2d(planes, planes, 3, 1, 1, bias=False), BN(planes))
        self.channel_att = ChannelAtt(planes) if use_att else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv1, bn1, _, conv2, bn2 = self.layer
        out = conv2(bn1.act(conv1(x), "relu"))
        att = self.channel_att
        if att is None:
            return bn2.act(out, "relu", residual=x)
        if self.training:
            return torch.relu(att(bn2(out)) + x)
        # eval: the gate from BN's mean, mean(x * s + b) = s * mean(x) + b
        # (a BN pass over the (N, C) means), then BN, the gate, the residual
        # and the ReLU in one pass
        mean = out.mean(dim=(2, 3), keepdim=True, dtype=torch.float32)
        gate = att.gate(bn2(mean), out.dtype)
        return bn2.act(out, "relu", residual=x, gate=gate)


class SpatialAtt(nn.Module):
    """Spatial attention: 3x3 conv to 4 channels + BN + ReLU, 3x3 conv
    with bias to 1 channel, sigmoid gate on every channel."""

    def __init__(self, channels: int):
        super().__init__()
        self.snet = nn.Sequential(
            Conv2d(channels, 4, 3, 1, 1, bias=False), BN(4), nn.ReLU(),
            Conv2d(4, 1, 3, 1, 1, bias=True), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.snet(x)


class CSAtt(nn.Module):
    """Channel attention, then spatial attention."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        self.channel_att = ChannelAtt(channels, reduction)
        self.spatial_att = SpatialAtt(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.spatial_att(self.channel_att(x))


class BasicBlockV2(nn.Module):
    """BasicBlock with channel and spatial attention (`CSAtt`) before the
    residual add; the second conv may be dilated. No shipped config
    builds it."""

    def __init__(self, planes: int, dilation: int = 1, use_att: bool = True):
        super().__init__()
        self.layer = nn.Sequential(
            Conv2d(planes, planes, 3, 1, 1, bias=False), BN(planes), nn.ReLU(),
            Conv2d(planes, planes, 3, 1, dilation, dilation=dilation,
                   bias=False), BN(planes))
        self.channel_att = CSAtt(planes) if use_att else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.layer(x)
        if self.channel_att is not None:
            out = self.channel_att(out)
        return torch.relu(out + x)


class UnbalanceBasicBlock(nn.Module):
    """Parallel (k0 x k1) and (k1 x k0) conv + BN + ReLU, concat, 3x3 conv +
    BN, residual ReLU."""

    def __init__(self, planes: int, kernel_size: Tuple[int, int],
                 padding: Tuple[int, int]):
        super().__init__()
        k0, k1 = kernel_size
        p0, p1 = padding
        self.layer7x3 = nn.Sequential(
            Conv2d(planes, planes, (k0, k1), padding=(p0, p1), bias=False),
            BN(planes), nn.ReLU())
        self.layer3x7 = nn.Sequential(
            Conv2d(planes, planes, (k1, k0), padding=(p1, p0), bias=False),
            BN(planes), nn.ReLU())
        self.layer3x3 = nn.Sequential(
            Conv2d(2 * planes, planes, 3, padding=1, bias=False), BN(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [bn.act(conv(x), "relu")
                    for conv, bn, _ in (self.layer7x3, self.layer3x7)]
        conv, bn = self.layer3x3
        return bn.act(conv(torch.cat(branches, dim=1)), "relu", residual=x)


class BasicConv2d(nn.Module):
    """conv + BN + LeakyReLU(0.01)."""

    def __init__(self, in_planes: int, out_planes: int, kernel_size: int = 3,
                 padding: int = 1):
        super().__init__()
        self.conv = Conv2d(in_planes, out_planes, kernel_size, padding=padding,
                           bias=False)
        self.bn = BN(out_planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn.act(self.conv(x), "leaky_relu")


class PointNet(nn.Module):
    """Per-point [BN,] 1x1 conv, BN [, ReLU] over (..., N, fold*C)."""

    def __init__(self, cin: int, cout: int, pre_bn: bool = False,
                 post_act: bool = True, fold: int = 1):
        super().__init__()
        self.post_act = "relu" if post_act else "none"
        layers = [BN(cin, fold)] if pre_bn else []
        layers += [PointConv(cin, cout, fold=fold), BN(cout, fold)]
        if post_act:
            layers.append(nn.ReLU())
        self.layer = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layers = list(self.layer)
        if isinstance(layers[0], BN):
            x = layers.pop(0)(x)
        conv, bn = layers[:2]
        return bn.act(conv(x), self.post_act)


class PointNetStacker(nn.Module):
    """Stacked per-point MLP."""

    def __init__(self, cin: int, cout: int, pre_bn: bool = False,
                 post_act: bool = True, stack_num: int = 1, fold: int = 1):
        super().__init__()
        if stack_num == 1:
            nets = [PointNet(cin, cout, pre_bn, post_act, fold)]
        else:
            nets = [PointNet(cin, cout, pre_bn, True, fold)]
            nets += [PointNet(cout, cout, False, True, fold)
                     for _ in range(1, stack_num - 1)]
            nets.append(PointNet(cout, cout, False, post_act, fold))
        self.layer = nn.Sequential(*nets)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer(x)


class CatFusion(nn.Module):
    """Point-level fusion: per variant, concat the sources, dropout, then
    two 1x1 conv + BN + ReLU stages (sum -> sum/2 -> out)."""

    def __init__(self, in_channels: Sequence[int], out_channel: int,
                 fold: int = 1, dropout_rate: float = 0.2):
        super().__init__()
        s = sum(in_channels)
        self.dropout = Dropout(dropout_rate)
        self.merge_layer = nn.Sequential(
            PointConv(s, s // 2, fold=fold), BN(s // 2, fold), nn.ReLU(),
            PointConv(s // 2, out_channel, fold=fold), BN(out_channel, fold),
            nn.ReLU())

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        dt = xs[0].dtype
        # dropout is elementwise: per source equals on the concat
        conv1, bn1, _, conv2, bn2, _ = self.merge_layer
        x = bn1.act(conv1([self.dropout(v.to(dt)) for v in xs]), "relu")
        return bn2.act(conv2(x), "relu")


class BranchAttFusion(nn.Module):
    """Per-source PointNet projections (`feat_model{i}`) mixed by the
    softmax of one learned weight a source (`weights`, ones at init).
    Unfolded layout only."""

    def __init__(self, in_channels: Sequence[int], out_channel: int):
        super().__init__()
        self.weights = nn.Parameter(torch.ones(len(in_channels)))
        for i, c in enumerate(in_channels):
            setattr(self, f"feat_model{i}", PointNet(c, out_channel))

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        dt = xs[0].dtype
        w = torch.softmax(self.weights.float(), dim=0).to(dt)
        out = None
        for i, x in enumerate(xs):
            proj = getattr(self, f"feat_model{i}")(x.to(dt)) * w[i]
            out = proj if out is None else out + proj
        return out


class PointAttFusion(nn.Module):
    """Per-source PointNet projections (`feat_model{i}`) stacked (..., N,
    S, C), dropout, then per point a softmax over the S sources from two
    1x1 convs over their concat (`att_layer`: S*C -> C, BN, ReLU, C -> S
    with bias), and the weighted sum. Unfolded layout only."""

    def __init__(self, in_channels: Sequence[int], out_channel: int,
                 dropout_rate: float = 0.2):
        super().__init__()
        S = len(in_channels)
        for i, c in enumerate(in_channels):
            setattr(self, f"feat_model{i}", PointNet(c, out_channel))
        self.dropout = Dropout(dropout_rate)
        self.att_layer = nn.Sequential(
            PointConv(S * out_channel, out_channel), BN(out_channel, 1),
            nn.ReLU(), PointConv(out_channel, S, bias=True))

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        dt = xs[0].dtype
        stacked = torch.stack([getattr(self, f"feat_model{i}")(x.to(dt))
                               for i, x in enumerate(xs)], dim=-2)
        stacked = self.dropout(stacked)
        att = self.att_layer(stacked.flatten(-2))
        att = torch.softmax(att, dim=-1)[..., None]
        return (stacked * att).sum(dim=-2)


def make_fusion(mode: str, in_channels: Sequence[int], out_channel: int,
                dropout_rate: float, fold: int = 1) -> nn.Module:
    """The point fusion of `fusion_mode`, as JAX's registry builds it:
    "cat" in either layout; "point_att" and "branch_att" unfolded only
    (NotImplementedError when folded, as in JAX)."""
    if mode in ("cat", "CatFusion"):
        return CatFusion(in_channels, out_channel, fold, dropout_rate)
    if fold > 1:
        raise NotImplementedError(
            f"fusion_mode {mode!r} has no folded-TTA path; run eval with "
            "tta_fold=False (the shipped configs use CatFusion)")
    if mode in ("point_att", "PointAttFusion"):
        return PointAttFusion(in_channels, out_channel, dropout_rate)
    if mode in ("branch_att", "BranchAttFusion"):
        return BranchAttFusion(in_channels, out_channel)
    raise KeyError(f"unknown fusion_mode {mode!r}")


class PredBranch(nn.Module):
    """Dropout + 1x1 classifier head with bias."""

    def __init__(self, cin: int, cout: int, fold: int = 1,
                 dropout_rate: float = 0.2):
        super().__init__()
        self.dropout = Dropout(dropout_rate)
        self.pred_layer = nn.Sequential(PointConv(cin, cout, bias=True, fold=fold))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pred_layer(self.dropout(x))
