"""Plain StreamMOS in PyTorch: the yardstick the port's outputs are judged by.

A frozen, plain copy of the network's semantics, written from the module
docstrings of the measured package and the reference recipe
(NEU-REAL/StreamMOS, arXiv:2407.17905). It imports nothing of the measured
package: no kernel, no folded layout, no fused header, no process group.

Eval runs test-time augmentation as four batch rows per stream, variant-
major (rows v * Bt + b), each flip variant with its own memory slot, and
the scores are the mean over the variants of the per-variant softmax.
Departure from per-scan TTA, noted: every scatter takes the canonical
(variant 0) cell ids and orients the grid into the variant's frame, as the
measured system defines folded TTA. The two differ only for the points in
the one-cell sliver just outside the crop (a truncation toward zero keeps
them in canonical cell 0) and for points within rounding of a cell
boundary.

Precision: every convolution and linear map passes its operands through
`Precision.gemm`; every module's output and every scatter's and gather's
output pass through `Precision.act`. In float32 (the reference; the caller
turns TF32 off) both are the identity. `FP8` (the control: the reference
computed one precision below bfloat16, its activations held in float8 as
the port holds them in bfloat16) rounds each of these tensors to float8
e4m3 with a per-tensor scale; products, sums and normalisation statistics
stay float32.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

V_TTA = 4
BN_EPS = 1e-5
# per-variant (axis-1, axis-2) index maps, variant order (+x,+y), (+x,-y),
# (-x,+y), (-x,-y); BEV axes (x cell, y cell), RV axes (theta row, phi col)
BEV_TRANSFORMS = (("id", "id"), ("id", "rev"), ("rev", "id"), ("rev", "rev"))
RV_TRANSFORMS = (("id", "id"), ("id", "revroll"), ("id", "rev"), ("id", "roll"))
SIGNS = ((1.0, 1.0), (1.0, -1.0), (-1.0, 1.0), (-1.0, -1.0))


class Precision:
    """The reference's arithmetic: float32 everywhere."""

    name = "float32"

    def gemm(self, x: torch.Tensor) -> torch.Tensor:
        return x

    act = gemm

    def attach(self, model: nn.Module) -> None:
        pass


class FP8(Precision):
    """The control: each tensor `gemm` or `act` sees rounded to float8 e4m3
    after scaling its largest magnitude to e4m3's largest finite value
    (448); in training the gradient passes each rounding unchanged."""

    name = "float8_e4m3"

    def gemm(self, x: torch.Tensor) -> torch.Tensor:
        v = x.detach()
        scale = 448.0 / v.abs().amax().float().clamp(min=1e-30)
        q = (v * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
        if not x.requires_grad:
            return q
        # the gradient passes the rounding straight through; q - v is
        # exact (Sterbenz), so the value is q's
        return x + (q - v)

    act = gemm

    def attach(self, model: nn.Module) -> None:
        """Round the floating-point tensors every module returns."""
        def rounded(out):
            if isinstance(out, torch.Tensor):
                return self.act(out) if out.is_floating_point() else out
            if isinstance(out, (list, tuple)):
                return type(out)(rounded(o) for o in out)
            if isinstance(out, dict):
                return {k: rounded(v) for k, v in out.items()}
            return out
        for m in model.modules():
            m.register_forward_hook(lambda mod, args, out: rounded(out))


class Ctx:
    """What every module reads while it runs: the precision."""

    def __init__(self, precision: Precision):
        self.p = precision


# ----------------------------------------------------------------- geometry

def quantize(pcds, range_x, range_y, range_z, size):
    """Cartesian -> fractional BEV coords (..., 3), float32, multiplying by
    the float32 reciprocal of the cell size."""
    outs = []
    for d, rng in enumerate((range_x, range_y, range_z)):
        step = (rng[1] - rng[0]) / size[d]
        outs.append((pcds[..., d] - torch.tensor(rng[0], dtype=pcds.dtype,
                                                 device=pcds.device))
                    * torch.tensor(1.0 / step, dtype=pcds.dtype,
                                   device=pcds.device))
    return torch.stack(outs, dim=-1)


def sphere_quantize(pcds, theta_range, size):
    """Cartesian -> fractional range-view coords (..., 2) as (theta row,
    phi column), phi over (-180, 180) degrees."""
    H, W = size
    c = lambda v: torch.tensor(v, dtype=pcds.dtype, device=pcds.device)
    phi_lo, phi_hi = -math.pi, math.pi
    th_lo, th_hi = (theta_range[0] * math.pi / 180.0,
                    theta_range[1] * math.pi / 180.0)
    x, y, z = pcds[..., 0], pcds[..., 1], pcds[..., 2]
    d = torch.sqrt(x * x + y * y + z * z) + c(1e-12)
    phi = c(phi_hi) - torch.atan2(x, y)
    theta = c(th_hi) - torch.asin(z / d)
    return torch.stack((theta * c(1.0 / ((th_hi - th_lo) / H)),
                        phi * c(1.0 / ((phi_hi - phi_lo) / W))), dim=-1)


def featurize(xyzi: torch.Tensor, vox: Dict) -> Dict[str, torch.Tensor]:
    """Raw (..., N, 4) -> points (..., N, 7) = (x, y, z, i, range, frac x,
    frac y), BEV coords (..., N, 3), RV coords (..., N, 2)."""
    bev = quantize(xyzi, vox["range_x"], vox["range_y"], vox["range_z"],
                   vox["bev_shape"])
    rv = sphere_quantize(xyzi, vox["rv_theta"], vox["rv_shape"])
    x, y, z = xyzi[..., 0], xyzi[..., 1], xyzi[..., 2]
    dist = torch.sqrt(x * x + y * y + z * z) + 1e-12
    pts = torch.stack((x, y, z, xyzi[..., 3], dist,
                       bev[..., 0] - torch.floor(bev[..., 0]),
                       bev[..., 1] - torch.floor(bev[..., 1])), dim=-1)
    return {"points": pts, "bev_coord": bev, "rv_coord": rv}


def tta_expand(xyzi: torch.Tensor) -> torch.Tensor:
    """(B, T, N, 4) -> (4B, T, N, 4): the four (x, y) sign flips,
    variant-major."""
    return torch.cat([xyzi * torch.tensor([sx, sy, 1.0, 1.0],
                                          device=xyzi.device)
                      for sx, sy in SIGNS], dim=0)


def _orient_axis(g: torch.Tensor, tr: str, axis: int) -> torch.Tensor:
    n = g.shape[axis]
    if tr == "id":
        return g
    if tr == "rev":
        return torch.flip(g, (axis,))
    if tr == "roll":
        return torch.roll(g, n // 2, dims=axis)
    return torch.roll(torch.flip(g, (axis,)), n // 2, dims=axis)  # revroll


def scatter_max(feat: torch.Tensor, coords0: torch.Tensor,
                out_hw: Tuple[int, int], scale: Tuple[float, float],
                kind: str) -> torch.Tensor:
    """Per-cell max of non-negative features into a zero grid.

    feat (V*B, N, C), rows variant-major; coords0 (B, N, >=2) the canonical
    rows' fractional coords. A point's cell along each axis is
    ``int(coord * scale)`` (truncated toward zero) and counts if inside the
    grid. Every variant's rows go to the canonical cells and the grid is
    then mapped into the variant's frame. Returns (V*B, H, W, C)."""
    R, N, C = feat.shape
    B = coords0.shape[0]
    V = R // B
    H, W = out_hw
    cx = (coords0[..., 0].float() * np.float32(scale[0])).to(torch.int32).long()
    cy = (coords0[..., 1].float() * np.float32(scale[1])).to(torch.int32).long()
    ok = (cx >= 0) & (cx < H) & (cy >= 0) & (cy < W)
    flat = torch.where(ok, cx * W + cy, torch.full_like(cx, H * W))
    idx = flat.repeat(V, 1)[..., None].expand(R, N, C)
    grid = torch.zeros((R, H * W + 1, C), dtype=feat.dtype, device=feat.device)
    grid = grid.scatter_reduce(1, idx, feat, "amax", include_self=True)
    grid = grid[:, :-1].reshape(V, B, H, W, C)
    trs = BEV_TRANSFORMS if kind == "bev" else RV_TRANSFORMS
    if V == 1:
        return grid[0]
    return torch.cat([_orient_axis(_orient_axis(grid[v], trs[v][0], 1),
                                   trs[v][1], 2) for v in range(V)])


def bilinear(grid: torch.Tensor, py: torch.Tensor,
             px: torch.Tensor) -> torch.Tensor:
    """grid (B, H, W, C) at pixel coords (B, N), align_corners=True taps,
    a tap outside the grid contributes 0 -> (B, N, C)."""
    B, H, W, C = grid.shape
    y0, x0 = torch.floor(py), torch.floor(px)
    fy, fx = py - y0, px - x0
    y0, x0 = y0.long(), x0.long()
    flat = grid.reshape(B * H * W, C)
    base = (torch.arange(B, device=grid.device) * (H * W))[:, None]
    out = 0.0
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            y, x = y0 + dy, x0 + dx
            ok = (y >= 0) & (y < H) & (x >= 0) & (x < W)
            rows = flat[(base + y.clamp(0, H - 1) * W
                         + x.clamp(0, W - 1)).reshape(-1)].reshape(B, -1, C)
            out = out + rows * (wy * wx * ok)[..., None]
    return out


def grid_to_point(grid_nchw: torch.Tensor, coords: torch.Tensor,
                  scale: Tuple[float, float]) -> torch.Tensor:
    """Sample an NCHW grid at each row's own coords (B, N, 2) x scale."""
    g = grid_nchw.permute(0, 2, 3, 1)
    return bilinear(g, coords[..., 0].float() * np.float32(scale[0]),
                    coords[..., 1].float() * np.float32(scale[1]))


def resize_align_corners(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """NCHW bilinear resize, align_corners=True."""
    if tuple(x.shape[2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=hw, mode="bilinear", align_corners=True)


def maxpool3x3(x: torch.Tensor, stride: int) -> torch.Tensor:
    """3x3 max-pool, -inf padding 1, as pairwise maxima (the gradient of a
    tie halves between the tied inputs, as `jax.lax.max` gives it)."""
    xp = F.pad(x, (1, 1, 1, 1), value=float("-inf"))
    m = torch.maximum(torch.maximum(xp[..., :-2], xp[..., 1:-1]), xp[..., 2:])
    m = torch.maximum(torch.maximum(m[..., :-2, :], m[..., 1:-1, :]),
                      m[..., 2:, :])
    return m[..., ::stride, ::stride]


# ------------------------------------------------------------------ modules

class BN(nn.BatchNorm2d):
    """BatchNorm over `ch` with the running statistics (eval)."""

    def __init__(self, n: int, ctx: Ctx):
        super().__init__(n, eps=BN_EPS)
        self.ctx = ctx

    def forward(self, x: torch.Tensor, ch: int = 1) -> torch.Tensor:
        shape = [1] * x.ndim
        shape[ch] = -1
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale.view(shape) + shift.view(shape)


class Conv(nn.Conv2d):
    def __init__(self, ctx: Ctx, cin, cout, k, stride=1, padding=0,
                 bias=False):
        super().__init__(cin, cout, k, stride, padding, bias=bias)
        self.ctx = ctx

    def forward(self, x):
        p = self.ctx.p
        return p.act(F.conv2d(p.gemm(x), p.gemm(self.weight), self.bias,
                               self.stride, self.padding))


class Lin(nn.Linear):
    def __init__(self, ctx: Ctx, cin, cout):
        super().__init__(cin, cout)
        self.ctx = ctx

    def forward(self, x):
        p = self.ctx.p
        return p.act(F.linear(p.gemm(x), p.gemm(self.weight), self.bias))


class PointConv(nn.Module):
    """A 1x1 convolution over points (..., N, C): weight (cout, cin, 1, 1);
    a list input is concatenated on channels first."""

    def __init__(self, ctx: Ctx, cin, cout, bias=False):
        super().__init__()
        self.ctx = ctx
        self.weight = nn.Parameter(torch.zeros(cout, cin, 1, 1))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        if isinstance(x, (list, tuple)):
            x = torch.cat(list(x), dim=-1)
        p = self.ctx.p
        return p.act(F.linear(p.gemm(x), p.gemm(self.weight[:, :, 0, 0]),
                              self.bias))


class DownSample2D(nn.Module):
    def __init__(self, ctx, cin, cout, stride):
        super().__init__()
        self.stride = stride
        self.conv_branch = nn.Sequential(Conv(ctx, cin, cout, 3, stride, 1),
                                         BN(cout, ctx))
        self.pool_branch = nn.Sequential(Conv(ctx, cin, cout, 1),
                                         BN(cout, ctx))

    def forward(self, x):
        a = self.conv_branch[1](self.conv_branch[0](x))
        b = self.pool_branch[1](self.pool_branch[0](x))
        return torch.relu(a + maxpool3x3(b, self.stride))


class ChannelAtt(nn.Module):
    def __init__(self, ctx, c, r=4):
        super().__init__()
        self.cnet = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                  Conv(ctx, c, c // r, 1, bias=True), nn.ReLU(),
                                  Conv(ctx, c // r, c, 1, bias=True),
                                  nn.Sigmoid())

    def forward(self, x):
        ca = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.cnet[3](torch.relu(self.cnet[1](ca))))


class BasicBlock(nn.Module):
    def __init__(self, ctx, c, use_att):
        super().__init__()
        self.layer = nn.Sequential(Conv(ctx, c, c, 3, 1, 1), BN(c, ctx),
                                   nn.ReLU(), Conv(ctx, c, c, 3, 1, 1),
                                   BN(c, ctx))
        self.channel_att = ChannelAtt(ctx, c) if use_att else None

    def forward(self, x):
        out = self.layer[4](self.layer[3](torch.relu(
            self.layer[1](self.layer[0](x)))))
        if self.channel_att is not None:
            out = self.channel_att(out)
        return torch.relu(out + x)


class UnbalanceBasicBlock(nn.Module):
    def __init__(self, ctx, c, k):
        super().__init__()
        k0, k1 = k
        self.layer7x3 = nn.Sequential(
            Conv(ctx, c, c, (k0, k1), 1, (k0 // 2, k1 // 2)), BN(c, ctx),
            nn.ReLU())
        self.layer3x7 = nn.Sequential(
            Conv(ctx, c, c, (k1, k0), 1, (k1 // 2, k0 // 2)), BN(c, ctx),
            nn.ReLU())
        self.layer3x3 = nn.Sequential(Conv(ctx, 2 * c, c, 3, 1, 1),
                                      BN(c, ctx))

    def forward(self, x):
        a = torch.relu(self.layer7x3[1](self.layer7x3[0](x)))
        b = torch.relu(self.layer3x7[1](self.layer3x7[0](x)))
        y = self.layer3x3[1](self.layer3x3[0](torch.cat([a, b], dim=1)))
        return torch.relu(y + x)


class ConvStage(nn.Sequential):
    def __init__(self, ctx, cin, cout, n, stride=1, unbalance=None):
        layers = [DownSample2D(ctx, cin, cout, stride)]
        for i in range(n):
            if i == 0 and unbalance is not None:
                layers.append(UnbalanceBasicBlock(ctx, cout, unbalance))
            else:
                layers.append(BasicBlock(ctx, cout, False))
        layers.append(BasicBlock(ctx, cout, True))
        super().__init__(*layers)


class BasicConv2d(nn.Module):
    """conv + BN + leaky ReLU (0.01)."""

    def __init__(self, ctx, cin, cout, k=3, padding=1):
        super().__init__()
        self.conv = Conv(ctx, cin, cout, k, 1, padding)
        self.bn = BN(cout, ctx)

    def forward(self, x):
        x = self.bn(self.conv(x))
        return torch.where(x >= 0, x, 0.01 * x)


class MSDeformAttn(nn.Module):
    def __init__(self, ctx, d, heads, points):
        super().__init__()
        self.ctx, self.heads, self.points = ctx, heads, points
        self.value_proj = Lin(ctx, d, d)
        self.sampling_offsets = Lin(ctx, d, heads * points * 2)
        self.attention_weights = Lin(ctx, d, heads * points)
        self.output_proj = Lin(ctx, d, d)

    def forward(self, query, refs, src, hw):
        B, L, C = query.shape
        H, W = hw
        M, P = self.heads, self.points
        Dh = C // M
        act = self.ctx.p.act  # the port computes these in its compute dtype
        value = self.value_proj(src).reshape(B, H, W, M, Dh)
        off = self.sampling_offsets(query).reshape(B, L, M, P, 2)
        attn = act(torch.softmax(self.attention_weights(query).reshape(
            B, L, M, P), dim=-1))
        loc = act(refs[None, :, None, None, :] + off / torch.tensor(
            [W, H], dtype=query.dtype, device=query.device))
        # grid_sample, align_corners=False, zero padding, per (batch, head)
        px = loc[..., 0] * W - 0.5
        py = loc[..., 1] * H - 0.5
        table = value.permute(0, 3, 1, 2, 4).reshape(B * M, H, W, Dh)
        py = py.permute(0, 2, 1, 3).reshape(B * M, L * P)
        px = px.permute(0, 2, 1, 3).reshape(B * M, L * P)
        samp = act(bilinear(table, py, px)).reshape(B, M, L, P, Dh)
        out = act((samp * attn.permute(0, 2, 1, 3)[..., None]).sum(3))
        return self.output_proj(out.permute(0, 2, 1, 3).reshape(B, L, C))


class DeformAttnLayer(nn.Module):
    def __init__(self, ctx, d, ffn, heads, points):
        super().__init__()
        self.cross_attn = MSDeformAttn(ctx, d, heads, points)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.linear1 = Lin(ctx, d, ffn)
        self.linear2 = Lin(ctx, ffn, d)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)

    def forward(self, q, refs, src, hw):
        q = self.norm1(q + self.cross_attn(q, refs, src, hw))
        f = self.linear2(torch.relu(self.linear1(q)))
        return self.norm2(q + f)


class DeformAttnModule(nn.Module):
    def __init__(self, ctx, n, d, ffn, heads, points):
        super().__init__()
        self.deformattn_layers = nn.ModuleList(
            DeformAttnLayer(ctx, d, ffn, heads, points)
            for _ in range(n))

    def forward(self, q, src, hw):
        H, W = hw
        ys = (torch.arange(H, dtype=torch.float32, device=q.device) + 0.5) / H
        xs = (torch.arange(W, dtype=torch.float32, device=q.device) + 0.5) / W
        ry, rx = torch.meshgrid(ys, xs, indexing="ij")
        refs = torch.stack([rx.reshape(-1), ry.reshape(-1)], dim=-1)
        for layer in self.deformattn_layers:
            q = layer(q, refs, src, hw)
        return q


class MultiViewEncoder(nn.Module):
    def __init__(self, ctx, m: Dict):
        super().__init__()
        self.ctx, self.m = ctx, m
        c0, c1, c2, c3 = m["context_layers"]
        n1, n2, n3 = m["layers"]
        T = m["seq_num"]
        self.header_bev = ConvStage(ctx, T * c0, c1, n1, 2, (7, 3))
        self.header_rv = ConvStage(ctx, c1, c1, n1 - 1, 1)
        self.res1_bev = ConvStage(ctx, 2 * c1, c2, n2, 2, (5, 3))
        self.res1_rv = ConvStage(ctx, c2, c2, n2 - 1, 1)
        self.res2 = ConvStage(ctx, 2 * c2, c3, n3, 2)
        hq, wq = m["query_hw"]
        self.query_embed = nn.Embedding(hq * wq, m["d_model"])
        self.deformattn_module = DeformAttnModule(
            ctx, m["n_attn_layers"], m["d_model"], m["ffn_dim"], m["n_heads"],
            m["n_points"])
        self.conv_1 = BasicConv2d(ctx, 2 * c1 + 2 * c2 + c3, 128)
        self.conv_2 = BasicConv2d(ctx, 128, out_channels(m))
        cls = m["class_num"]
        self.aux_head1 = Conv(ctx, 2 * c1, cls, 1, bias=True)
        self.aux_head2 = Conv(ctx, 2 * c2, cls, 1, bias=True)
        self.aux_head3 = Conv(ctx, c3, cls, 1, bias=True)

    def forward(self, bev, bev_coord, rv_coord, memory, use_memory,
                variants: int):
        """bev (R, T*c0, H, W); bev_coord, rv_coord (R, N, 2) each row's own
        current-frame coords, rows variant-major over `variants`; memory
        (R, Hq, Wq, D)."""
        rv_h, rv_w = self.m["voxel"]["rv_shape"]
        B0 = bev_coord.shape[0] // variants
        bev0, rv0 = bev_coord[:B0], rv_coord[:B0]

        act = self.ctx.p.act

        def scat(pts, coords0, hw, scale, kind):
            return act(scatter_max(pts, coords0, hw, scale, kind)
                       ).permute(0, 3, 1, 2)

        def gather(grid, coords, scale):
            return act(grid_to_point(grid, coords, scale))

        x0 = self.header_bev(bev)
        p = gather(x0, bev_coord, (0.5, 0.5))
        r = self.header_rv(scat(p, rv0, (rv_h // 2, rv_w // 2), (0.5, 0.5), "rv"))
        p = gather(r, rv_coord, (0.5, 0.5))
        h0, w0 = x0.shape[2:]
        x0 = torch.cat([x0, scat(p, bev0, (h0, w0), (0.5, 0.5), "bev")], 1)

        x1 = self.res1_bev(x0)
        p = gather(x1, bev_coord, (0.25, 0.25))
        r = self.res1_rv(scat(p, rv0, (rv_h // 4, rv_w // 4), (0.25, 0.25), "rv"))
        p1 = gather(r, rv_coord, (0.25, 0.25))
        h1, w1 = x1.shape[2:]
        x1 = torch.cat([x1, scat(p1, bev0, (h1, w1), (0.25, 0.25), "bev")], 1)

        x2 = self.res2(x1)
        R, d, hq, wq = x2.shape
        if use_memory:
            query = memory.reshape(R, hq * wq, d)
        else:
            query = self.query_embed.weight[None].expand(R, hq * wq, d)
        src = x2.permute(0, 2, 3, 1).reshape(R, hq * wq, d)
        fused = self.deformattn_module(query, src, (hq, wq))
        new_memory = fused.reshape(R, hq, wq, d)
        x2 = new_memory.permute(0, 3, 1, 2)

        res_1 = resize_align_corners(x1, (h0, w0))
        res_2 = resize_align_corners(x2, (h0, w0))
        out = self.conv_2(self.conv_1(torch.cat([x0, res_1, res_2], 1)))
        aux = [head(x).permute(0, 2, 3, 1) for head, x in
               ((self.aux_head1, x0), (self.aux_head2, res_1),
                (self.aux_head3, res_2))]
        return out, p1, aux, new_memory


class PointNet(nn.Module):
    def __init__(self, ctx, cin, cout, pre_bn):
        super().__init__()
        layers = [BN(cin, ctx)] if pre_bn else []
        layers += [PointConv(ctx, cin, cout), BN(cout, ctx), nn.ReLU()]
        self.layer = nn.Sequential(*layers)

    def forward(self, x):
        for mod in self.layer:
            x = mod(x, -1) if isinstance(mod, BN) else mod(x)
        return x


class PointNetStacker(nn.Module):
    def __init__(self, ctx, cin, cout):
        super().__init__()
        self.layer = nn.Sequential(PointNet(ctx, cin, cout, True),
                                   PointNet(ctx, cout, cout, False))

    def forward(self, x):
        return self.layer[1](self.layer[0](x))


class CatFusion(nn.Module):
    def __init__(self, ctx, ins: Sequence[int], out: int):
        super().__init__()
        s = sum(ins)
        self.merge_layer = nn.Sequential(
            PointConv(ctx, s, s // 2), BN(s // 2, ctx), nn.ReLU(),
            PointConv(ctx, s // 2, out), BN(out, ctx), nn.ReLU())

    def forward(self, xs):
        m = self.merge_layer
        x = m[0](xs)
        x = torch.relu(m[1](x, -1))
        return torch.relu(m[4](m[3](x), -1))


class PredBranch(nn.Module):
    def __init__(self, ctx, cin, cout):
        super().__init__()
        self.pred_layer = nn.Sequential(PointConv(ctx, cin, cout, bias=True))

    def forward(self, x):
        return self.pred_layer[0](x)


class RefineBranch(nn.Module):
    def __init__(self, ctx, m, ins):
        super().__init__()
        c = m["point_feat_out_channels"]
        self.bf_point_post = CatFusion(ctx, ins, c)
        self.bf_pred_layer = PredBranch(ctx, c, m["class_num"])

    def forward(self, feats):
        return self.bf_pred_layer(self.bf_point_post(feats))


def out_channels(m: Dict) -> int:
    _, c1, c2, c3 = m["context_layers"]
    return ((c3 + c2) // 2 + c1) // 2


class StreamMOS(nn.Module):
    """One frame's forward over R rows (streams x variants)."""

    def __init__(self, m: Dict, with_refine: bool,
                 precision: Precision = Precision()):
        super().__init__()
        self.ctx = Ctx(precision)
        self.m = m
        ctx = self.ctx
        c0, _, c2, _ = m["context_layers"]
        ins = (c0, out_channels(m), c2)
        self.point_pre = PointNetStacker(ctx, 7, c0)
        self.bev_net = MultiViewEncoder(ctx, self.m)
        self.point_post = CatFusion(ctx, ins, m["point_feat_out_channels"])
        self.pred_layer = PredBranch(ctx, m["point_feat_out_channels"],
                                     m["class_num"])
        self.with_refine = with_refine
        if with_refine:
            self.refine = RefineBranch(ctx, m, ins)
        precision.attach(self)

    def forward(self, pts, bev_coord, rv_coord, memory, use_memory: bool,
                variants: int = 1) -> Dict[str, torch.Tensor]:
        """pts (R, T, N, 7), bev_coord (R, T, N, 3), rv_coord (R, T, N, 2),
        rows variant-major over `variants` flip variants."""
        H, W = self.m["voxel"]["bev_shape"][:2]
        c0 = self.m["context_layers"][0]
        R, T, N, _ = pts.shape
        B0 = R // variants
        feat = self.point_pre(pts.reshape(R * T, N, 7))
        coords0 = bev_coord[:B0].reshape(B0 * T, N, 3)[..., :2]
        # rows (v, b, t) -> canonical rows (b, t)
        act = self.ctx.p.act
        grid = act(scatter_max(feat, coords0, (H, W), (1.0, 1.0), "bev"))
        bev = grid.reshape(R, T, H, W, c0).permute(0, 1, 4, 2, 3).reshape(
            R, T * c0, H, W)
        cur_bev = bev_coord[:, 0, :, :2]
        cur_rv = rv_coord[:, 0]
        bev_feat, p1, aux, memory = self.bev_net(bev, cur_bev, cur_rv, memory,
                                                 use_memory, variants)
        feats = [feat.reshape(R, T, N, c0)[:, 0],
                 act(grid_to_point(bev_feat, cur_bev,
                                   tuple(self.m["grid2point_scale"]))), p1]
        out = {"pred": self.pred_layer(self.point_post(feats)),
               "aux": aux, "memory": memory}
        if self.with_refine:
            out["bf_pred"] = self.refine(feats)
        return out


def memory_zeros(m: Dict, rows: int, device) -> torch.Tensor:
    hq, wq = m["query_hw"]
    return torch.zeros((rows, hq, wq, m["d_model"]), device=device)


@torch.no_grad()
def eval_frame(model: StreamMOS, xyzi: torch.Tensor, memory: torch.Tensor,
               use_memory: bool):
    """One frame of `Bt` streams: xyzi (Bt, T, N, 4), memory (4 Bt, Hq, Wq,
    D) -> (scores (Bt, N, classes), bf_scores or None, new memory)."""
    Bt = xyzi.shape[0]
    b = featurize(tta_expand(xyzi), model.m["voxel"])
    out = model(b["points"], b["bev_coord"], b["rv_coord"], memory,
                use_memory, variants=V_TTA)

    def mean_softmax(logits):
        return torch.softmax(logits, -1).reshape(V_TTA, Bt, *logits.shape[1:]
                                                 ).mean(0)

    bf = mean_softmax(out["bf_pred"]) if "bf_pred" in out else None
    return mean_softmax(out["pred"]), bf, out["memory"]
