"""The eval BatchNorm epilogue (`ops/bn_act.py`) on the CPU: its plain
version against the composition the port's modules ran before it (BN's
eval affine cast to the activation dtype and applied by `addcmul`, then
the gate, the residual add and the activation, each its own op), in every
layout the kernel takes; each block that fuses its BN into it, in eval,
against the same composition; train mode and eval with gradients, which
launch nothing; the calls it rejects; and the kernel's channel walk,
mirrored in Python. The kernel itself runs in `tests/test_torch_cuda.py`.

Tolerances: float32, rtol 1e-6 and atol 1e-5 (scale as weight /
sqrt(var + eps) against weight * rsqrt(var + eps), x * s + b against
addcmul's, a few float32 roundings on values up to about 10); the blocks,
rtol = atol = 1e-5 (their convolutions add no rounding of their own, the
channel attention's mean is taken before the BN affine instead of after
it).
"""
import numpy as np
import pytest
import torch

from streammos_tpu_torch.nn import blocks as tb
from streammos_tpu_torch.ops import bn_act as ba
from streammos_tpu_torch.tools import kernel_times as kt
from streammos_tpu_torch.utils import profiling

TOL = dict(rtol=1e-6, atol=1e-5)
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
ACTS = ("none", "relu", "leaky_relu")
# name: (shape, C, fold, memory format)
LAYOUTS = {
    "nchw": ((2, 5, 3, 4), 5, 0, torch.contiguous_format),
    "nhwc": ((2, 5, 3, 4), 5, 0, torch.channels_last),
    # the point MLP's input BN: C = 7, four variants folded, rows of 28
    "point_c7_fold4": ((2, 9, 28), 7, 4, torch.contiguous_format),
    "point_c16_fold1": ((3, 11, 16), 16, 1, torch.contiguous_format),
}


def _count():
    return profiling.counters().get("kernel.bn_act", 0)


def _randomize(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every BN's affine and running statistics off their init."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, tb.BN):
            C = m.num_features
            m.weight.data.copy_(torch.rand(C, generator=g) + 0.5)
            m.bias.data.copy_(torch.randn(C, generator=g) * 0.3)
            m.running_mean.copy_(torch.randn(C, generator=g) * 0.3)
            m.running_var.copy_(torch.rand(C, generator=g) * 1.5 + 0.25)
    return module


def _bn(C: int, fold: int, seed: int = 0) -> tb.BN:
    return _randomize(tb.BN(C, fold), seed).eval()


def _input(shape, fmt, seed: int) -> torch.Tensor:
    x = torch.randn(shape, generator=torch.Generator().manual_seed(seed))
    return x.contiguous(memory_format=fmt) if len(shape) == 4 else x


# ---- the composition before the epilogue -----------------------------------

def old_bn_act(bn, x, act="none", residual=None, gate=None):
    """BN's eval before the epilogue, `kernel_times.bn_library`: the affine
    cast to x's dtype and applied by addcmul, then the gate, the residual
    add and the activation."""
    return kt.bn_library(x, bn.weight, bn.bias, bn.running_mean,
                         bn.running_var, bn.eps, bn.fold, act, residual, gate)


def old_bn(bn: tb.BN, x: torch.Tensor) -> torch.Tensor:
    return old_bn_act(bn, x)


def old_channel_att(att: tb.ChannelAtt, x):
    ca = x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)
    return x * torch.sigmoid(att.cnet[3](torch.relu(att.cnet[1](ca))))


def old_basic_block(block: tb.BasicBlock, x):
    conv1, bn1, _, conv2, bn2 = block.layer
    out = old_bn(bn2, conv2(torch.relu(old_bn(bn1, conv1(x)))))
    if block.channel_att is not None:
        out = old_channel_att(block.channel_att, out)
    return torch.relu(out + x)


def old_unbalance(block: tb.UnbalanceBasicBlock, x):
    branches = [torch.relu(old_bn(bn, conv(x)))
                for conv, bn, _ in (block.layer7x3, block.layer3x7)]
    conv, bn = block.layer3x3
    return torch.relu(old_bn(bn, conv(torch.cat(branches, 1))) + x)


def old_downsample(block: tb.DownSample2D, x):
    (c3, b3), (c1, b1) = block.conv_branch, block.pool_branch
    pool = tb.maxpool3x3(old_bn(b1, c1(x)), block.stride)
    return torch.relu(old_bn(b3, c3(x)) + pool)


def old_basic_conv(block: tb.BasicConv2d, x):
    y = old_bn(block.bn, block.conv(x))
    return torch.where(y >= 0, y, 0.01 * y)


def old_point_net(block: tb.PointNet, x):
    layers = list(block.layer)
    if isinstance(layers[0], tb.BN):
        x = old_bn(layers.pop(0), x)
    y = old_bn(layers[1], layers[0](x))
    return torch.relu(y) if len(layers) == 3 else y


def old_cat_fusion(block: tb.CatFusion, xs):
    conv1, bn1, _, conv2, bn2, _ = block.merge_layer
    y = torch.relu(old_bn(bn1, conv1(list(xs))))
    return torch.relu(old_bn(bn2, conv2(y)))


# ---- the plain version -----------------------------------------------------

@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_plain_version_matches_the_old_composition(layout, act, residual):
    shape, C, fold, fmt = LAYOUTS[layout]
    bn = _bn(C, fold)
    x = _input(shape, fmt, 1) * 3
    r = _input(shape, fmt, 2) if residual else None
    before = _count()
    got = ba.bn_act(x, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                    bn.eps, fold, act, r)
    assert _count() == before  # the CPU runs the plain version
    assert got.dtype == x.dtype and got.stride() == x.stride()
    torch.testing.assert_close(got, old_bn_act(bn, x, act, r), **TOL)
    torch.testing.assert_close(bn.act(x, act, r), got, rtol=0, atol=0)


@pytest.mark.parametrize("act", ACTS)
def test_plain_version_rounds_once_to_bfloat16(act):
    """In bfloat16 the plain version is its float32 result rounded once."""
    shape, C, fold, fmt = LAYOUTS["nhwc"]
    bn = _bn(C, fold)
    x, r = (_input(shape, fmt, s).bfloat16() for s in (3, 4))
    g = torch.rand(shape[0], C, 1, 1, generator=torch.Generator()
                   .manual_seed(5)).bfloat16()
    args = (bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps, 0,
            act)
    want = ba.bn_act(x.float(), *args, r.float(), g.float()).bfloat16()
    assert torch.equal(ba.bn_act(x, *args, r, g), want)


def test_gate_scales_each_sample_and_channel():
    shape, C, fold, fmt = LAYOUTS["nhwc"]
    bn = _bn(C, fold)
    x, r = _input(shape, fmt, 6), _input(shape, fmt, 7)
    g = torch.rand(shape[0], C, generator=torch.Generator().manual_seed(8))
    got = ba.bn_act(x, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                    bn.eps, 0, "relu", r, g)
    want = torch.relu(old_bn(bn, x) * g[:, :, None, None] + r)
    torch.testing.assert_close(got, want, **TOL)


# ---- the blocks in eval ----------------------------------------------------

def _conv_block(kind: str):
    C = 8
    if kind == "basic":
        return tb.BasicBlock(C, use_att=False), old_basic_block, C
    if kind == "basic_att":
        return tb.BasicBlock(C, use_att=True), old_basic_block, C
    if kind == "unbalance":
        return (tb.UnbalanceBasicBlock(C, (5, 3), (2, 1)), old_unbalance, C)
    if kind == "downsample_s1":
        return tb.DownSample2D(6, C, 1), old_downsample, 6
    if kind == "downsample_s2":
        return tb.DownSample2D(6, C, 2), old_downsample, 6
    return tb.BasicConv2d(6, C), old_basic_conv, 6


@pytest.mark.parametrize("fmt", ["nchw", "nhwc"])
@pytest.mark.parametrize("kind", ["basic", "basic_att", "unbalance",
                                  "downsample_s1", "downsample_s2",
                                  "basic_conv"])
def test_conv_block_in_eval_matches_the_old_composition(kind, fmt):
    torch.manual_seed(0)
    block, old, cin = _conv_block(kind)
    block = _randomize(block, 1).eval()
    x = torch.randn(2, cin, 9, 10, generator=torch.Generator().manual_seed(2))
    if fmt == "nhwc":
        x = x.contiguous(memory_format=torch.channels_last)
    before = _count()
    with torch.inference_mode():
        got = block(x)
        want = old(block, x)
    assert _count() == before
    torch.testing.assert_close(got, want, **BLOCK_TOL)


@pytest.mark.parametrize("fold", [1, 4])
@pytest.mark.parametrize("kind", ["pre_bn", "post_act", "no_act", "cat"])
def test_point_block_in_eval_matches_the_old_composition(kind, fold):
    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(3)
    if kind == "cat":
        block = tb.CatFusion((4, 6, 2), 5, fold)
        xs = [torch.randn(2, 7, fold * c, generator=gen) for c in (4, 6, 2)]
        old = old_cat_fusion
    else:
        cin = 7 if kind == "pre_bn" else 6
        block = tb.PointNet(cin, 5, pre_bn=kind == "pre_bn",
                            post_act=kind != "no_act", fold=fold)
        xs = torch.randn(2, 7, fold * cin, generator=gen)
        old = old_point_net
    block = _randomize(block, 4).eval()
    with torch.inference_mode():
        torch.testing.assert_close(block(xs), old(block, xs), **BLOCK_TOL)


# ---- paths that launch nothing ---------------------------------------------

@pytest.mark.parametrize("kind", ["basic_att", "unbalance", "downsample_s2",
                                  "basic_conv"])
def test_train_mode_runs_the_train_composition(kind):
    """Train mode: batch statistics, then the residual, the gate and the
    activation as separate ops, bit for bit what the blocks ran before;
    the running statistics move alike; nothing counted."""
    torch.manual_seed(0)
    block, _, cin = _conv_block(kind)
    block = _randomize(block, 5)
    twin = _randomize(_conv_block(kind)[0], 5)
    twin.load_state_dict(block.state_dict())
    block.train(), twin.train()
    x = torch.randn(2, cin, 9, 10, generator=torch.Generator().manual_seed(6))
    before = _count()
    got = block(x)
    assert _count() == before
    want = _train_composition(twin, x)
    assert torch.equal(got, want)
    for (k, a), b in zip(block.state_dict().items(),
                         twin.state_dict().values()):
        assert torch.equal(a, b), k


def _train_composition(block, x):
    """The blocks' train forward before the epilogue (BN.forward in train
    mode is `_train_forward`)."""
    bn = lambda m, t: m._train_forward(t)
    if isinstance(block, tb.BasicBlock):
        conv1, bn1, _, conv2, bn2 = block.layer
        out = bn(bn2, conv2(torch.relu(bn(bn1, conv1(x)))))
        if block.channel_att is not None:
            out = old_channel_att(block.channel_att, out)
        return torch.relu(out + x)
    if isinstance(block, tb.UnbalanceBasicBlock):
        branches = [torch.relu(bn(b, c(x)))
                    for c, b, _ in (block.layer7x3, block.layer3x7)]
        c, b = block.layer3x3
        return torch.relu(bn(b, c(torch.cat(branches, 1))) + x)
    if isinstance(block, tb.DownSample2D):
        (c3, b3), (c1, b1) = block.conv_branch, block.pool_branch
        conv_b = bn(b3, c3(x))
        return torch.relu(conv_b + tb.maxpool3x3(bn(b1, c1(x)),
                                                 block.stride))
    y = bn(block.bn, block.conv(x))
    return torch.where(y >= 0, y, 0.01 * y)


def test_eval_with_gradients_runs_the_plain_version():
    """Eval with autograd on: the plain version, differentiable in x and
    the affine, its gradients those of the old composition; nothing
    counted."""
    torch.manual_seed(0)
    block = _randomize(tb.BasicBlock(8, use_att=True), 7).eval()
    x = torch.randn(2, 8, 9, 10, generator=torch.Generator().manual_seed(8))
    grads = []
    for fn in (block, lambda t: old_basic_block(block, t)):
        xg = x.clone().requires_grad_(True)
        block.zero_grad()
        before = _count()
        fn(xg).square().sum().backward()
        assert _count() == before
        bn2 = block.layer[4]
        grads.append([xg.grad, bn2.weight.grad.clone(),
                      bn2.bias.grad.clone()])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_the_gate_is_eval_only():
    bn = _bn(5, 0).train()
    x = torch.randn(2, 5, 3, 4)
    with pytest.raises(ValueError, match="eval-only"):
        bn.act(x, "relu", gate=torch.ones(2, 5))


# ---- what it rejects -------------------------------------------------------

def _rejected(case: str):
    bn = _bn(5, 0)
    x = torch.randn(2, 5, 3, 4)
    kw = {}
    fold, act = 0, "relu"
    if case == "strides":
        x = x.transpose(2, 3)
    elif case == "residual_layout":
        kw["residual"] = x.contiguous(memory_format=torch.channels_last)
    elif case == "residual_shape":
        kw["residual"] = torch.randn(2, 5, 3, 3)
    elif case == "residual_dtype":
        kw["residual"] = x.double()
    elif case == "dtype":
        x = x.half()
    elif case == "device":
        kw["residual"] = torch.empty(x.shape, device="meta")
    elif case == "unknown_device":
        x = torch.empty(x.shape, device="meta")
        bn = bn.to("meta")
    elif case == "channels":
        x = torch.randn(2, 6, 3, 4)
    elif case == "rank":
        x = torch.randn(2, 5, 12)
    elif case == "fold_width":
        bn, fold, x = _bn(7, 4), 4, torch.randn(2, 9, 27)
    elif case == "point_strides":
        bn, fold, x = _bn(7, 4), 4, torch.randn(9, 2, 28).transpose(0, 1)
    elif case == "gate_with_fold":
        bn, fold, x = _bn(7, 4), 4, torch.randn(2, 9, 28)
        kw["gate"] = torch.ones(2, 7)
    elif case == "gate_shape":
        kw["gate"] = torch.ones(2, 4)
    elif case == "buffer_shape":
        bn.running_var = torch.ones(4)
    elif case == "act":
        act = "gelu"
    return x, bn, fold, act, kw


@pytest.mark.parametrize("case,error", [
    ("strides", ValueError), ("residual_layout", ValueError),
    ("residual_shape", ValueError), ("residual_dtype", ValueError),
    ("dtype", TypeError), ("device", ValueError),
    ("unknown_device", ValueError), ("channels", ValueError),
    ("rank", ValueError), ("fold_width", ValueError),
    ("point_strides", ValueError), ("gate_with_fold", ValueError),
    ("gate_shape", ValueError), ("buffer_shape", ValueError),
    ("act", ValueError)])
def test_rejects_what_the_kernel_cannot_take(case, error):
    x, bn, fold, act, kw = _rejected(case)
    with torch.inference_mode(), pytest.raises(error):
        ba.bn_act(x, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                  bn.eps, fold, act, **kw)


# ---- the kernel's channel walk ---------------------------------------------

def _quot(n: int, d: int) -> int:
    """`quot` of csrc/bn_act.cu: a multiply-high, an add and a shift."""
    s = 0
    while s < 31 and (1 << s) < d:
        s += 1
    m = (((1 << 32) * ((1 << s) - d)) // d + 1) & 0xFFFFFFFF
    return ((((n * m) >> 32) + n) & 0xFFFFFFFF) >> s


def _walk(total, inner, C, per_sample, vec):
    """Channel and sample of each element as the kernel's vectors find
    them: two divisions at a vector's first element, then counting."""
    chans, samples = np.empty(total, np.int64), np.empty(total, np.int64)
    for e in range(0, total, vec):
        q = _quot(e, inner)
        at, c = e - q * inner, q - _quot(q, C) * C
        n = _quot(e, per_sample)
        in_sample = e - n * per_sample
        for i in range(e, min(e + vec, total)):
            chans[i], samples[i] = c, n
            at += 1
            if at == inner:
                at = 0
                c = 0 if c + 1 == C else c + 1
            in_sample += 1
            if in_sample == per_sample:
                in_sample, n = 0, n + 1
    return chans, samples


@pytest.mark.parametrize("shape,C,fold,fmt,vec", [
    (*LAYOUTS["nchw"], 8), (*LAYOUTS["nhwc"], 8), (*LAYOUTS["nhwc"], 4),
    (*LAYOUTS["point_c7_fold4"], 8), ((3, 7, 5, 1), 7, 0,
                                      torch.contiguous_format, 8),
    ((2, 3, 1, 1), 3, 0, torch.contiguous_format, 4)])
def test_kernel_channel_walk_matches_the_layout(shape, C, fold, fmt, vec):
    x = torch.empty(shape).contiguous(memory_format=fmt)
    inner = ba._inner(x, C, fold)
    total = x.numel()
    chans, samples = _walk(total, inner, C, total // shape[0], vec)
    if fold:  # the point layout: element i in channel i % C
        want = torch.arange(total) % C
    else:  # the channel and sample ids laid out as x, read in memory order
        ids = torch.arange(C).view(1, C, 1, 1).expand(shape)
        want = ids.contiguous(memory_format=fmt).as_strided((total,), (1,))
        n_ids = torch.arange(shape[0]).view(-1, 1, 1, 1).expand(shape)
        n_ids = n_ids.contiguous(memory_format=fmt).as_strided((total,),
                                                               (1,))
        assert np.array_equal(samples, n_ids.numpy())
    assert np.array_equal(chans, want.numpy())
