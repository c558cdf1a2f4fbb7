"""The port's train-mode blocks against flax: BatchNorm with batch
statistics (output, input and parameter gradients, updated running
statistics; float32 and bfloat16 inputs; the point and the NCHW layouts),
the frame-split `DownSample2D` in train and eval, the max-pool's gradient
at ties, and dropout.

Tolerances: float32 rtol = atol = 1e-5 for BN outputs and statistics
(the same float32 arithmetic, sums in another order), 1e-4 for gradients
and the DownSample2D (a convolution's sums); bfloat16 outputs 1e-2 (one
bf16 rounding of the output).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streammos_tpu.nn import blocks as j_blocks

from streammos_tpu_torch.nn import blocks as t_blocks
from streammos_tpu_torch.weights import _get, _Mapping
from tests.test_torch_common import use_few_threads

use_few_threads()


def _jax_bn(x, scale, bias, mean, var, dtype):
    """flax BN of the JAX blocks in train mode: (y, new mean, new var,
    grads of sum(y * cot) w.r.t. x, scale, bias)."""
    bn = j_blocks.BN(dtype)
    variables = {"params": {"BatchNorm_0": {"scale": scale, "bias": bias}},
                 "batch_stats": {"BatchNorm_0": {"mean": mean, "var": var}}}
    y, new = bn.apply(variables, x, True, mutable=["batch_stats"])
    cot = np.random.RandomState(1).normal(size=y.shape).astype(np.float32)

    def f(x, params):
        out, _ = bn.apply({"params": params,
                           "batch_stats": variables["batch_stats"]}, x, True,
                          mutable=["batch_stats"])
        return (out.astype(jnp.float32) * cot).sum()

    gx, gp = jax.grad(f, argnums=(0, 1))(x, variables["params"])
    st = new["batch_stats"]["BatchNorm_0"]
    return (np.asarray(y.astype(jnp.float32)), np.asarray(st["mean"]),
            np.asarray(st["var"]), np.asarray(gx.astype(jnp.float32)),
            np.asarray(gp["BatchNorm_0"]["scale"]),
            np.asarray(gp["BatchNorm_0"]["bias"]), cot)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["points", "nchw"])
def test_bn_train_matches_flax(dtype, layout):
    rng = np.random.RandomState(0)
    C = 16
    shape = (3, 200, C) if layout == "points" else (2, 9, 11, C)
    # per-channel means up to a few spreads off 0; flax's E[x^2] - E[x]^2
    # loses digits when the mean is many spreads off, on both sides alike
    x = (rng.normal(size=shape) * rng.uniform(0.5, 3, C) + rng.normal(0, 3, C))
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.normal(0, 0.1, C).astype(np.float32)
    mean = rng.normal(0, 0.1, C).astype(np.float32)
    var = rng.uniform(0.5, 1.5, C).astype(np.float32)
    jdt = jnp.dtype(dtype)
    xj = jnp.asarray(x.astype(np.float32)).astype(jdt)
    y, new_mean, new_var, gx, gscale, gbias, cot = _jax_bn(
        xj, scale, bias, mean, var, jdt)

    bn = t_blocks.BN(C, fold=1 if layout == "points" else 0)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    bn.train()
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    if layout == "nchw":
        xt = xt.permute(0, 3, 1, 2)
    xt = xt.detach().requires_grad_()
    out = bn(xt)
    assert out.dtype == xt.dtype
    cot_t = torch.from_numpy(cot)
    if layout == "nchw":
        cot_t = cot_t.permute(0, 3, 1, 2)
    (out.float() * cot_t).sum().backward()
    got = out.detach().float()
    gxt = xt.grad.float()
    if layout == "nchw":
        got, gxt = got.permute(0, 2, 3, 1), gxt.permute(0, 2, 3, 1)
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.numpy(), y, rtol=tol, atol=tol)
    np.testing.assert_allclose(bn.running_mean.numpy(), new_mean, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), new_var, rtol=1e-5,
                               atol=1e-5)
    gtol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(gxt.numpy(), gx, rtol=gtol, atol=gtol)
    np.testing.assert_allclose(bn.weight.grad.numpy(), gscale, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(bn.bias.grad.numpy(), gbias, rtol=1e-4,
                               atol=1e-4)


def test_bn_running_variance_is_the_biased_one():
    """0.9 * old + 0.1 * the biased batch variance, which torch's own
    BatchNorm does not give (it takes the unbiased one)."""
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(0)) * 2
    bn = t_blocks.BN(3, fold=1).train()
    bn(x)
    want = 0.9 + 0.1 * x.var(0, unbiased=False)
    torch.testing.assert_close(bn.running_var, want)
    ref = torch.nn.BatchNorm1d(3).train()
    ref(x)
    assert not torch.allclose(ref.running_var, want)


def test_bn_update_stats_off_leaves_the_statistics():
    bn = t_blocks.BN(4).train()
    bn.update_stats = False
    before = bn.running_mean.clone(), bn.running_var.clone()
    bn(torch.randn(2, 4, 3, 3))
    assert torch.equal(bn.running_mean, before[0])
    assert torch.equal(bn.running_var, before[1])


def test_folded_bn_is_eval_only():
    bn = t_blocks.BN(4, fold=4).train()
    with pytest.raises(ValueError):
        bn(torch.randn(3, 16))


def _downsample_pair(c_in, out, stride, seed=0):
    """A flax DownSample2D's variables (perturbed statistics) and the port
    module carrying them."""
    rng = np.random.RandomState(seed)
    jm = j_blocks.DownSample2D(out, stride=stride)
    variables = jm.init(jax.random.key(seed),
                        jnp.zeros((1, 8, 8, c_in), jnp.float32), False)
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        jax.device_get(variables["batch_stats"]))
    variables = {"params": variables["params"], "batch_stats": stats}
    m = _Mapping()
    m.downsample((), "m")
    sd = {key[2:]: torch.from_numpy(fn(np.array(_get(variables[tree], path))))
          for tree, rules in (("params", m.params), ("batch_stats", m.stats))
          for path, key, fn in rules}
    tm = t_blocks.DownSample2D(c_in, out, stride)
    tm.load_state_dict(sd, strict=False)
    return jm, variables, tm


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("stride", [1, 2])
def test_frame_split_downsample_matches_jax(train, stride):
    """(B, T, H, W, c) frames: the port's conv over the frame-major channel
    concat against JAX's per-frame kernel slices summed; outputs, input
    gradients and, in train, the running statistics."""
    T, c, out = 3, 8, 16
    jm, variables, tm = _downsample_pair(T * c, out, stride)
    rng = np.random.RandomState(3)
    x = np.maximum(rng.normal(size=(2, T, 12, 10, c)), 0).astype(np.float32)
    y, new = jm.apply(variables, jnp.asarray(x), train,
                      mutable=["batch_stats"])
    cot = rng.normal(size=y.shape).astype(np.float32)

    def f(x):
        out, _ = jm.apply(variables, x, train, mutable=["batch_stats"])
        return (out * cot).sum()

    gx = np.asarray(jax.grad(f)(jnp.asarray(x)))
    tm.train(train)
    xt = torch.from_numpy(x).requires_grad_()
    got = tm(xt).permute(0, 2, 3, 1)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), gx, rtol=1e-4, atol=1e-4)
    if train:
        for bn, name in ((tm.conv_branch[1], "BN_0"),
                         (tm.pool_branch[1], "BN_1")):
            st = new["batch_stats"][name]["BatchNorm_0"]
            np.testing.assert_allclose(bn.running_mean.numpy(),
                                       np.asarray(st["mean"]), rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(bn.running_var.numpy(),
                                       np.asarray(st["var"]), rtol=1e-5,
                                       atol=1e-5)


def test_maxpool_gradient_splits_ties_as_jax():
    """Many equal values (an empty grid region): JAX's pairwise maxima
    halve the gradient between tied inputs, and so must the port."""
    rng = np.random.RandomState(0)
    x = rng.randint(0, 3, size=(2, 9, 8, 4)).astype(np.float32)
    cot = rng.normal(size=(2, 5, 4, 4)).astype(np.float32)
    gx = jax.grad(lambda x: (j_blocks.maxpool3x3(x, 2) * cot).sum())(
        jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = t_blocks.maxpool3x3(xt, 2)
    np.testing.assert_array_equal(y.detach().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(j_blocks.maxpool3x3(
                                      jnp.asarray(x), 2)))
    (y * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(gx), rtol=1e-6, atol=1e-6)


def test_leaky_relu_gradient_at_zero_is_jax_s():
    conv = t_blocks.BasicConv2d(1, 1, 1, 0)
    with torch.no_grad():
        conv.conv.weight.fill_(1.0)
    conv.eval()
    x = torch.tensor([[[[0.0, -1.0, 2.0]]]], requires_grad=True)
    conv(x).sum().backward()
    jg = jax.grad(lambda v: jax.nn.leaky_relu(v, 0.01).sum())(
        jnp.asarray([0.0, -1.0, 2.0]))
    scale = conv.bn.eval_affine()[0]
    torch.testing.assert_close(x.grad.flatten() / scale,
                               torch.from_numpy(np.array(jg)))


def test_dropout():
    """Identity in eval and at rate 0; in train, flax's keep-and-scale
    from the generator: the same seed gives the same mask, kept entries
    are x / (1 - rate), and no generator is an error."""
    x = torch.ones(4000)
    d = t_blocks.Dropout(0.25)
    assert d.eval()(x) is x
    assert t_blocks.Dropout(0.0).train()(x) is x
    d.train()
    with pytest.raises(RuntimeError):
        d(x)
    t_blocks.set_dropout_generator(d, torch.Generator().manual_seed(1))
    a = d(x)
    t_blocks.set_dropout_generator(d, torch.Generator().manual_seed(1))
    assert torch.equal(a, d(x))
    assert set(a.unique().tolist()) == {0.0, float(torch.tensor(1.0) / 0.75)}
    assert abs(float((a == 0).float().mean()) - 0.25) < 0.03


def test_dropout_sites_follow_jax():
    """Dropout where JAX puts it: CatFusion before its first conv,
    PredBranch before its conv, the deformable layer after the attention
    and twice in the FFN (rate attn_dropout)."""
    from streammos_tpu_torch.config import get_config
    from streammos_tpu_torch.models.stream_mos import StreamMOSNet
    import dataclasses

    cfg = get_config("StreamMOS_tiny").model
    cfg = dataclasses.replace(cfg, dropout_rate=0.3, attn_dropout=0.1)
    model = StreamMOSNet(cfg, with_refine=True)
    rates = {n: m.rate for n, m in model.named_modules()
             if isinstance(m, t_blocks.Dropout)}
    layers = [f"bev_net.deformattn_module.deformattn_layers.{i}.dropout{j}"
              for i in range(cfg.n_attn_layers) for j in (1, 2, 3)]
    assert rates == {"point_post.dropout": 0.3, "pred_layer.dropout": 0.3,
                     "refine.bf_point_post.dropout": 0.3,
                     "refine.bf_pred_layer.dropout": 0.3,
                     **{n: 0.1 for n in layers}}
