"""Shared helpers for the PyTorch port's CPU tests: the JAX model and the
port model of `StreamMOS_tiny` with the same weights, and seeded inputs.

The JAX package is the reference. Inputs are made with numpy from a seed
and handed to both sides as numpy arrays.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from streammos_tpu.config import get_config as jax_get_config
from streammos_tpu.models.stream_mos import StreamMOSNet as JaxStreamMOSNet
from streammos_tpu.models.stream_mos import init_model

from streammos_tpu_torch.config import get_config
from streammos_tpu_torch.models.stream_mos import StreamMOSNet
from streammos_tpu_torch.weights import (from_flax_variables,
                                         load_state_dict_checked)

TORCH_THREADS = 2  # the suite runs under xdist with several workers


def use_few_threads() -> None:
    torch.set_num_threads(TORCH_THREADS)


def tiny_cfgs():
    """(JAX ModelConfig, port ModelConfig) of StreamMOS_tiny (float32)."""
    return jax_get_config("StreamMOS_tiny").model, get_config("StreamMOS_tiny").model


def _perturb(path, leaf: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """Make every ported quantity non-trivial: BN statistics and affines off
    the identity, zero-initialized kernels (deformable-attention offsets and
    weights) random."""
    name = getattr(path[-1], "key", str(path[-1]))
    if name == "var":
        return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
    if name == "mean":
        return rng.normal(0, 0.1, leaf.shape).astype(np.float32)
    if name == "scale":
        return (leaf + rng.normal(0, 0.1, leaf.shape)).astype(np.float32)
    if name == "bias" or not leaf.any():
        return (leaf + rng.normal(0, 0.02, leaf.shape)).astype(np.float32)
    return leaf


@functools.lru_cache(maxsize=None)
def jax_tiny_model(num_points: int = 512, with_refine: bool = True):
    """(JAX StreamMOSNet(tta_fold=True), its variables with perturbed
    weights as numpy trees). `init_model` runs under jit: op by op it
    takes many times longer on a CPU."""
    jcfg, _ = tiny_cfgs()
    model = JaxStreamMOSNet(jcfg, with_refine=with_refine, tta_fold=True)
    variables = jax.jit(lambda k: init_model(
        k, jcfg, batch=4, num_points=num_points, with_refine=with_refine,
        tta_fold=True)[1])(jax.random.PRNGKey(0))
    rng = np.random.RandomState(123)
    variables = {k: jax.tree_util.tree_map_with_path(
        lambda p, x: _perturb(p, np.asarray(x), rng), dict(variables[k]))
        for k in ("params", "batch_stats")}
    return model, variables


def port_model(variables, with_refine: bool = True, tta_fold: bool = True,
               cfg=None) -> StreamMOSNet:
    """The port model on the CPU, in eval mode, with the JAX variables
    carried across (`cfg`: the port ModelConfig, StreamMOS_tiny's by
    default)."""
    cfg = tiny_cfgs()[1] if cfg is None else cfg
    model = StreamMOSNet(cfg, with_refine=with_refine, tta_fold=tta_fold).eval()
    load_state_dict_checked(model, from_flax_variables(variables, cfg,
                                                       with_refine))
    return model


def without_refine(variables):
    """A variables tree without the refine head (stage 1's tree)."""
    return {k: {n: v for n, v in tree.items() if n != "refine"}
            for k, tree in variables.items()}


def compile_unfused(jitted, *args):
    """`jitted` compiled for `args` with XLA's fusion pass off.

    Fused, XLA:CPU recomputes a scatter's point features inside the
    backward's tie test ``feat == cell_max``
    (`streammos_tpu/ops/voxel_pool.py:279`) and rounds them differently
    from the maxima it stored, so the test fails for some points and their
    gradient is dropped (about 9% of the entries of a (3, 512, 64)
    BN + ReLU + scatter example); unfused, the jitted gradient equals JAX
    run op by op (`jax.disable_jit`), which the port matches."""
    return jitted.lower(*args).compile(
        compiler_options={"xla_disable_hlo_passes": "fusion"})


def jnp_tree(variables):
    return jax.tree_util.tree_map(jnp.asarray, variables)


def lidar_points(rng: np.random.RandomState, shape, extent: float = 45.0):
    """(…, 4) xyzi: a range-skewed scan inside the tiny config's crop plus
    a few points beyond it."""
    az = rng.uniform(-np.pi, np.pi, shape)
    r = np.minimum(1.0 + rng.exponential(12.0, shape), extent * 1.4)
    z = rng.uniform(-3.9, 1.9, shape)
    i = rng.uniform(0, 1, shape)
    return np.stack([r * np.cos(az), r * np.sin(az), z, i],
                    axis=-1).astype(np.float32)
