"""Time the port's hand kernels on one CUDA card at the shapes of a
StreamMOS_seg frame, each beside its plain version, its library call where
there is one, and its bound:

    python -m streammos_tpu_torch.tools.kernel_times

Prints the card's name and power limit, the kernels' build time and each
kernel library's ptxas lines, then one JSON line a kernel (`name`) under
the keys of PERF.md's kernel table: `ms`, `plain_ms`, `library_ms` (the
call issued from Python, CUDA events, the mean of back-to-back calls),
`device_ms`, `library_device_ms`, `plain_device_ms` (the call replayed
from a CUDA graph: the card's time without the host's cost of issuing
it), `bound_ms` (the larger of the bytes the function needs, each read or
written once, over 3.35 TB/s and its operations over the peak rate; which
of the two in `bound_by`) and `mb`. The scatter kernels, the folded TTA
scatter, the gather and the eval BN epilogue add a row a site (`sites`);
the two unfolded scatters' top-level times are those of their largest
site, the folded scatter's and the gather's are summed over the five sites
of a frame, the BN epilogue's over its 58 launches in a frame (Bt = 1) and
in a step of 4 streams (Bt = 4).

Inputs: the fused header's drawn from the seed at StreamMOS_seg's
production shape (`header_inputs`); the scatters' (the folded one's too)
coordinates those of a range-skewed frame of POINTS points x T at the
five scatter sites, the features drawn from the seed (`scatter_sites`);
the gather's the grids and coordinates the model hands over in an eager
step (`gather_sites`); the BN epilogue's the shapes, layouts and operands
of its calls in an eager step (`bn_sites`), filled from the seed. TF32
is off. The card tests (`tests/test_torch_cuda.py`) hold the kernels'
results against their plain versions on the same inputs; this tool times
them. It exits non-zero on a card whose peaks it does not know (the
bounds are the H100 SXM's) and when the float32 header kernel is not
faster than its plain version.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 0
POINTS = 160_000
REPS = 20
# published peaks of the H100 SXM part at 700 W (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
F32_FLOP_PER_S = 67e12  # outside the tensor cores
F32_TOL = 1e-4  # the float32 header kernel against its plain version
GATHER_SITES = ("bev0", "rv0", "bev1", "rv1", "point")


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of one call over `reps` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of one call of `fn` replayed from a CUDA graph: the
    card's time for its launches without the host's cost of issuing them
    (the eager `time_ms` of a small call measures the host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # allocations and builds outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = time_ms(graph.replay, reps)
    del graph
    return ms


def timed(kernel, plain, library=None, plain_graph=False) -> dict:
    """The kernel's, its plain version's and its library call's times."""
    out = dict(ms=time_ms(kernel, REPS), device_ms=graph_ms(kernel, REPS),
               plain_ms=time_ms(plain, 3, warmup=1))
    if plain_graph:
        out["plain_device_ms"] = graph_ms(plain, 3)
    if library is not None:
        out.update(library_ms=time_ms(library, REPS),
                   library_device_ms=graph_ms(library, REPS))
    return out


def bound(nbytes: int, ops_ms: float) -> dict:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                mb=nbytes / 1e6)


def header_inputs(gen, dev, Bt, T, C, Cout, Hh, Wh, dtype):
    """Random fused-header inputs: non-negative phase grid (the scatter of
    post-ReLU features) with empty padding rows, kernels, affines (the pool
    scale may be negative)."""
    g = torch.relu(torch.randn(Bt * T, 4, Hh + 2, Wh, 4 * C, generator=gen))
    g[:, :, 0] = 0
    g[:, :, -1] = 0
    k3 = torch.randn(3, 3, T * C, Cout, generator=gen) * (9 * T * C) ** -0.5
    k1 = torch.randn(1, 1, T * C, Cout, generator=gen) * (T * C) ** -0.5
    ca = (torch.rand(Cout, generator=gen) + 0.5,
          torch.randn(Cout, generator=gen) * 0.1)
    pa = (torch.rand(Cout, generator=gen) * 3 - 1.5,
          torch.randn(Cout, generator=gen) * 0.1)
    to = lambda t: t.to(dev, dtype)
    return (to(g), to(k3), to(k1), tuple(a.to(dev) for a in ca),
            tuple(a.to(dev) for a in pa))


def header_shape(cfg):
    """(T, C, Cout, Hh, Wh) of `cfg`'s fused header."""
    m = cfg.model
    return (m.seq_num, m.context_layers[0], m.context_layers[1],
            m.voxel.bev_wl[0] // 2, m.voxel.bev_wl[1] // 2)


def header_entries(dev, cfg):
    """The bf16 kernel (tensor cores, bf16) and the float32 one (3xTF32) at
    the production shape, with the weight packing included in `ms`."""
    from streammos_tpu_torch.ops import fused_header as fh

    T, C, Cout, Hh, Wh = header_shape(cfg)
    flops = 2 * 4 * Hh * Wh * Cout * T * C * (9 + 4)
    entries = []
    for dtype, seed in ((torch.bfloat16, SEED), (torch.float32, SEED + 1)):
        args = header_inputs(torch.Generator().manual_seed(seed), dev, 1, T,
                             C, Cout, Hh, Wh, dtype)
        g, k3, k1 = args[:3]
        out = fh.fused_header_tta(*args, T)
        # the padding row above and below each phase plane is never read
        nbytes = (g[:, :, 1:-1].numel() * g.element_size() + 4 * Cout * 4
                  + sum(t.numel() * t.element_size() for t in (k3, k1, out)))
        if dtype == torch.bfloat16:
            ops_ms = flops / BF16_FLOP_PER_S * 1e3
        else:  # three TF32 products a multiply-add
            ops_ms = 3 * flops / TF32_FLOP_PER_S * 1e3
        e = {"name": ("fused_header_tta" if dtype == torch.bfloat16
                      else "fused_header_tta_float32"),
             "source": "streammos_tpu_torch/csrc/fused_header.cu",
             "replaces": "streammos_tpu/ops/fused_header.py:198",
             "dtype": str(dtype).split(".")[1], "shape": list(g.shape),
             **timed(lambda: fh.fused_header_tta(*args, T),
                     lambda: fh.fused_header_reference(*args, T)),
             "library_ms": None, **bound(nbytes, ops_ms), "gflop": flops / 1e9}
        if dtype == torch.bfloat16:
            e["pack_ms"] = time_ms(lambda: fh.pack_header_weights(k3, k1, T),
                                   REPS)
        else:
            e["fp32_fma_bound_ms"] = flops / F32_FLOP_PER_S * 1e3
        e["bound_share"] = e["bound_ms"] / e["device_ms"]
        entries.append(e)
    return entries


def scatter_sites(cfg, dev, Bt: int = 1, dtype=torch.bfloat16):
    """The five scatter sites of one main-path step of Bt streams, each a
    dict: `name`, `span` (its `smt.scatter.*` span), `call` (the call
    site), `kind` and `layout` (`voxel_max_pool_tta`'s), `feat` (B, N, C)
    non-negative features of `dtype` drawn from the seed, `inds`
    (coordinates from `featurize(tta_expand_folded(...))` of range-skewed
    frames of POINTS points, strided as the model hands them over) and
    `args` (the rest of `voxel_max_pool`'s arguments, nonneg set)."""
    from streammos_tpu_torch.models.stream_mos import (featurize,
                                                       tta_expand_folded)
    from streammos_tpu_torch.ops.tta_fold import V_TTA
    from streammos_tpu_torch.scans import skewed_scan_bank

    m = cfg.model
    T, (H, W), (rv_h, rv_w) = m.seq_num, m.voxel.bev_wl, m.voxel.rv_shape
    c0, c1, c2, _ = (V_TTA * c for c in m.context_layers)
    xyzi = torch.from_numpy(skewed_scan_bank(np.random.default_rng(SEED), Bt,
                                             T, POINTS)[:, 0]).to(dev)
    batch = featurize(tta_expand_folded(xyzi), m)
    bev, rv = batch["bev_coord"], batch["rv_coord"]
    full = bev[..., 0, :].reshape(Bt * T, POINTS, 3)[..., :2]
    cur_bev, cur_rv = bev[:, 0, :, 0, :2], rv[:, 0, :, 0]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sites = []
    for name, span, call, inds, size, scale, split, pad, C in (
            ("full grid", "bev_full", "models/stream_mos.py:219", full,
             (H, W), (1.0, 1.0), "outer", 1, c0),
            ("stage-0 RV", "rv0", "nn/encoder.py:134", cur_rv,
             (rv_h // 2, rv_w // 2), (0.5, 0.5), False, 0, c1),
            ("stage-0 BEV", "bev0", "nn/encoder.py:140", cur_bev,
             (H // 2, W // 2), (0.5, 0.5), False, 0, c1),
            ("stage-1 RV", "rv1", "nn/encoder.py:148", cur_rv,
             (rv_h // 4, rv_w // 4), (0.25, 0.25), False, 0, c2),
            ("stage-1 BEV", "bev1", "nn/encoder.py:154", cur_bev,
             (H // 4, W // 4), (0.25, 0.25), False, 0, c2)):
        feat = torch.relu(torch.randn(inds.shape[0], POINTS, C, generator=gen,
                                      device=dev)).to(dtype)
        sites.append(dict(name=name, span="smt.scatter." + span, call=call,
                          kind="rv" if "RV" in name else "bev",
                          layout="phase_outer" if split else "variants",
                          feat=feat, inds=inds,
                          args=(size, scale, True, split, pad)))
    return sites


def scatter_library(rows, ids, cells: int, include_self: bool):
    """The library call: one `scatter_reduce_(..., "amax")` into a zero
    grid with a sentinel row (the impl="auto" body)."""
    C = rows.shape[-1]
    grid = torch.zeros((cells + 1, C), dtype=rows.dtype, device=rows.device)
    grid.scatter_reduce_(0, ids.long()[:, None].expand(-1, C), rows, "amax",
                         include_self=include_self)
    return grid[:-1]


def scatter_entries(dev, cfg):
    """The sorted kernel at the five sites, on the rows
    `voxel_max_pool(impl="pallas")` sorts, and the one-grid kernel at the
    four cascade sites (the full grid fails `fits_vmem`), on the per-batch
    ids `impl="vmem"` passes. The bound: the valid rows and the ids read
    once (the sorted kernel reads no row of a sentinel id), the grid
    written once, or a maximum a valid row element on the CUDA cores."""
    from streammos_tpu_torch.ops import pallas_scatter as ps
    from streammos_tpu_torch.ops import pallas_scatter_vmem as pv
    from streammos_tpu_torch.ops.voxel_pool import _cell_ids

    rows = {"sorted": [], "grid": []}
    for s in scatter_sites(cfg, dev):
        feat, (size, scale, _, split, pad) = s["feat"], s["args"]
        B, N, C = feat.shape
        flat, valid, n = _cell_ids(s["inds"], size, scale, split, pad)
        off = torch.arange(B, device=dev)[:, None] * n
        glob = torch.where(valid, flat + off, B * n).to(torch.int32).reshape(-1)
        n_valid, item = int(valid.sum()), feat.element_size()
        grid_bytes = B * n * C * item
        ids_sorted, perm = torch.sort(glob)
        rows_sorted = feat.reshape(-1, C).index_select(0, perm)
        site = dict(site=s["name"], call=s["call"], rows=[B * N, C],
                    valid_rows=n_valid, grid=[B, n])
        ops_ms = n_valid * C / F32_FLOP_PER_S * 1e3
        rows["sorted"].append(dict(site, **timed(
            lambda: ps.sorted_scatter_max(rows_sorted, ids_sorted, B * n),
            lambda: ps.sorted_scatter_max_reference(rows_sorted, ids_sorted,
                                                    B * n),
            lambda: scatter_library(rows_sorted, ids_sorted, B * n, False)),
            **bound(n_valid * C * item + n_valid * 4 + grid_bytes, ops_ms)))
        if pv.fits_vmem(n, C, item):
            ids = flat.to(torch.int32)
            rows["grid"].append(dict(site, **timed(
                lambda: pv.scatter_max_vmem(feat, ids, n),
                lambda: pv.scatter_max_vmem_reference(feat, ids, n),
                lambda: scatter_library(feat.reshape(-1, C), glob, B * n,
                                        True)),
                **bound(n_valid * C * item + ids.numel() * 4 + grid_bytes,
                        ops_ms)))
    entries = []
    for key, name, lib, replaces in (
            ("sorted", "sorted_scatter_max", "sorted_scatter",
             "streammos_tpu/ops/pallas_scatter.py:49"),
            ("grid", "scatter_max_vmem", "scatter_grid",
             "streammos_tpu/ops/pallas_scatter_vmem.py:75")):
        largest = max(rows[key], key=lambda r: r["mb"])
        entries.append({
            "name": name, "source": f"streammos_tpu_torch/csrc/{lib}.cu",
            "replaces": replaces, "dtype": "bfloat16",
            "site": largest["site"],
            **{k: largest[k] for k in (
                "ms", "device_ms", "plain_ms", "library_ms",
                "library_device_ms", "bound_ms", "bound_by", "mb")},
            "library_call": "torch.zeros + scatter_reduce_(amax) with a "
                            "sentinel row (the impl='auto' body)",
            "sites": rows[key]})
    return entries


def scatter_tta_library(feat, ids, cells: int, site: dict):
    """The library call of a folded scatter site: `scatter_library` into a
    zero grid with a sentinel row (ids precomputed), then, in the variants
    layout, each variant's grid oriented and the four stacked."""
    from streammos_tpu_torch.ops.tta_fold import V_TTA, orient_grid

    B, N, VC = feat.shape
    grid = scatter_library(feat.reshape(-1, VC), ids, cells, True)
    size = site["args"][0]
    if site["layout"] == "phase_outer":
        return grid.reshape(B, 4, size[0] // 2 + 2, size[1] // 2, VC)
    grid = grid.reshape(B, *size, V_TTA, VC // V_TTA)
    return torch.stack([orient_grid(grid[..., v, :], v, site["kind"], (1, 2))
                        for v in range(V_TTA)])


def scatter_tta_entry(dev, cfg):
    """The folded TTA scatter kernel at the five sites of a frame, on the
    inputs of `scatter_sites`; beside it the plain version (the cell ids,
    `voxel_max_pool`, orientation and stack) and the library call. The
    bound: the rows, the coordinates and the output once each."""
    from streammos_tpu_torch.ops import tta_fold
    from streammos_tpu_torch.ops.voxel_pool import _cell_ids

    rows = []
    with torch.inference_mode():
        for s in scatter_sites(cfg, dev):
            feat, inds, (size, scale, _, split, pad) = (s["feat"], s["inds"],
                                                        s["args"])
            B, N, VC = feat.shape
            args = (size, scale, s["kind"], True, s["layout"])
            out = tta_fold.voxel_max_pool_tta(feat, inds, *args)
            flat, valid, n = _cell_ids(inds, size, scale, split, pad)
            off = torch.arange(B, device=dev)[:, None] * n
            glob = torch.where(valid, flat + off, B * n).reshape(-1)
            nbytes = (feat.numel() * feat.element_size() + B * N * 8
                      + out.numel() * out.element_size())
            rows.append(dict(
                site=s["name"], span=s["span"], call=s["call"],
                kind=s["kind"], layout=s["layout"], rows=[B, N, VC],
                valid_rows=int(valid.sum()), grid=list(out.shape),
                **timed(lambda: tta_fold.voxel_max_pool_tta(feat, inds, *args),
                        lambda: tta_fold.voxel_max_pool_tta_reference(
                            feat, inds, *args),
                        lambda: scatter_tta_library(feat, glob, B * n, s),
                        plain_graph=True),
                **bound(nbytes, 0.0)))
    total = {k: sum(r[k] for r in rows) for k in (
        "ms", "device_ms", "plain_ms", "plain_device_ms", "library_ms",
        "library_device_ms", "bound_ms", "mb")}
    return {"name": "voxel_max_pool_tta",
            "source": "streammos_tpu_torch/csrc/scatter_tta.cu",
            "replaces": None, "dtype": "bfloat16", **total,
            "bound_by": "bytes",
            "library_call": "torch.zeros + scatter_reduce_(amax) with a "
                            "sentinel row, then orient + stack (the plain "
                            "version without the cell ids)",
            "bound_share": total["bound_ms"] / total["device_ms"],
            "sites": rows}


def gather_sites(cfg, dev):
    """The five folded TTA gathers of one eager main-path step of `cfg`'s
    model (weights and a range-skewed frame of POINTS points from the
    seed): [(site, (grids, coords, scale, kind))], the arguments as the
    model hands them over (its compute dtype, strides as they come)."""
    from streammos_tpu_torch import serve
    from streammos_tpu_torch.models import stream_mos
    from streammos_tpu_torch.nn import encoder
    from streammos_tpu_torch.ops import tta_fold
    from streammos_tpu_torch.scans import skewed_scan_bank

    model = serve.build_model(cfg, with_refine=True, device=dev, seed=SEED)
    xyzi = torch.from_numpy(skewed_scan_bank(np.random.default_rng(SEED), 1,
                                             cfg.model.seq_num, POINTS)[0])
    sites = []

    def spy(*args):
        sites.append(args)
        return tta_fold.grid_to_point_tta(*args)

    encoder.grid_to_point_tta = stream_mos.grid_to_point_tta = spy
    try:
        with torch.inference_mode():
            serve.eval_step(model, xyzi.to(dev), serve.initial_memory(model),
                            False)
    finally:
        encoder.grid_to_point_tta = stream_mos.grid_to_point_tta = \
            tta_fold.grid_to_point_tta
    return list(zip(GATHER_SITES, sites))


def gather_entry(dev, cfg):
    """The folded gather at the five sites of a frame; the bound: the grid,
    the coordinates and the output once each."""
    from streammos_tpu_torch.ops.tta_fold import (
        grid_to_point_tta, grid_to_point_tta_reference)

    rows = []
    with torch.inference_mode():
        for name, (g, coords, scale, kind) in gather_sites(cfg, dev):
            V, B, H, W, C = g.shape
            out = grid_to_point_tta(g, coords, scale, kind)
            nbytes = (g.numel() * g.element_size() + coords.shape[1] * B * 8
                      + out.numel() * out.element_size())
            rows.append(dict(
                site=name, kind=kind, grid=list(g.shape),
                strides=list(g.stride()), points=coords.shape[1],
                **timed(lambda: grid_to_point_tta(g, coords, scale, kind),
                        lambda: grid_to_point_tta_reference(g, coords, scale,
                                                            kind),
                        plain_graph=True),
                **bound(nbytes, 0.0)))
    total = {k: sum(r[k] for r in rows) for k in (
        "ms", "device_ms", "plain_ms", "plain_device_ms", "bound_ms", "mb")}
    return {"name": "grid_to_point_tta",
            "source": "streammos_tpu_torch/csrc/grid_gather_tta.cu",
            "replaces": None, "dtype": "bfloat16", **total,
            "bound_by": "bytes", "library_ms": None,
            "bound_share": total["bound_ms"] / total["device_ms"],
            "sites": rows}


def bn_launches(model) -> int:
    """`kernel.bn_act` launches of one eval step of `model` on a card: one a
    BN, none for the two BNs the fused TTA header applies itself, and one
    more a channel-attention block (its gate's BN over the (N, C) means)."""
    from streammos_tpu_torch.nn.blocks import BN, BasicBlock

    mods = list(model.modules())
    header = 2 if model.tta_fold and model.cfg.fused_header else 0
    return (sum(isinstance(m, BN) for m in mods) - header
            + sum(isinstance(m, BasicBlock) and m.channel_att is not None
                  for m in mods))


def bn_sites(cfg, dev, Bt: int = 1):
    """The eval BN epilogue's calls in one eager main-path step of Bt
    streams of `cfg`'s model (weights from the seed, range-skewed frames of
    POINTS points), each a dict: `site` (the BN's module name), `shape`,
    `strides`, `dtype`, `fold`, `C`, `act`, `residual` (bool), `gate` (its
    shape or None)."""
    from streammos_tpu_torch import serve
    from streammos_tpu_torch.nn import blocks
    from streammos_tpu_torch.scans import skewed_scan_bank

    model = serve.build_model(cfg, with_refine=True, device=dev, seed=SEED)
    names = {m.weight.data_ptr(): n for n, m in model.named_modules()
             if isinstance(m, blocks.BN)}
    xyzi = torch.from_numpy(skewed_scan_bank(np.random.default_rng(SEED), Bt,
                                             cfg.model.seq_num, POINTS)[:, 0])
    sites = []
    real = blocks.bn_act

    def spy(x, weight, bias, mean, var, eps, fold=0, act="none",
            residual=None, gate=None):
        sites.append(dict(site=names[weight.data_ptr()], shape=list(x.shape),
                          strides=list(x.stride()), dtype=x.dtype, fold=fold,
                          C=weight.shape[0], act=act,
                          residual=residual is not None,
                          gate=None if gate is None else list(gate.shape)))
        return real(x, weight, bias, mean, var, eps, fold, act, residual, gate)

    blocks.bn_act = spy
    try:
        with torch.inference_mode():
            serve.eval_step(model, xyzi.to(dev), serve.initial_memory(model),
                            False)
    finally:
        blocks.bn_act = real
    if len(sites) != bn_launches(model):
        raise RuntimeError(f"{len(sites)} BN epilogues in a step, expected "
                           f"{bn_launches(model)}")
    return sites


def bn_operands(site: dict, gen, dtype=None, layout=None):
    """Random operands of a `bn_sites` call: x (and the residual) in the
    site's strides, or NCHW / channels last (`layout` "nchw" / "nhwc"), of
    the site's dtype or `dtype`; the gate in (0, 1); the BN's four float32
    buffers. Returns (x, weight, bias, mean, var, eps, fold, act, residual,
    gate)."""
    dev = gen.device
    dt = dtype or site["dtype"]
    C, shape = site["C"], site["shape"]

    def laid(t):
        if layout == "nchw":
            return t.contiguous()
        if layout == "nhwc":
            return t.contiguous(memory_format=torch.channels_last)
        return torch.empty_strided(shape, site["strides"], dtype=dt,
                                   device=dev).copy_(t)

    x = laid(torch.randn(shape, generator=gen, device=dev).to(dt) * 2)
    r = (laid(torch.randn(shape, generator=gen, device=dev).to(dt))
         if site["residual"] else None)
    g = (torch.rand(site["gate"], generator=gen, device=dev).to(dt)
         if site["gate"] else None)
    w = torch.rand(C, generator=gen, device=dev) + 0.5
    b = torch.randn(C, generator=gen, device=dev) * 0.3
    m = torch.randn(C, generator=gen, device=dev) * 0.3
    v = torch.rand(C, generator=gen, device=dev) * 1.5 + 0.25
    return x, w, b, m, v, 1e-5, site["fold"], site["act"], r, g


def bn_library(x, weight, bias, mean, var, eps, fold, act, residual, gate):
    """The library yardstick: the composition the port ran before the
    kernel (BN's affine cast to x's dtype and applied by `addcmul`, then
    the gate, the residual add and the activation, each one PyTorch op);
    the CPU tests hold the plain version and the blocks to it too."""
    from streammos_tpu_torch.ops.bn_act import activate

    scale = weight * torch.rsqrt(var + eps)
    shift = (bias - mean * scale).to(x.dtype)
    scale = scale.to(x.dtype)
    if fold:
        y = torch.addcmul(shift.repeat(fold), x, scale.repeat(fold))
    else:
        y = torch.addcmul(shift[:, None, None], x, scale[:, None, None])
    if gate is not None:
        y = y * gate.reshape(x.shape[0], -1, 1, 1)
    if residual is not None:
        y = y + residual
    return activate(y, act)


def bn_entry(dev, cfg, Bt: int):
    """The eval BN epilogue at its sites of one step of Bt streams: the
    kernel, the plain version and the library yardstick on each site's
    operands. The bound: x, the residual, the gate and y once each, and
    the four buffers."""
    from streammos_tpu_torch.ops.bn_act import bn_act, bn_act_reference

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    with torch.inference_mode():
        for site in bn_sites(cfg, dev, Bt):
            args = bn_operands(site, gen)
            x, r, g = args[0], args[8], args[9]
            nbytes = 16 * site["C"] + sum(
                t.numel() * t.element_size() for t in (x, x, r, g)
                if t is not None)
            rows.append(dict(
                {k: site[k] for k in ("site", "shape", "strides", "fold",
                                      "act", "residual", "gate")},
                dtype=str(site["dtype"]).split(".")[1],
                **timed(lambda: bn_act(*args),
                        lambda: bn_act_reference(*args),
                        lambda: bn_library(*args), plain_graph=True),
                **bound(nbytes, 0.0)))
            del args, x, r, g
    total = {k: sum(r[k] for r in rows) for k in (
        "ms", "device_ms", "plain_ms", "plain_device_ms", "library_ms",
        "library_device_ms", "bound_ms", "mb")}
    return {"name": "bn_act" if Bt == 1 else f"bn_act_bt{Bt}",
            "source": "streammos_tpu_torch/csrc/bn_act.cu", "replaces": None,
            "dtype": "bfloat16", "Bt": Bt, "launches": len(rows), **total,
            "bound_by": "bytes",
            "library_call": "eval_affine, casts, addcmul, then the gate, the "
                            "residual add and the activation (the port's "
                            "composition before the kernel)",
            "bound_share": total["bound_ms"] / total["device_ms"],
            "sites": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_times: CUDA is not available", file=sys.stderr)
        return 1
    from streammos_tpu_torch import build
    from streammos_tpu_torch.config import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(json.dumps({"card": name, "nvidia_smi": smi[0] if smi else None,
                      "torch": torch.__version__, "cuda": torch.version.cuda}),
          flush=True)
    if not ("H100" in name and "PCIe" not in name and "NVL" not in name):
        print(f"kernel_times: no published peaks for card {name!r}",
              file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(build.SOURCES)) as pool:  # one nvcc a kernel
        list(pool.map(build.load_library, build.SOURCES))
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "ptxas": {lib: build.ptxas_lines(lib)
                                for lib in sorted(build.SOURCES)}}),
          flush=True)
    cfg = get_config("StreamMOS_seg")
    ok = True
    for entry in (*header_entries(dev, cfg), *scatter_entries(dev, cfg),
                  scatter_tta_entry(dev, cfg), gather_entry(dev, cfg),
                  bn_entry(dev, cfg, 1), bn_entry(dev, cfg, 4)):
        print(json.dumps(entry), flush=True)
        if entry["name"] == "fused_header_tta_float32" and not (
                entry["ms"] < entry["plain_ms"]):
            print(f"kernel_times: the float32 header kernel ({entry['ms']} "
                  f"ms) is not faster than its plain version "
                  f"({entry['plain_ms']} ms)", file=sys.stderr)
            ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
