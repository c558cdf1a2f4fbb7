#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints no
result line):
  1. device: the card's name and power limit;
  2. build every CUDA kernel of the port from the sources in this checkout;
  3. the fused TTA header against its plain PyTorch version on the card: at
     the unit-test shape in float32 (the CUDA-core kernel), and in bfloat16
     (the tensor-core kernel, against the plain version run in float32 on
     the same bfloat16 inputs) at Bt=2 on a ragged grid, where NaN in the
     padding rows must leave the output unchanged, and at the production
     shape; kernel (weight packing included) and plain version timed at
     the production shape, with the achieved GB/s and share of the bound;
  4. the scatter kernels, at the five scatter sites of one main-path frame
     of StreamMOS_seg (coordinates from `featurize(tta_expand_folded(...))`
     of a range-skewed frame, non-negative bfloat16 features from the seed):
     `voxel_max_pool(impl="pallas")` at all five and `impl="vmem"` at the
     four cascade sites, with launch counts zeroed just before and read just
     after (the full grid must fail `fits_vmem` and raise); both held
     bit-exactly against `impl="auto"`, each kernel bit-exactly against its
     plain version on its own inputs, the sorted kernel also on signed
     values; at each site the skew (rows in the densest cell and in the
     densest 16-cell tile) and the launch shape each kernel's library
     reports (chunks, levels, copies, warps); kernel, plain version and
     library call (`scatter_reduce_`, the "auto" body) timed eagerly (`ms`),
     kernel and library call also replayed from a CUDA graph (`device_ms`),
     beside the bound; then full-size adversarial inputs (160k
     rows in one cell, signed; runs of exactly 64 rows, signed), each kernel
     bit-exact against its plain version there and timed;
  5. the main path: `serve.stream_eval`, the streaming TTA eval of
     StreamMOS_seg (bfloat16, random weights from a seed) over one sequence
     of range-skewed frames of 160k points x T=3, memory fresh on the first
     frame and carried after; launch counts are zeroed just before and read
     just after (the scatters take `impl="auto"` there: the scatter kernels
     launch no time);
  6. agreement on a small input: StreamMOS_tiny in float32 through the port
     on the card (kernel) and on the CPU (plain versions), same weights;
  7. training at full width (bf16, random weights from a seed), the
     protocol of `bench.py:bench_train_step`: batch 1, 130k points, T=3,
     3 windows of streaming BPTT, SGD-Nesterov with the step schedule;
     stage 1 (StreamMOS) and stage 2 (StreamMOS_seg, refine head,
     freeze_except="refine", bf_targets), each 2 warm-up steps then 4 timed
     with CUDA events, launch counts zeroed just before the steps and read
     just after (the training path launches no hand kernel), then one more
     step under torch.profiler for the device's busy time; checks: the
     losses finite, stage 1's parameters changed, stage 2's outside the
     refine head bit-identical, its refine head and its backbone's BN
     running statistics changed;
  8. training agreement on a small input: one stage-1 and one stage-2 step
     of StreamMOS_tiny (float32, dropout off) on the card and on the CPU
     from the same weights and windows;
  9. the host side, on a synthetic SemanticKITTI tree written from the seed
     (`tests/synthetic_kitti.py`: sequence 08 of 12 frames and 00 of 8, of
     125k-point scans with a moving car) under `build/`: host ms a sample
     of `EvalDataset` on the native and the numpy path (identical arrays
     required) and of `TrainDataset` inline and through `SampleWorkerPool`;
     the val CLI's function (`tools.val.run_eval`, StreamMOS_seg, bf16,
     160k points, weights from the seed) over sequence 08, with launch
     counts zeroed just before and read just after (the header once a
     frame, the scatter kernels never), CUDA events around each
     `eval_step` and the host wall per frame; checks: one `.label` (values
     in {0, 9, 251}) and one bf-label a frame, a finite moving_iou in
     `record_0.txt`; the train CLI as a subprocess (StreamMOS, bs1, 130k
     points, 4 steps, one epoch, validation over sequence 08 after it),
     then again, which must resume and take no step; checks: the
     checkpoint, finite losses and a `val/` scalar in `scalars.jsonl`, the
     drop list; its logged s/step beside the train phase's;
 10. the long-term-memory voting over the val CLI's output of sequence 08:
     the voting CLI with --instance, the numpy backend as a subprocess
     (spawned pool) and the device backend in this process on the card,
     refined files byte-equal; then one production-size vote (9 synthetic
     125k-point scans at (512, 512, 30), a case with argmax ties), numpy
     against CUDA bit for bit, each timed (host wall a frame, CUDA events
     around the device vote, its device time under the profiler), with the
     local-map points and the counters' bytes; launch counts zeroed just
     before and read just after (the voting path launches no hand kernel);
     which backend was faster and what `--vote auto` resolves to;
 11. the dress rehearsal, `python -m streammos_tpu_torch.tools.dress_rehearsal`
     at a cut depth (stage 1, stage 2, val, voting, each the port's CLI on
     the card): its JSON lines passed through, its summary ok and one
     refined label file a val frame.

TF32 is off for the whole run, so float32 convolutions and matmuls on the
card are full float32. Prints one {"kernels": [...], "train": {...},
"host": {...}, "voting": {...}, "rehearsal": {...}} line, the card's name
and power limit, and as the last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 0
FRAMES = 8           # timed main-path frames (the first one fresh)
WARMUP_FRAMES = 2
POINTS = 160_000
TRAIN_POINTS = 130_000  # bench.py's train protocol: bs1, T=3, 3 windows
TRAIN_WINDOWS = 3
TRAIN_WARMUP = 2
TRAIN_STEPS = 4
REPO = os.path.dirname(os.path.abspath(__file__))
DATA_FRAMES = {"08": 12, "00": 8}  # dataset phase: sequence -> frames
RAW_POINTS = 125_000  # points a synthetic scan (an HDL-64 scan's size)
CLI_STEPS = 4
VOTE_SCANS = 9  # a production vote: 8 history scans and the current one
VOTE_REPS = 3

# published peaks of the H100 SXM part at 700 W (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12  # outside the tensor cores


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


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


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max())


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


def bf16_check(fh, got, g, k3, k1, ca, pa, T, what):
    """The bf16 kernel's output against the float32 plain version on the
    same bf16 inputs: |got - want| <= 1e-2 + 1e-2 |want| (the kernel rounds
    its output to bf16). Returns the max abs error."""
    want = fh.fused_header_reference(g.float(), k3.float(), k1.float(),
                                     ca, pa, T)
    torch.cuda.synchronize()
    diff = (got.float() - want).abs()
    err = float(diff.max())
    excess = float((diff - (1e-2 + 1e-2 * want.abs())).max())
    print(f"fused_header bf16 {what} {tuple(g.shape)}: max_abs_err {err:.3e} "
          f"vs the float32 plain version on the same inputs (tolerance "
          f"1e-2 + 1e-2*|ref|: bf16 output rounding)", flush=True)
    check(excess <= 0, f"fused header bf16 {what} err {err}")
    return err


def header_phase(dev, name, cfg):
    from streammos_tpu_torch.ops import fused_header as fh

    gen = torch.Generator().manual_seed(SEED)
    # unit-test shape (tests/test_fused_header.py), float32 (the CUDA-core
    # kernel), Bt = 1 and 2
    for Bt in (1, 2):
        g, k3, k1, ca, pa = header_inputs(gen, dev, Bt, 3, 8, 16, 16, 128,
                                          torch.float32)
        got = fh.fused_header_tta(g, k3, k1, ca, pa, 3)
        want = fh.fused_header_reference(g, k3, k1, ca, pa, 3)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f"fused_header f32 unit shape Bt={Bt}: max_abs_err {err:.3e} "
              f"(tolerance 1e-4)", flush=True)
        check(err <= 1e-4, f"fused header f32 Bt={Bt} err {err}")

    m = cfg.model
    T, C, Cout = m.seq_num, m.context_layers[0], m.context_layers[1]
    # bf16 (the tensor-core kernel), Bt = 2 on a grid that is no multiple
    # of the 8 x 16 tile; then NaN in the padding rows must change nothing
    g, k3, k1, ca, pa = header_inputs(gen, dev, 2, T, C, Cout, 37, 45,
                                      torch.bfloat16)
    got = fh.fused_header_tta(g, k3, k1, ca, pa, T)
    err = bf16_check(fh, got, g, k3, k1, ca, pa, T, "ragged Bt=2")
    g[:, :, 0] = float("nan")
    g[:, :, -1] = float("nan")
    check(torch.equal(fh.fused_header_tta(g, k3, k1, ca, pa, T), got),
          "fused header bf16 reads the padding rows")
    print("fused_header bf16 ragged Bt=2: NaN padding rows leave the output "
          "unchanged", flush=True)

    # production shape, from the config the main path runs
    Hh, Wh = m.voxel.bev_wl[0] // 2, m.voxel.bev_wl[1] // 2
    g, k3, k1, ca, pa = header_inputs(gen, dev, 1, T, C, Cout, Hh, Wh,
                                      torch.bfloat16)
    got = fh.fused_header_tta(g, k3, k1, ca, pa, T)
    err = max(err, bf16_check(fh, got, g, k3, k1, ca, pa, T,
                              "production shape"))

    kernel_ms = time_ms(lambda: fh.fused_header_tta(g, k3, k1, ca, pa, T), 20)
    pack_ms = time_ms(lambda: fh.pack_header_weights(k3, k1, T), 20)
    plain_ms = time_ms(lambda: fh.fused_header_reference(g, k3, k1, ca, pa, T),
                       3, warmup=1)
    check("H100" in name and "PCIe" not in name and "NVL" not in name,
          f"bound: no published peaks for card {name!r}")
    # bytes the function needs: the padding row above and below each phase
    # plane is never read
    nbytes = g[:, :, 1:-1].numel() * g.element_size()
    nbytes += sum(t.numel() * t.element_size() for t in (k3, k1, got))
    nbytes += 4 * Cout * 4
    flops = 2 * 4 * Hh * Wh * Cout * T * C * (9 + 4)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    gb_per_s = nbytes / kernel_ms / 1e6
    print(f"fused_header production: kernel {kernel_ms:.4f} ms (of which the "
          f"weight packing {pack_ms:.4f} ms alone), plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB, "
          f"{flops / 1e9:.2f} GFLOP); {gb_per_s:.1f} GB/s, "
          f"{bound_ms / kernel_ms:.3f} of the bound", flush=True)
    return {
        "name": "fused_header_tta",
        "route": "cuda",
        "source": "streammos_tpu_torch/csrc/fused_header.cu",
        "replaces": "streammos_tpu/ops/fused_header.py:198",
        "replaces_function": "_pair_kernel (pallas_call at :423, in fused_header_tta)",
        "ok": True,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "library_note": ("no single PyTorch call computes the fused header "
                         "(two convolutions, two affines, a max-pool and a "
                         "ReLU over four flipped views)"),
        "achieved_gb_per_s": gb_per_s,
        "bound_share": bound_ms / kernel_ms,
        "pack_ms": pack_ms,
        "shape": list(g.shape),
        "dtype": "bfloat16",
    }


def scatter_sites(cfg, dev):
    """The five scatter sites of one main-path frame: (name, call site,
    inds, out_size, scale, phase_split, row_pad, feature width)."""
    from streammos_tpu_torch.models.stream_mos import featurize, tta_expand_folded
    from streammos_tpu_torch.ops.tta_fold import V_TTA
    from streammos_tpu_torch.scans import skewed_scan_bank

    m = cfg.model
    T, (H, W), (rv_h, rv_w) = m.seq_num, m.voxel.bev_wl, m.voxel.rv_shape
    c0, c1, c2, _ = (V_TTA * c for c in m.context_layers)
    xyzi = torch.from_numpy(skewed_scan_bank(np.random.default_rng(SEED), 1, T,
                                             POINTS)[0]).to(dev)
    batch = featurize(tta_expand_folded(xyzi), m)
    bev, rv = batch["bev_coord"], batch["rv_coord"]
    full = bev[..., 0, :].reshape(T, POINTS, 3)[..., :2]
    cur_bev, cur_rv = bev[:, 0, :, 0, :2], rv[:, 0, :, 0]
    return [
        ("full grid", "models/stream_mos.py:125", full, (H, W), (1.0, 1.0),
         "outer", 1, c0),
        ("stage-0 RV", "nn/encoder.py:116", cur_rv, (rv_h // 2, rv_w // 2),
         (0.5, 0.5), False, 0, c1),
        ("stage-0 BEV", "nn/encoder.py:120", cur_bev, (H // 2, W // 2),
         (0.5, 0.5), False, 0, c1),
        ("stage-1 RV", "nn/encoder.py:126", cur_rv, (rv_h // 4, rv_w // 4),
         (0.25, 0.25), False, 0, c2),
        ("stage-1 BEV", "nn/encoder.py:130", cur_bev, (H // 4, W // 4),
         (0.25, 0.25), False, 0, c2),
    ]


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


def scatter_library(rows, ids, cells: int, include_self: bool):
    """The library call: one `scatter_reduce_(..., "amax")` into a zero
    grid with a sentinel row (the impl="auto" body)."""
    C = rows.shape[-1]
    grid = torch.zeros((cells + 1, C), dtype=rows.dtype, device=rows.device)
    grid.scatter_reduce_(0, ids.long()[:, None].expand(-1, C), rows, "amax",
                         include_self=include_self)
    return grid[:-1]


def scatter_bound(valid_rows: int, C: int, itemsize: int, id_reads: int,
                  grid_bytes: int):
    """The larger of the bytes the function moves (the valid rows and
    `id_reads` int32 ids read once, the grid written once) over the memory
    rate and its maxima (one a valid row element) over the CUDA-core rate;
    and which of the two it is, and the bytes."""
    nbytes = valid_rows * C * itemsize + id_reads * 4 + grid_bytes
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = valid_rows * C / F32_FLOP_PER_S * 1e3
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms
            else "operations", nbytes)


def kernel_times(kernel, library, plain):
    """Kernel, library call and plain version each called eagerly (`ms`,
    `library_ms`, `plain_ms`: what a caller's loop sees, host included, as
    for every kernel of the `kernels` line), and the kernel and the library
    call also replayed from a CUDA graph (`device_ms`, `library_device_ms`:
    the card's time alone)."""
    return dict(ms=time_ms(kernel, 20), device_ms=graph_ms(kernel, 20),
                library_ms=time_ms(library, 20),
                library_device_ms=graph_ms(library, 20),
                plain_ms=time_ms(plain, 3, warmup=1))


def site_row(s, times, impl, err, id_reads, **extra):
    """One site's numbers: its times beside the bound, the entry point's
    eager time beside impl="auto"'s, the rows and the grid."""
    from streammos_tpu_torch.ops.voxel_pool import voxel_max_pool

    feat, inds, args, grid = s["feat"], s["inds"], s["args"], s["auto"]
    B, N, C = feat.shape
    bound_ms, bound_by, nbytes = scatter_bound(
        s["n_valid"], C, feat.element_size(), id_reads,
        grid.numel() * grid.element_size())
    return dict(
        site=s["name"], call=s["where"], rows=[B * N, C],
        valid_rows=s["n_valid"], densest_cell_rows=s["dense_cell"],
        densest_tile16_rows=s["dense_tile"],
        grid=list(grid.shape[:-1]), max_abs_err=err, **times,
        bound_ms=bound_ms, bound_by=bound_by, mb=nbytes / 1e6,
        entry_ms=time_ms(lambda: voxel_max_pool(feat, inds, *args, impl=impl),
                         20),
        auto_ms=time_ms(lambda: voxel_max_pool(feat, inds, *args), 20),
        **extra)


def sorted_site(s, gen):
    """The sorted kernel at one site, on the rows `scatter_max_pallas` would
    sort: bit-exact against its plain version on the non-negative and on
    signed rows, and against impl="auto" through the entry point."""
    from streammos_tpu_torch.ops import pallas_scatter as ps
    from streammos_tpu_torch.ops.voxel_pool import voxel_max_pool

    feat, inds, (size, scale, _, split, pad) = s["feat"], s["inds"], s["args"]
    B, N, C = feat.shape
    cells = B * s["n"]
    ids_sorted, perm = torch.sort(s["glob"])
    rows_sorted = feat.reshape(-1, C).index_select(0, perm)
    check(torch.equal(s["pallas"], s["auto"]), f"pallas != auto at {s['name']}")
    signed = torch.randn(B, N, C, generator=gen, device=feat.device).to(
        torch.bfloat16)
    err = 0.0
    for rows in (rows_sorted, signed.reshape(-1, C).index_select(0, perm)):
        got = ps.sorted_scatter_max(rows, ids_sorted, cells)
        want = ps.sorted_scatter_max_reference(rows, ids_sorted, cells)
        check(torch.equal(got, want), f"sorted kernel != plain at {s['name']}")
        err = max(err, max_abs_err(got, want))
    check(bool((want < 0).any()), "signed rows give negative maxima")
    check(torch.equal(
        voxel_max_pool(signed, inds, size, scale, False, split, pad,
                       impl="pallas"),
        voxel_max_pool(signed, inds, size, scale, False, split, pad)),
        f"pallas != auto on signed values at {s['name']}")
    lib = scatter_library(rows_sorted, ids_sorted, cells, False)
    check(torch.equal(lib.reshape(s["auto"].shape), s["auto"]),
          "library call != auto")
    del got, want, signed, lib
    plan = ps.launch_plan(B * N, cells, C, feat.element_size())
    times = kernel_times(
        lambda: ps.sorted_scatter_max(rows_sorted, ids_sorted, cells),
        lambda: scatter_library(rows_sorted, ids_sorted, cells, False),
        lambda: ps.sorted_scatter_max_reference(rows_sorted, ids_sorted,
                                                cells))
    return site_row(s, times, "pallas", err,
                    id_reads=s["n_valid"],  # sentinel rows: ids only
                    chunks=plan["chunks"],
                    rows_per_chunk=plan["rows_per_chunk"], levels=plan["levels"],
                    warps=-(-plan["threads"] // 32))


def copies_site(s):
    """The one-grid kernel at one cascade site, on the per-batch int32 ids
    `voxel_max_pool(impl="vmem")` passes: bit-exact against its plain
    version and against impl="auto" through the entry point."""
    from streammos_tpu_torch.ops import pallas_scatter_vmem as pv

    feat, n = s["feat"], s["n"]
    B, N, C = feat.shape
    ids = s["flat"].to(torch.int32)
    check(torch.equal(s["vmem"], s["auto"]), f"vmem != auto at {s['name']}")
    got = pv.scatter_max_vmem(feat, ids, n)
    want = pv.scatter_max_vmem_reference(feat, ids, n)
    check(torch.equal(got, want), f"grid kernel != plain at {s['name']}")
    err = max_abs_err(got, want)
    del got, want
    times = kernel_times(
        lambda: pv.scatter_max_vmem(feat, ids, n),
        lambda: scatter_library(feat.reshape(-1, C), s["glob"], n, True),
        lambda: pv.scatter_max_vmem_reference(feat, ids, n))
    plan = pv.launch_plan(B * N, C, feat.element_size())
    return site_row(s, times, "vmem", err,
                    id_reads=ids.numel(),  # every id, to drop the invalid
                    copies=plan["copies"],
                    jax_copies=pv._num_copies(pv._cells_pad(n), C,
                                              feat.element_size()),
                    points_per_thread=plan["points_per_thread"],
                    warps=-(-plan["threads"] // 32))


def adversarial_phase(dev):
    """Both kernels at full size on the inputs that broke the old designs,
    160k bf16 rows of 256 channels: for the sorted kernel all in one cell
    (the first 128 channels negative, so the cell's maximum is negative
    there) and in runs of exactly 64 rows (every other cell negative), for
    the grid kernel all in one cell of a stage-1 BEV grid (non-negative);
    each bit-exact against its plain version, and timed beside its bound."""
    from streammos_tpu_torch.ops import pallas_scatter as ps
    from streammos_tpu_torch.ops import pallas_scatter_vmem as pv

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    C = 256
    rows = torch.randn(POINTS, C, generator=gen, device=dev)
    out = {"pallas": [], "vmem": []}
    one_cell = torch.zeros(POINTS, dtype=torch.int32, device=dev)
    runs = torch.arange(POINTS, device=dev, dtype=torch.int32) // 64
    cases = [("one cell", one_cell, 2, torch.cat(
        [-rows[:, :128].abs(), rows[:, 128:]], 1)),
        ("runs of 64", runs, int(runs[-1]) + 2,
         torch.where((runs % 2 == 0)[:, None], -rows.abs(), rows))]
    for name, ids, cells, x in cases:
        x = x.to(torch.bfloat16)
        got = ps.sorted_scatter_max(x, ids, cells)
        want = ps.sorted_scatter_max_reference(x, ids, cells)
        check(torch.equal(got, want), f"sorted kernel != plain, {name}")
        check(bool((want < 0).any()), f"{name}: no negative maximum")
        times = kernel_times(
            lambda: ps.sorted_scatter_max(x, ids, cells),
            lambda: scatter_library(x, ids, cells, False),
            lambda: ps.sorted_scatter_max_reference(x, ids, cells))
        bound = scatter_bound(POINTS, C, 2, POINTS, cells * C * 2)
        out["pallas"].append(dict(case=name, rows=[POINTS, C], cells=cells,
                                  max_abs_err=max_abs_err(got, want),
                                  **times, bound_ms=bound[0]))
    cells = 128 * 128
    x = rows.abs().to(torch.bfloat16)[None]
    ids = torch.full((1, POINTS), 4321, dtype=torch.int32, device=dev)
    got = pv.scatter_max_vmem(x, ids, cells)
    want = pv.scatter_max_vmem_reference(x, ids, cells)
    check(torch.equal(got, want), "grid kernel != plain, one cell")
    times = kernel_times(
        lambda: pv.scatter_max_vmem(x, ids, cells),
        lambda: scatter_library(x[0], ids[0], cells, True),
        lambda: pv.scatter_max_vmem_reference(x, ids, cells))
    bound = scatter_bound(POINTS, C, 2, POINTS, cells * C * 2)
    out["vmem"].append(dict(case="one cell", rows=[POINTS, C], cells=cells,
                            max_abs_err=max_abs_err(got, want), **times,
                            bound_ms=bound[0]))
    for impl, name in (("pallas", "sorted_scatter_max"),
                       ("vmem", "scatter_max_vmem")):
        for r in out[impl]:
            print(f"{name} adversarial, {r['case']}, {POINTS} x {C} bf16 -> "
                  f"{r['cells']} cells: bit-exact vs plain; kernel "
                  f"{r['ms']:.4f} ms (device {r['device_ms']:.4f}), plain "
                  f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f} "
                  f"(device {r['library_device_ms']:.4f}), bound "
                  f"{r['bound_ms']:.4f}", flush=True)
    return out


def scatter_phase(dev, cfg):
    """`voxel_max_pool(impl="pallas"|"vmem")` at the five sites of a frame:
    the path run (counted), then the checks and the timings (not counted),
    then the adversarial inputs. Returns the two kernels' entries of the
    `kernels` line."""
    from streammos_tpu_torch import build
    from streammos_tpu_torch.ops import pallas_scatter as ps
    from streammos_tpu_torch.ops import pallas_scatter_vmem as pv
    from streammos_tpu_torch.ops.voxel_pool import _cell_ids, voxel_max_pool

    gen = torch.Generator(device=dev).manual_seed(SEED)
    sites = []
    for name, where, inds, size, scale, split, pad, C in scatter_sites(cfg, dev):
        feat = torch.relu(torch.randn(inds.shape[0], POINTS, C, generator=gen,
                                      device=dev)).to(torch.bfloat16)
        sites.append(dict(name=name, where=where, feat=feat, inds=inds,
                          args=(size, scale, True, split, pad)))

    # the path: counts zeroed just before, read just after
    ps.sorted_scatter_max.launches = 0
    pv.scatter_max_vmem.launches = 0
    for s in sites:
        s["pallas"] = voxel_max_pool(s["feat"], s["inds"], *s["args"],
                                     impl="pallas")
        s["vmem"] = None
        try:
            s["vmem"] = voxel_max_pool(s["feat"], s["inds"], *s["args"],
                                       impl="vmem")
        except ValueError as e:
            check(s["name"] == "full grid" and "fits_vmem" in str(e),
                  f"vmem rejected {s['name']}: {e}")
    torch.cuda.synchronize()
    launches = {"pallas": ps.sorted_scatter_max.launches,
                "vmem": pv.scatter_max_vmem.launches}
    check(launches == {"pallas": 5, "vmem": 4},
          f"scatter kernel launches {launches}, expected 5 and 4")
    check(sites[0]["vmem"] is None, "the full grid must fail fits_vmem")
    print(f"scatter path: voxel_max_pool(impl='pallas') at 5 sites, "
          f"impl='vmem' at 4 (the full grid rejected by fits_vmem); "
          f"launches {launches}", flush=True)

    rows = {"pallas": [], "vmem": []}
    for s in sites:
        size, scale, _, split, pad = s["args"]
        B = s["feat"].shape[0]
        s["auto"] = voxel_max_pool(s["feat"], s["inds"], *s["args"])
        s["flat"], valid, s["n"] = _cell_ids(s["inds"], size, scale, split, pad)
        s["n_valid"] = int(valid.sum())
        off = torch.arange(B, device=dev)[:, None] * s["n"]
        s["glob"] = torch.where(valid, s["flat"] + off, B * s["n"]).to(
            torch.int32).reshape(-1)
        # the skew: rows in the densest cell, and in the densest tile of 16
        # cells (the unit of work of the earlier tile-per-thread design)
        occupied = s["glob"][s["glob"] < B * s["n"]].long()
        s["dense_cell"] = int(torch.bincount(occupied).max())
        s["dense_tile"] = int(torch.bincount(occupied // 16).max())
        rows["pallas"].append(sorted_site(s, gen))
        if s["vmem"] is not None:
            rows["vmem"].append(copies_site(s))
        s.clear()
    adversarial = adversarial_phase(dev)

    entries = []
    for impl, name, lib, repl, fn in (
            ("pallas", "sorted_scatter_max", "sorted_scatter",
             "streammos_tpu/ops/pallas_scatter.py:49",
             "kernel from _make_kernel (pallas_call at :195, in "
             "sorted_scatter_max)"),
            ("vmem", "scatter_max_vmem", "scatter_grid",
             "streammos_tpu/ops/pallas_scatter_vmem.py:75",
             "_kernel (pallas_call at :157, in scatter_max_vmem)")):
        ptxas = build.ptxas_lines(lib)
        check(any("registers" in line for line in ptxas),
              f"no ptxas register lines for {lib}")
        for r in rows[impl]:
            shape = (f"{r['chunks']} chunks of {r['rows_per_chunk']} rows, "
                     f"{r['levels']} levels"
                     if impl == "pallas" else f"copies {r['copies']} (JAX's "
                     f"K {r['jax_copies']}), {r['points_per_thread']} points "
                     f"a thread")
            print(f"{name} at {r['site']} ({r['call']}), {r['rows'][0]} x "
                  f"{r['rows'][1]} bf16 ({r['valid_rows']} rows in the grid; "
                  f"densest cell {r['densest_cell_rows']} rows, densest "
                  f"16-cell tile {r['densest_tile16_rows']}) -> {r['grid']}: "
                  f"bit-exact vs plain and impl='auto'; {shape}, "
                  f"{r['warps']} warps; kernel {r['ms']:.4f} ms (device "
                  f"{r['device_ms']:.4f}), plain {r['plain_ms']:.4f} ms, "
                  f"library {r['library_ms']:.4f} ms (device "
                  f"{r['library_device_ms']:.4f}), bound {r['bound_ms']:.4f} "
                  f"ms ({r['mb']:.1f} MB), bound / device time "
                  f"{r['bound_ms'] / r['device_ms']:.3f}; "
                  f"voxel_max_pool impl={impl!r} {r['entry_ms']:.4f} ms vs "
                  f"'auto' {r['auto_ms']:.4f} ms", flush=True)
        largest = max(rows[impl], key=lambda r: r["mb"])
        entries.append({
            "name": name, "route": "cuda",
            "source": f"streammos_tpu_torch/csrc/{lib}.cu",
            "replaces": repl, "replaces_function": fn, "ok": True,
            "max_abs_err": max(r["max_abs_err"] for r in rows[impl]
                               + adversarial[impl]),
            **{k: largest[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms", "device_ms",
                                        "library_device_ms")},
            "device_ms_note": "device_ms and library_device_ms: the call "
                              "replayed from a CUDA graph; ms, plain_ms and "
                              "library_ms: the call issued from Python",
            "library_call": "torch.zeros + scatter_reduce_(amax) with a "
                            "sentinel row (the impl='auto' body)",
            "site": largest["site"], "launches": launches[impl],
            "launches_in": f"voxel_max_pool(impl={impl!r}) at the "
                           f"{len(rows[impl])} sites of a frame",
            "ptxas": ptxas,
            "sites": rows[impl], "adversarial": adversarial[impl],
            "dtype": "bfloat16"})
    return entries


def counted_kernels():
    from streammos_tpu_torch.ops import fused_header as fh
    from streammos_tpu_torch.ops import pallas_scatter as ps
    from streammos_tpu_torch.ops import pallas_scatter_vmem as pv

    return (fh.fused_header_tta, ps.sorted_scatter_max, pv.scatter_max_vmem)


def main_path_phase(dev, cfg):
    """The user's loop, `serve.stream_eval`, over one sequence: the first
    frame fresh, the memory carried after."""
    from streammos_tpu_torch import serve
    from streammos_tpu_torch.scans import skewed_scan_bank

    model = serve.build_model(cfg, with_refine=True, device=dev, seed=SEED)
    T = cfg.model.seq_num
    rng = np.random.default_rng(SEED)
    bank = torch.from_numpy(skewed_scan_bank(rng, WARMUP_FRAMES + FRAMES, T,
                                             POINTS)).to(dev)
    frames = [{"xyzi": f[0], "seq_id": "00"} for f in bank]  # (T, N, 4) each

    for _ in serve.stream_eval(model, frames[:WARMUP_FRAMES]):
        pass
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats(dev)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(FRAMES + 1)]
    outs = []
    counted = counted_kernels()
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    events[0].record()
    for scores, bf_scores in serve.stream_eval(model, frames[WARMUP_FRAMES:]):
        events[len(outs) + 1].record()
        outs.append((scores, bf_scores))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

    check(len(outs) == FRAMES, f"{len(outs)} frames out of {FRAMES}")
    ms = [events[i].elapsed_time(events[i + 1]) for i in range(FRAMES)]
    for scores, bf_scores in outs:
        for s in (scores, bf_scores):
            check(s is not None and tuple(s.shape) == (POINTS, 3),
                  f"scores shape {None if s is None else tuple(s.shape)}")
            check(bool(torch.isfinite(s).all()), "scores finite")
            sums_err = float((s.sum(-1) - 1).abs().max())
            check(sums_err < 1e-4, f"scores sum to 1 (err {sums_err})")
    check(launches["fused_header_tta"] == FRAMES,
          f"fused header launches {launches} != {FRAMES}")
    print(f"main path StreamMOS_seg bf16, {POINTS} points x T={T}, TTA x4 "
          f"folded, {FRAMES} frames through serve.stream_eval: "
          f"{np.mean(ms):.3f} ms/frame mean, {np.median(ms):.3f} median, "
          f"{1000 / np.mean(ms):.2f} frames/s (CUDA events); host wall "
          f"{wall_s:.3f} s; peak memory {peak_gb:.2f} GB; launches {launches}",
          flush=True)
    print("per-frame ms: " + ", ".join(f"{m:.3f}" for m in ms), flush=True)
    return {"launches": launches, "ms_per_frame": float(np.mean(ms)),
            "peak_gb": peak_gb}


def small_agreement_phase(dev):
    """Port on the card (kernel) vs port on the CPU (plain versions)."""
    from streammos_tpu_torch import serve
    from streammos_tpu_torch.config import get_config
    from streammos_tpu_torch.models.stream_mos import featurize, tta_expand_folded
    from streammos_tpu_torch.scans import skewed_scan_bank

    cfg = get_config("StreamMOS_tiny")
    cpu = serve.build_model(cfg, device="cpu", seed=SEED)
    gpu = serve.build_model(cfg, device=dev, seed=SEED)
    rng = np.random.default_rng(SEED + 1)
    xyzi = torch.from_numpy(skewed_scan_bank(rng, 2, cfg.model.seq_num, 1024))
    mem = {m: serve.initial_memory(m) for m in (cpu, gpu)}
    worst = 0.0
    with torch.inference_mode():
        for i in range(2):
            outs = {}
            for m in (cpu, gpu):
                dv = next(m.parameters()).device
                batch = featurize(tta_expand_folded(xyzi[i].to(dv)), cfg.model)
                outs[m] = m(batch["points"], batch["bev_coord"],
                            batch["rv_coord"], mem[m], i > 0)
                mem[m] = outs[m]["memory"]
            for key in ("pred_folded", "bf_pred_folded", "aux0", "aux1",
                        "aux2", "memory"):
                a, b = outs[cpu][key], outs[gpu][key].cpu()
                err = float(((a - b).abs() - 2e-3 * a.abs()).max())
                worst = max(worst, float((a - b).abs().max()))
                check(err <= 2e-3, f"tiny {key} frame {i}: card vs CPU {err}")
    print(f"small input (StreamMOS_tiny f32, 2 frames): card vs CPU max abs "
          f"diff {worst:.3e} (tolerance 2e-3 + 2e-3*|ref|)", flush=True)


def train_windows(cfg, dev, stage2: bool, points: int, seed: int):
    """S windows of range-skewed scans (S, 1, T, N, 4) and labels drawn
    from the seed (bf_targets for stage 2), on `dev`."""
    from streammos_tpu_torch.scans import skewed_scan_bank

    rng = np.random.default_rng(seed)
    xyzi = skewed_scan_bank(rng, TRAIN_WINDOWS, cfg.model.seq_num, points)
    shape = (TRAIN_WINDOWS, 1, points)
    w = {"xyzi": xyzi,
         "targets": rng.integers(0, 3, shape).astype(np.int32)}
    if stage2:
        w["bf_targets"] = rng.integers(0, 3, shape).astype(np.int32)
    return {k: torch.from_numpy(v).to(dev) for k, v in w.items()}


def device_busy(fn):
    """One call of `fn` under torch.profiler (CUDA activity only): the
    summed device time (ms) and the number of what ran on the card
    (kernels, copies, fills), and the five costliest by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    check(bool(evs), "the profiler saw no device activity")
    top = sorted(evs, key=lambda e: e.device_time_total, reverse=True)[:5]
    return {"device_ms": sum(e.device_time_total for e in evs) / 1e3,
            "launches": sum(e.count for e in evs),
            "top": [[e.key[:60], e.device_time_total / 1e3, e.count]
                    for e in top]}


def train_setup(cfg, stage2: bool, dev, seed: int):
    """The trainer's objects: model (drawn from the seed), SGD with the
    config's schedule and freeze mask, state and step."""
    from streammos_tpu_torch import train as tr

    model = tr.build_train_model(cfg, stage2=stage2, device=dev, seed=seed)
    tx, _ = tr.build_optimizer(cfg.optimize, per_epoch_iters=100,
                               params=dict(model.named_parameters()),
                               freeze_except=cfg.freeze_except if stage2
                               else None)
    return (model, tr.create_train_state(model, tx),
            tr.make_train_step(model, cfg, tx, stage2=stage2))


def train_phase(dev):
    """Stage 1 and stage 2 at full width through `make_train_step`."""
    from streammos_tpu_torch.config import get_config

    out = {}
    for stage2, cfg_name in ((False, "StreamMOS"), (True, "StreamMOS_seg")):
        cfg = get_config(cfg_name)
        model, state, step = train_setup(cfg, stage2, dev, SEED)
        windows = train_windows(cfg, dev, stage2, TRAIN_POINTS, SEED + 2)
        gen = torch.Generator().manual_seed(SEED)
        before = {k: v.detach().clone() for k, v in model.state_dict().items()}
        counted = counted_kernels()
        for fn in counted:
            fn.launches = 0
        losses = []
        for _ in range(TRAIN_WARMUP):
            state, metrics = step(state, windows, gen)
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(TRAIN_STEPS + 1)]
        t0 = time.perf_counter()
        events[0].record()
        for i in range(TRAIN_STEPS):
            state, metrics = step(state, windows, gen)
            losses.append(metrics["loss"])
            events[i + 1].record()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counted}
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        busy = device_busy(lambda: step(state, windows, gen))
        s_step = [events[i].elapsed_time(events[i + 1]) / 1e3
                  for i in range(TRAIN_STEPS)]
        losses = [float(x) for x in losses]
        grad_norm = float(metrics["grad_norm"])

        check(all(np.isfinite(losses)) and np.isfinite(grad_norm),
              f"{cfg_name} losses {losses}, grad norm {grad_norm}")
        check(state.step == TRAIN_WARMUP + TRAIN_STEPS + 1, "steps taken")
        check(launches["fused_header_tta"] == 0,
              f"{cfg_name} training launched the fused header: {launches}")
        after = model.state_dict()
        params = [n for n, _ in model.named_parameters()]
        stats = [k for k in after if k.endswith(("running_mean",
                                                 "running_var"))]
        changed = [n for n in params if not torch.equal(after[n], before[n])]
        if stage2:
            refine = [n for n in params if n.startswith("refine.")]
            check(sorted(changed) == sorted(refine),
                  f"stage 2 changed {len(changed)} parameters, "
                  f"{len(set(changed) - set(refine))} outside refine; "
                  f"{len(set(refine) - set(changed))} refine unchanged")
            backbone = [k for k in stats if not k.startswith("refine.")]
            moved = [k for k in backbone
                     if not torch.equal(after[k], before[k])]
            check(len(moved) == len(backbone),
                  f"stage 2 backbone BN statistics moved: {len(moved)} of "
                  f"{len(backbone)}")
            what = (f"{len(changed)} refine parameters changed, the other "
                    f"{len(params) - len(changed)} bit-identical, "
                    f"{len(moved)} backbone BN statistics moved")
        else:
            check(len(changed) == len(params),
                  f"stage 1 changed {len(changed)} of {len(params)} "
                  f"parameters")
            what = f"all {len(params)} parameters changed"
        print(f"train {cfg_name} (stage {2 if stage2 else 1}) bf16, "
              f"{TRAIN_POINTS} points x T={cfg.model.seq_num} x "
              f"{TRAIN_WINDOWS} windows, bs1, SGD-Nesterov: "
              f"{np.mean(s_step):.4f} s/step mean over {TRAIN_STEPS} "
              f"(CUDA events; per step "
              + ", ".join(f"{x:.4f}" for x in s_step)
              + f"), host wall {wall_s / TRAIN_STEPS:.4f} s/step, peak "
              f"memory {peak_gb:.2f} GB; losses "
              + ", ".join(f"{x:.4f}" for x in losses)
              + f"; grad norm {grad_norm:.4f}; {what}; launches {launches}",
              flush=True)
        print(f"train {cfg_name} one more step under torch.profiler: "
              f"{busy['device_ms']:.2f} ms of device time in "
              f"{busy['launches']} kernels/copies/fills, "
              f"{busy['device_ms'] / 1e3 / np.mean(s_step):.3f} of the "
              f"unprofiled step; costliest: "
              + "; ".join(f"{k} {t:.2f} ms x{c}" for k, t, c in busy["top"]),
              flush=True)
        out[cfg_name] = {"stage": 2 if stage2 else 1,
                         "s_per_step": float(np.mean(s_step)),
                         "s_per_step_each": s_step,
                         "peak_memory_gb": peak_gb, "losses": losses,
                         "launches": launches,
                         "device_ms_per_step": busy["device_ms"],
                         "device_launches_per_step": busy["launches"],
                         "device_busy_share": busy["device_ms"] / 1e3
                         / float(np.mean(s_step))}
        del model, state, step, windows, before, after
        torch.cuda.empty_cache()
    return out


def train_agreement(dev):
    """One stage-1 and one stage-2 step of StreamMOS_tiny (float32,
    dropout off) on `dev` and on the CPU, same weights and windows.
    Tolerances: loss rtol 1e-4; gradient norm rtol 1e-3; BN statistics
    rtol = atol = 1e-3; the updates, all parameters together, within a
    relative L2 distance of 1e-2, each parameter's within 5e-2 (a ReLU
    input or a scatter's runner-up within ~1e-6 of its switch routes the
    gradient differently on the two devices; on the CPU, such a switch
    between the port and JAX moved the update by 1.4e-3 overall and 8e-3
    in its worst tensor). Returns the largest differences seen."""
    import dataclasses

    from streammos_tpu_torch.config import get_config

    cfg = get_config("StreamMOS_tiny")
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dropout_rate=0.0),
        optimize=dataclasses.replace(cfg.optimize, pct_start=0.0))
    worst = {}
    for stage2 in (False, True):
        runs = []
        for d in ("cpu", dev):
            model, state, step = train_setup(cfg, stage2, d, SEED + 3)
            before = {k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()}
            windows = train_windows(cfg, d, stage2, 1024, SEED + 4)
            state, metrics = step(state, windows)
            runs.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                         before, {k: v.detach().cpu()
                                  for k, v in model.state_dict().items()},
                         [n for n, _ in model.named_parameters()]))
        (l0, g0, b0, a0, names), (l1, g1, _, a1, _) = runs
        name = f"stage {2 if stage2 else 1}"
        check(abs(l1 - l0) <= 1e-4 * abs(l0), f"{name} loss {l1} vs {l0}")
        check(abs(g1 - g0) <= 1e-3 * abs(g0), f"{name} grad norm {g1} vs {g0}")
        stat_err = 0.0
        for k in a0:
            if k.endswith(("running_mean", "running_var")):
                excess = float(((a1[k] - a0[k]).abs()
                                - 1e-3 * (1 + a0[k].abs())).max())
                stat_err = max(stat_err, float((a1[k] - a0[k]).abs().max()))
                check(excess <= 0, f"{name} {k}: card vs CPU")
        num = den = 0.0
        tensor_err = 0.0
        for n in names:
            d0, d1 = a0[n] - b0[n], a1[n] - b0[n]
            if not d0.any():
                check(not d1.any(), f"{name} {n} moved on the card only")
                continue
            dist = float((d1 - d0).norm())
            num, den = num + dist ** 2, den + float(d0.norm()) ** 2
            tensor_err = max(tensor_err, dist / float(d0.norm()))
        overall = (num / den) ** 0.5
        check(tensor_err <= 5e-2 and overall <= 1e-2,
              f"{name} updates: relative L2 {overall} overall, "
              f"{tensor_err} worst tensor")
        print(f"small train step (StreamMOS_tiny f32, {name}): card vs CPU "
              f"loss {l1:.6f} vs {l0:.6f}, grad norm {g1:.5f} vs {g0:.5f}, "
              f"updates relative L2 {overall:.3e} overall / {tensor_err:.3e} "
              f"worst tensor, BN statistics max abs diff {stat_err:.3e} "
              f"(tolerances: loss 1e-4, grad norm 1e-3 relative; updates "
              f"1e-2 / 5e-2; statistics 1e-3 + 1e-3*|ref|)", flush=True)
        worst[name] = {"update_rel_l2": overall, "worst_tensor": tensor_err,
                       "stat_abs": stat_err}
    return worst


def write_tree(root: str) -> str:
    """The synthetic SemanticKITTI tree of the dataset phase (numpy, from
    the seed): sequences 08 and 00 of RAW_POINTS-point scans (a moving
    car, road, a building), labels, poses, calib. `tests/synthetic_kitti.py`
    is loaded by its path: an installed package named `tests` may shadow
    the repository's directory."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "synthetic_kitti", os.path.join(REPO, "tests", "synthetic_kitti.py"))
    synthetic = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synthetic)
    make_sequence = synthetic.make_sequence
    seqs = os.path.join(root, "sequences")
    for i, (seq, n) in enumerate(DATA_FRAMES.items()):
        make_sequence(seqs, seq, n_frames=n, n_points=RAW_POINTS,
                      seed=SEED + i)
    return seqs


def loader_timings(seqs: str):
    """Host time a sample of `EvalDataset` (native and numpy path, 160k
    points, sequence 08) and of `TrainDataset` (StreamMOS, 130k points,
    sequence 00; inline and through `SampleWorkerPool` at the config's
    workers). The two eval paths must give identical arrays."""
    from streammos_tpu_torch.config import get_config
    from streammos_tpu_torch.data.dataset import EvalDataset, TrainDataset
    from streammos_tpu_torch.data.loader import SampleWorkerPool

    seg = get_config("StreamMOS_seg")
    dcfg = dataclasses.replace(seg.val, seq_dir=seqs, frame_point_num=POINTS)
    out = {}
    samples = {}
    for native in (True, False):
        ds = EvalDataset(dcfg, seq_ids=[8], native=native)
        ds[0]  # the native library builds on its first call
        t0 = time.perf_counter()
        samples[native] = [ds[i] for i in range(len(ds))]
        out["eval_native_ms" if native else "eval_numpy_ms"] = (
            (time.perf_counter() - t0) / len(ds) * 1e3)
    for a, b in zip(samples[True], samples[False]):
        for k in a:
            same = (np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray)
                    else a[k] == b[k])
            check(same, f"EvalDataset native != numpy at {k}")
    n_valid = POINTS - samples[True][0]["pad_length"]
    del samples

    cfg = get_config("StreamMOS")
    tcfg = dataclasses.replace(cfg.train, seq_dir=seqs,
                               frame_point_num=TRAIN_POINTS)
    ds = TrainDataset(tcfg, seq_ids=[0], seed=SEED)
    t0 = time.perf_counter()
    for i in range(len(ds)):
        sample = ds[i]
    out["train_inline_ms"] = (time.perf_counter() - t0) / len(ds) * 1e3
    check(sample["xyzi"].shape == (3, 3, TRAIN_POINTS, 4), "train sample")
    order = list(range(len(ds))) * 2
    t0 = time.perf_counter()
    with SampleWorkerPool(ds, tcfg.num_workers, seed=SEED) as pool:
        stamps = [time.perf_counter() for _ in pool.map_ordered(order)]
        workers = pool.num_workers
    out["train_pool_startup_s"] = stamps[0] - t0
    out["train_pool_ms"] = (stamps[-1] - stamps[0]) / (len(order) - 1) * 1e3
    out["train_pool_workers"] = workers
    print(f"loader (host, {RAW_POINTS}-point scans): EvalDataset "
          f"{out['eval_native_ms']:.1f} ms/sample native, "
          f"{out['eval_numpy_ms']:.1f} numpy (identical arrays; {n_valid} "
          f"valid of {POINTS}); TrainDataset ({TRAIN_POINTS} points, 3 "
          f"windows x T=3) {out['train_inline_ms']:.1f} ms/sample inline, "
          f"{out['train_pool_ms']:.1f} through SampleWorkerPool({workers}) "
          f"once running ({out['train_pool_startup_s']:.2f} s to its first "
          f"sample)", flush=True)
    return out


def val_cli_phase(seqs: str, work: str):
    """The val CLI's function (`tools.val.run_eval`) in process, as
    `python -m streammos_tpu_torch.tools.val --config StreamMOS_seg --data
    ... --points 160000` runs it on sequence 08 with weights drawn from the
    config's seed: CUDA events around each `serve.eval_step`, host wall of
    the stream (load, step, argmax to the host, `.label` written), both
    a frame after the first; launch counts zeroed just before and read
    just after."""
    from streammos_tpu_torch import serve
    from streammos_tpu_torch.tools import val as val_cli
    from streammos_tpu_torch.train import evaluate
    from streammos_tpu_torch.utils.logging import config_logger

    frames = DATA_FRAMES["08"]
    args = val_cli.parse_args(["--config", "StreamMOS_seg", "--tag", "smoke",
                               "--data", seqs, "--points", str(POINTS)])
    cfg = val_cli.eval_config(args)
    events, starts, ends = [], [], []
    step, stream = serve.eval_step, evaluate.stream_eval

    def timed_step(*a, **k):
        starts.append(time.perf_counter())
        pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        pair[0].record()
        out = step(*a, **k)
        pair[1].record()
        events.append(pair)
        return out

    def timed_stream(*a, **k):
        out = stream(*a, **k)
        ends.append(time.perf_counter())
        return out

    counted = counted_kernels()
    cwd = os.getcwd()
    os.chdir(work)
    serve.eval_step, evaluate.stream_eval = timed_step, timed_stream
    try:
        logger = config_logger(os.path.join("experiments", cfg.name, "smoke",
                                            "log_val.txt"))
        for fn in counted:
            fn.launches = 0
        result = val_cli.run_eval(cfg, args, True, logger)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counted}
    finally:
        serve.eval_step, evaluate.stream_eval = step, stream
        os.chdir(cwd)

    exp = os.path.join(work, "experiments", "StreamMOS_seg", "smoke")
    for sub, allowed in (("val_results", {0, 9, 251}),
                         ("val_bf_results", {0, 1, 2})):
        d = os.path.join(exp, sub, "sequences", "08", "predictions")
        names = sorted(os.listdir(d))
        check(names == [f"{i:06d}.label" for i in range(frames)],
              f"{sub}: {len(names)} label files for {frames} frames")
        for name in names:
            lab = np.fromfile(os.path.join(d, name), dtype=np.uint32)
            check(lab.shape == (RAW_POINTS,), f"{sub}/{name} {lab.shape}")
            check(set(np.unique(lab).tolist()) <= allowed,
                  f"{sub}/{name} values {np.unique(lab)}")
    with open(os.path.join(exp, "record_0.txt")) as f:
        record = f.read().strip().splitlines()
    check(len(record) == 1, f"record_0.txt has {len(record)} lines")
    miou = float(record[0].split("moving_iou: ")[1].split(";")[0])
    check(np.isfinite(miou) and np.isfinite(result["moving_iou"]),
          f"moving_iou {miou}")
    check(launches["fused_header_tta"] == frames,
          f"CLI path header launches {launches} != {frames} frames")
    check(launches["sorted_scatter_max"] == 0
          and launches["scatter_max_vmem"] == 0,
          f"CLI path scatter launches {launches}")
    ms = [a.elapsed_time(b) for a, b in events]
    check(len(ms) == frames and len(ends) == 1, "one step a frame")
    # after the first frame: the stream's wall from the second frame's
    # step to the last label file written, a frame
    return {"frames": frames, "launches": launches, "moving_iou": miou,
            "eval_step_ms": float(np.mean(ms[1:])),
            "eval_step_ms_first": ms[0], "eval_step_ms_each": ms,
            "host_wall_ms_per_frame": (ends[0] - starts[1]) / (frames - 1)
            * 1e3}


def train_cli_phase(seqs: str, work: str):
    """`python -m streammos_tpu_torch.tools.train` as a subprocess:
    StreamMOS, batch 1, 130k points, 4 steps, one epoch, validation over
    sequence 08 after it; then the same command again, which must resume
    and take no step. Returns the s/step the trainer logged."""
    cmd = [sys.executable, "-m", "streammos_tpu_torch.tools.train",
           "--config", "StreamMOS", "--tag", "smoke", "--data", seqs,
           "--batch-size", "1", "--points", str(TRAIN_POINTS),
           "--max-steps", str(CLI_STEPS), "--epochs", "1",
           "--start-val-epoch", "0"]
    env = dict(os.environ, PYTHONPATH=REPO)
    exp = os.path.join(work, "experiments", "StreamMOS", "smoke")
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=work, env=env, capture_output=True,
                              text=True, timeout=600)
        runs.append(time.perf_counter() - t0)
        check(proc.returncode == 0, f"train CLI exit {proc.returncode}:\n"
              f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
        if len(runs) == 1:
            with open(os.path.join(exp, "scalars.jsonl")) as f:
                first = [json.loads(line) for line in f]

    check(os.path.exists(os.path.join(exp, "checkpoint", "0000", "state.pt")),
          "checkpoint 0000/state.pt")
    losses = [s["value"] for s in first if s["tag"] == "loss"]
    check(bool(losses) and all(np.isfinite(losses)), f"losses {losses}")
    check(any(s["tag"].startswith("val/") for s in first), "a val/ scalar")
    with open(os.path.join(exp, "train_split_dynamic_pointnumber.txt")) as f:
        drop = f.read().split()
    check(len(drop) > 0 and len(drop) % 3 == 0, f"drop list {len(drop)}")
    with open(os.path.join(exp, "scalars.jsonl")) as f:
        check(len(f.readlines()) == len(first), "the resumed run logged")
    with open(os.path.join(exp, "log_train.txt")) as f:
        log = f.read()
    check("resumed from epoch 0" in log, "the second run did not resume")
    line = next(l for l in log.splitlines() if f"epoch 0: {CLI_STEPS} steps in"
                in l)
    s_step, s_after = (float(p.split(" s/step")[0])
                       for p in line.split(", ")[1:3])
    val_line = next(l for l in log.splitlines() if "evaluated" in l)
    print(f"train CLI StreamMOS bs1, {TRAIN_POINTS} points, {CLI_STEPS} "
          f"steps: {s_step:.4f} s/step logged, {s_after:.4f} after the first "
          f"(first batch in hand to last step done); in-train validation: "
          f"{val_line.split('INFO ')[-1]}; "
          f"checkpoint, drop list ({len(drop) // 3} frames), val/ scalars "
          f"written; the second run resumed from epoch 0 and took no step; "
          f"process wall {runs[0]:.1f} s and {runs[1]:.1f} s", flush=True)
    return {"steps": CLI_STEPS, "s_per_step_logged": s_step,
            "s_per_step_after_first": s_after, "process_wall_s": runs}


def dataset_phase(work: str, main, train):
    """The host side on a synthetic SemanticKITTI tree under `work`: loader
    timings, the val CLI's function in process, the train CLI as a
    subprocess. Returns the results and the tree's `sequences` dir."""
    t0 = time.perf_counter()
    seqs = write_tree(work)
    print(f"dataset phase: synthetic tree {DATA_FRAMES} frames of "
          f"{RAW_POINTS} points written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    loader = loader_timings(seqs)
    val = val_cli_phase(seqs, work)
    print(f"val CLI StreamMOS_seg bf16, {POINTS} points, "
          f"{val['frames']} frames of sequence 08, after the first: "
          f"eval_step {val['eval_step_ms']:.3f} ms/frame (CUDA events; "
          f"first frame {val['eval_step_ms_first']:.3f}), host wall "
          f"{val['host_wall_ms_per_frame']:.3f} ms/frame (load to "
          f"written .label) vs the main path's in-memory "
          f"{main['ms_per_frame']:.3f} ms/frame; moving_iou "
          f"{val['moving_iou']:.4f}; launches {val['launches']}",
          flush=True)
    cli = train_cli_phase(seqs, work)
    print(f"train CLI {cli['s_per_step_after_first']:.4f} s/step after "
          f"the first vs the train phase's in-memory "
          f"{train['StreamMOS']['s_per_step']:.4f} s/step after 2 warm-up "
          f"steps (StreamMOS, bs1, {TRAIN_POINTS} points)", flush=True)
    return {"raw_points": RAW_POINTS, "frames": DATA_FRAMES, "loader": loader,
            "val_cli": val, "train_cli": cli}, seqs


VOTED = re.compile(r"seq 08: voted (\d+) frames in ([0-9.]+) s, the first "
                   r"after ([0-9.]+) s")


def voting_cli_runs(seqs: str, work: str):
    """The voting CLI with --instance over the val CLI's output of
    sequence 08 (StreamMOS_seg, tag smoke), once a backend: numpy as a user
    runs it (a subprocess, its pool spawned), the device backend in this
    process on the card (so that the kernels' counts see it). The refined
    files of both must be byte-equal, and the IoU lines equal. Returns each
    backend's wall a frame, pool start-up included, as the CLI reports it,
    and the frames."""
    import contextlib
    import io

    from streammos_tpu_torch.tools import voting as voting_cli

    argv = ["--config", "StreamMOS_seg", "--tag", "smoke", "--data", seqs,
            "--instance"]
    refined = os.path.join(work, "experiments", "StreamMOS_seg", "smoke",
                           "refine_val_results")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "streammos_tpu_torch.tools.voting", *argv,
         "--vote", "numpy"], cwd=work, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=600)
    process_wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"voting CLI (numpy) exit {proc.returncode}:"
          f"\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    outs = {"numpy": proc.stdout}
    os.rename(refined, refined + "_numpy")

    printed = io.StringIO()
    cwd = os.getcwd()
    os.chdir(work)
    try:
        with contextlib.redirect_stdout(printed):
            voting_cli.main(argv + ["--vote", "device"])
    finally:
        os.chdir(cwd)
    outs["device"] = printed.getvalue()

    sub = os.path.join("sequences", "08", "predictions")
    names = sorted(os.listdir(os.path.join(refined, sub)))
    frames = DATA_FRAMES["08"]
    check(names == [f"{i:06d}.label" for i in range(frames)],
          f"voting wrote {len(names)} files for {frames} frames")
    for name in names:
        with open(os.path.join(refined, sub, name), "rb") as a, \
                open(os.path.join(refined + "_numpy", sub, name), "rb") as b:
            check(a.read() == b.read(), f"refined {name}: numpy != device")
    iou = {k: v.strip().splitlines()[-1] for k, v in outs.items()}
    check(iou["numpy"] == iou["device"] and "moving_iou: " in iou["numpy"],
          f"voting IoU lines differ: {iou}")
    s_frame, after_first = {}, {}
    for k, v in outs.items():
        m = VOTED.search(v)
        check(m is not None and int(m.group(1)) == frames,
              f"voting ({k}) printed no timing line")
        wall, first = float(m.group(2)), float(m.group(3))
        s_frame[k] = wall / frames
        after_first[k] = (wall - first) / (frames - 1)
    return {"frames": frames, "s_per_frame": s_frame,
            "s_per_frame_after_first": after_first,
            "numpy_process_wall_s": process_wall, "iou": iou["numpy"]}


def vote_case(voxel, root: str):
    """A production-size vote: VOTE_SCANS synthetic scans of RAW_POINTS
    points (`tools/synthetic.py`, written under `root`), the history
    ego-aligned with the last, current one as the CLI aligns it;
    predictions drawn from the seed, and the current frame's first 60k
    points given a second vote of another class, so that many cells tie.
    Returns the vote's arguments and the number of tie cells."""
    from streammos_tpu_torch import host_geometry
    from streammos_tpu_torch.postprocess.voting import _linear_cells, crop_mask
    from streammos_tpu_torch.tools.synthetic import make_big_sequence

    make_big_sequence(root, "00", VOTE_SCANS, RAW_POINTS, seed=SEED + 9)
    seq = os.path.join(root, "00")
    poses = host_geometry.parse_poses(
        os.path.join(seq, "poses.txt"),
        host_geometry.parse_calibration(os.path.join(seq, "calib.txt")))
    inv = np.linalg.inv(poses[-1])
    scans = [host_geometry.np_transform(np.fromfile(
        os.path.join(seq, "velodyne", f"{i:06d}.bin"), np.float32
    ).reshape(-1, 4), inv @ poses[i])[:, :3] for i in range(VOTE_SCANS)]
    rng = np.random.default_rng(SEED + 9)
    preds = [rng.integers(0, 3, RAW_POINTS) for _ in scans]
    cur, cur_pred = scans[-1], preds[-1]
    local = np.concatenate(scans + [cur[:60_000]])
    local_pred = np.concatenate(preds + [(cur_pred[:60_000] + 1) % 3])
    keep, ckeep = crop_mask(local, voxel), crop_mask(cur, voxel)
    args = (local[keep], local_pred[keep], cur[ckeep], cur_pred[ckeep], voxel)
    lin, _ = _linear_cells(args[0], voxel)
    counts = np.bincount(lin * 3 + args[1])
    counts = np.pad(counts, (0, (-counts.size) % 3)).reshape(-1, 3)
    top = counts.max(axis=1, keepdims=True)
    ties = int(((counts == top).sum(axis=1) >= 2)[top[:, 0] > 0].sum())
    return args, ties


def voting_phase(seqs: str, work: str):
    """The long-term-memory voting on the card: the voting CLI over the val
    CLI's output (both backends, byte-equal), then one production-size vote
    (`vote_case`: numpy against CUDA, bit-equal, on a case with ties) timed: host wall a
    frame of each backend, CUDA events around the device vote and its
    device time under the profiler, the local-map points and the counters'
    bytes. Launch counts zeroed just before, read just after: the voting
    path launches no hand kernel. Prints which backend was faster and what
    `--vote auto` resolves to."""
    from streammos_tpu_torch.config import get_config
    from streammos_tpu_torch.postprocess.voting import (voxel_vote,
                                                        voxel_vote_device)
    from streammos_tpu_torch.tools.voting import resolve_vote_backend

    counted = counted_kernels()
    for fn in counted:
        fn.launches = 0
    cli = voting_cli_runs(seqs, work)

    voxel = get_config("StreamMOS_seg").model.voxel
    args, ties = vote_case(voxel, os.path.join(work, "vote"))
    check(ties > 0, "the production vote case has no tie")
    n_cells = int(np.prod(voxel.bev_shape))
    host = {"numpy": [], "device": []}
    events = []
    want = voxel_vote(*args)
    got = voxel_vote_device(*args, device="cuda")  # warm-up
    check(np.array_equal(got, want), "production vote: numpy != CUDA")
    for _ in range(VOTE_REPS):
        t0 = time.perf_counter()
        want = voxel_vote(*args)
        host["numpy"].append(time.perf_counter() - t0)
        pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        pair[0].record()
        got = voxel_vote_device(*args, device="cuda")
        pair[1].record()
        torch.cuda.synchronize()
        host["device"].append(time.perf_counter() - t0)
        events.append(pair[0].elapsed_time(pair[1]))
        check(np.array_equal(got, want), "production vote: numpy != CUDA")
    busy = device_busy(lambda: voxel_vote_device(*args, device="cuda"))
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    check(not any(launches.values()), f"voting path launches {launches}")

    prod = {"scans": VOTE_SCANS, "local_points": int(args[0].shape[0]),
            "current_points": int(args[2].shape[0]), "tie_cells": ties,
            "counter_bytes": n_cells * 3 * 8,
            "numpy_ms": float(np.mean(host["numpy"]) * 1e3),
            "device_ms": float(np.mean(host["device"]) * 1e3),
            "device_event_ms": float(np.mean(events)),
            "device_busy_ms": busy["device_ms"],
            "device_busy_launches": busy["launches"]}
    auto = "device" if resolve_vote_backend("auto") else "numpy"
    steady = cli["s_per_frame_after_first"]
    faster = min(steady, key=steady.get)
    print(f"voting CLI StreamMOS_seg --instance, {cli['frames']} frames of "
          f"sequence 08 ({RAW_POINTS}-point scans, the val CLI's labels), 8 "
          f"workers, host wall: numpy {cli['s_per_frame']['numpy']:.4f} "
          f"s/frame with the pool's start-up, {steady['numpy']:.4f} after "
          f"the first frame; device {cli['s_per_frame']['device']:.4f}, "
          f"{steady['device']:.4f} after the first (numpy process wall "
          f"{cli['numpy_process_wall_s']:.1f} s); refined files byte-equal; "
          f"{cli['iou']}", flush=True)
    print(f"voting production vote ({VOTE_SCANS} scans of {RAW_POINTS} "
          f"points, grid {voxel.bev_shape}, 3 classes): local map "
          f"{prod['local_points']} points, {prod['current_points']} current, "
          f"{ties} tie cells; counters {prod['counter_bytes']} bytes (int64); "
          f"numpy {prod['numpy_ms']:.1f} ms/frame, device "
          f"{prod['device_ms']:.1f} ms/frame host wall ({VOTE_REPS} reps), "
          f"{prod['device_event_ms']:.3f} ms CUDA events around the call, "
          f"{busy['device_ms']:.3f} ms of device time in {busy['launches']} "
          f"launches ({busy['top']}); numpy == CUDA bit for bit; launches "
          f"{launches}", flush=True)
    print(f"voting: faster backend on this card (CLI s/frame after the "
          f"first): {faster}; --vote auto resolves to {auto}", flush=True)
    return {"cli": cli, "production": prod, "launches": launches,
            "faster": faster, "auto": auto}


REHEARSAL = ["--steps", "4", "--steps2", "2", "--frames", "12",
             "--val-frames", "8"]


def rehearsal_phase():
    """`python -m streammos_tpu_torch.tools.dress_rehearsal` at a cut depth
    (REHEARSAL) as a subprocess, in a directory under `build/`: stage 1,
    stage 2, val, voting, each the port's CLI on the card. Its JSON lines
    are passed through; its summary must say ok, and the refined labels
    number the val frames."""
    with tempfile.TemporaryDirectory(prefix="smoke_rehearsal_",
                                     dir=os.path.join(REPO, "build")) as root:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "streammos_tpu_torch.tools.dress_rehearsal",
             *REHEARSAL, "--root", root], cwd=root,
            env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
            text=True, timeout=900)
        wall = time.perf_counter() - t0
        lines = [l for l in proc.stdout.splitlines() if l.startswith("{")]
        for line in lines:
            print(line, flush=True)
        check(proc.returncode == 0, f"dress rehearsal exit {proc.returncode}:"
              f"\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
        summary = json.loads(lines[-1])
        val_frames = int(REHEARSAL[REHEARSAL.index("--val-frames") + 1])
        check(summary.get("metric") == "dress_rehearsal"
              and summary.get("ok") is True, f"rehearsal summary {summary}")
        refined = summary["artifacts"]["refined_labels"]
        check(summary["refined_frames"] == val_frames
              and len(os.listdir(refined)) == val_frames,
              f"rehearsal refined {summary['refined_frames']} of "
              f"{val_frames} frames")
        phases = {d["phase"]: d["wall_s"] for d in map(json.loads, lines[:-1])}
    print(f"dress rehearsal ({' '.join(REHEARSAL)}): ok, phases {phases} s, "
          f"process wall {wall:.1f} s", flush=True)
    return {"args": REHEARSAL, "phases": phases,
            "total_wall_s": summary["total_wall_s"], "process_wall_s": wall,
            "record_tail": summary["record_tail"],
            "voting_tail": summary["voting_tail"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from streammos_tpu_torch import build
    from streammos_tpu_torch.config import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"{smi}", flush=True)

    t0 = time.perf_counter()
    # one nvcc a kernel, all running at once
    with ThreadPoolExecutor(len(build.SOURCES)) as pool:
        list(pool.map(build.load_library, build.SOURCES))
    print(f"built {sorted(build.SOURCES)} in {time.perf_counter() - t0:.2f} s",
          flush=True)

    cfg = get_config("StreamMOS_seg")
    kernel = header_phase(dev, name, cfg)
    scatters = scatter_phase(dev, cfg)
    main = main_path_phase(dev, cfg)
    small_agreement_phase(dev)
    train = train_phase(dev)
    agreement = train_agreement(dev)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="smoke_kitti_",
                                     dir=os.path.join(REPO, "build")) as work:
        host, seqs = dataset_phase(work, main, train)
        voting = voting_phase(seqs, work)
    rehearsal = rehearsal_phase()

    kernel["launches"] = main["launches"]["fused_header_tta"]
    kernel["launches_per_frame"] = kernel["launches"] / FRAMES
    for k in scatters:
        k["launches_per_frame"] = main["launches"][k["name"]] / FRAMES
    for k in (kernel, *scatters):
        k["launches_training_path"] = sum(
            t["launches"][k["name"]] for t in train.values())
        k["launches_cli_path"] = host["val_cli"]["launches"][k["name"]]
        k["launches_voting_path"] = voting["launches"][k["name"]]
    print(json.dumps({"kernels": [kernel, *scatters],
                      "main_path": {"config": "StreamMOS_seg",
                                    "points": POINTS, "frames": FRAMES,
                                    "ms_per_frame": main["ms_per_frame"],
                                    "peak_memory_gb": main["peak_gb"]},
                      "train": {"points": TRAIN_POINTS,
                                "windows": TRAIN_WINDOWS, "batch": 1,
                                "dtype": "bfloat16",
                                "steps_timed": TRAIN_STEPS, **train,
                                "card_vs_cpu": agreement},
                      "host": host, "voting": voting,
                      "rehearsal": rehearsal}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
