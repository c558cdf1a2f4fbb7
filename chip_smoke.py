#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints no
result line):
  1. device: the card's name and power limit;
  2. build every CUDA kernel of the port from the sources in this checkout;
  3. hold each kernel against its plain PyTorch version on the card: the
     fused TTA header at the unit-test shape in float32 and at the
     production shape in bfloat16 (against the plain version run in float32
     on the same bfloat16 inputs), and time both at the production shape;
  4. the main path: `serve.stream_eval`, the streaming TTA eval of
     StreamMOS_seg (bfloat16, random weights from a seed) over one sequence
     of range-skewed frames of 160k points x T=3, memory fresh on the first
     frame and carried after; launch counts are zeroed just before and read
     just after;
  5. agreement on a small input: StreamMOS_tiny in float32 through the port
     on the card (kernel) and on the CPU (plain versions), same weights.

TF32 is off for the whole run, so float32 convolutions and matmuls on the
card are full float32. Prints one {"kernels": [...]} line, the card's name
and power limit, and as the last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
FRAMES = 8           # timed main-path frames (the first one fresh)
WARMUP_FRAMES = 2
POINTS = 160_000

# published peaks of the H100 SXM part at 700 W (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


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


def header_phase(dev, name, cfg):
    from streammos_tpu_torch.ops import fused_header as fh

    gen = torch.Generator().manual_seed(SEED)
    # unit-test shape (tests/test_fused_header.py), float32, Bt = 1 and 2
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

    # production shape, from the config the main path runs
    m = cfg.model
    T, C, Cout = m.seq_num, m.context_layers[0], m.context_layers[1]
    Hh, Wh = m.voxel.bev_wl[0] // 2, m.voxel.bev_wl[1] // 2
    g, k3, k1, ca, pa = header_inputs(gen, dev, 1, T, C, Cout, Hh, Wh,
                                      torch.bfloat16)
    got = fh.fused_header_tta(g, k3, k1, ca, pa, T)
    want = fh.fused_header_reference(g.float(), k3.float(), k1.float(),
                                     ca, pa, T)
    torch.cuda.synchronize()
    diff = (got.float() - want).abs()
    err = float(diff.max())
    excess = float((diff - (1e-2 + 1e-2 * want.abs())).max())
    print(f"fused_header bf16 production shape {tuple(g.shape)}: max_abs_err "
          f"{err:.3e} vs the float32 plain version on the same inputs "
          f"(tolerance 1e-2 + 1e-2*|ref|: bf16 output rounding)", flush=True)
    check(excess <= 0, f"fused header bf16 err {err}")
    del want, diff

    kernel_ms = time_ms(lambda: fh.fused_header_tta(g, k3, k1, ca, pa, T), 20)
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
    print(f"fused_header production: kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB, "
          f"{flops / 1e9:.2f} GFLOP)", flush=True)
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
        "shape": list(g.shape),
        "dtype": "bfloat16",
    }


def main_path_phase(dev, cfg):
    """The user's loop, `serve.stream_eval`, over one sequence: the first
    frame fresh, the memory carried after."""
    from streammos_tpu_torch import serve
    from streammos_tpu_torch.ops import fused_header as fh
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
    fh.fused_header_tta.launches = 0
    t0 = time.perf_counter()
    events[0].record()
    for scores, bf_scores in serve.stream_eval(model, frames[WARMUP_FRAMES:]):
        events[len(outs) + 1].record()
        outs.append((scores, bf_scores))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = fh.fused_header_tta.launches
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
    check(launches == FRAMES, f"fused header launches {launches} != {FRAMES}")
    print(f"main path StreamMOS_seg bf16, {POINTS} points x T={T}, TTA x4 "
          f"folded, {FRAMES} frames through serve.stream_eval: "
          f"{np.mean(ms):.3f} ms/frame mean, {np.median(ms):.3f} median, "
          f"{1000 / np.mean(ms):.2f} frames/s (CUDA events); host wall "
          f"{wall_s:.3f} s; peak memory {peak_gb:.2f} GB; fused header "
          f"launches {launches} ({launches / FRAMES:g} per frame)", flush=True)
    print("per-frame ms: " + ", ".join(f"{m:.3f}" for m in ms), flush=True)
    return {"launches": launches, "launches_per_frame": launches / FRAMES,
            "ms_per_frame": float(np.mean(ms)), "peak_gb": peak_gb}


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
    for kernel_name in build.SOURCES:
        build.load_library(kernel_name)
    print(f"built {sorted(build.SOURCES)} in {time.perf_counter() - t0:.2f} s",
          flush=True)

    cfg = get_config("StreamMOS_seg")
    kernel = header_phase(dev, name, cfg)
    main = main_path_phase(dev, cfg)
    small_agreement_phase(dev)

    kernel["launches"] = main["launches"]
    kernel["launches_per_frame"] = main["launches_per_frame"]
    print(json.dumps({"kernels": [kernel],
                      "main_path": {"config": "StreamMOS_seg",
                                    "points": POINTS, "frames": FRAMES,
                                    "ms_per_frame": main["ms_per_frame"],
                                    "peak_memory_gb": main["peak_gb"]}}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
