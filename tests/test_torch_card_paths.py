"""The port's paths on a CUDA card at the sizes users run them, skipped
where there is no card: the main path in bf16 and float32, both training
stages, the host side on a synthetic tree of 125k-point scans (datasets,
the val, train and voting CLIs, a production vote), the dress rehearsal,
data-parallel world 1 over NCCL and world 2 over gloo, and the attention
fusions' unfolded eval. TF32 is off. No jax, no JAX package:

    python -m pytest --noconftest tests/test_torch_card_paths.py -q
"""
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from streammos_tpu_torch import parallel, serve
from streammos_tpu_torch import train as tr
from streammos_tpu_torch.config import get_config
from streammos_tpu_torch.scans import skewed_scan_bank
from streammos_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0
POINTS = 160_000
WARMUP_FRAMES, FRAMES = 2, 8  # the main path's frames, the first fresh
GATHER_SITES = 5  # folded TTA gathers a StreamMOS_seg frame
SCATTER_SITES = 5  # folded TTA scatters a StreamMOS_seg frame
# eval BN epilogues a StreamMOS_seg frame: 53 BNs (the fused header applies
# the other two) and the BNs of the 5 channel-attention gates' means
BN_EPILOGUES = 58
F32_PATH_TOL = 1e-5  # about 4x what the two float32 headers differ by
TRAIN_POINTS, TRAIN_WINDOWS, TRAIN_STEPS = 130_000, 3, 7  # bs1, T = 3
DATA_FRAMES = {"08": 12, "00": 8}  # the synthetic tree: sequence -> frames
RAW_POINTS = 125_000  # points a synthetic scan (an HDL-64 scan's size)
CLI_STEPS = 4
VOTE_SCANS, VOTE_REPS = 9, 3  # 8 history scans and the current one
REHEARSAL = ["--steps", "4", "--steps2", "2", "--frames", "12",
             "--val-frames", "8"]
DP_WORLD, DP_TINY_POINTS, DP_STEPS = 2, 1024, 4
TIMEOUT = 600


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _launched(before):
    """The hand kernels' launches since the counters read `before`."""
    now = profiling.counters()
    return {k: now[k] - before.get(k, 0) for k in now
            if k.startswith("kernel.") and now[k] != before.get(k, 0)}


def _by_path(name):
    """A helper module of this directory, loaded by its path: an installed
    package named `tests` may shadow the directory."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(__file__), f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _run(cmd, cwd, timeout=TIMEOUT):
    proc = subprocess.run(cmd, cwd=cwd, env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    return proc.stdout


# ---- the main path -------------------------------------------------------

def _stream(model, frames):
    return [(s.clone(), bf.clone())
            for s, bf in serve.stream_eval(model, frames)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_main_path_at_160k_points(cuda, dtype):
    """StreamMOS_seg through `serve.stream_eval` (random weights from the
    seed; range-skewed frames of 160k points x T = 3, the memory fresh on
    the first frame and carried after): scores finite and summing to 1,
    the header kernel of the compute dtype once a frame, the gather kernel
    and the folded scatter kernel at the five sites of a frame each, the
    eval BN epilogue 58 times a frame, no other scatter kernel. In float32 the scores are those of the
    frame-split header in plain PyTorch within 1e-5."""
    cfg = get_config("StreamMOS_seg")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype=dtype))
    model = serve.build_model(cfg, with_refine=True, device=cuda, seed=SEED)
    bank = torch.from_numpy(skewed_scan_bank(
        np.random.default_rng(SEED), WARMUP_FRAMES + FRAMES,
        cfg.model.seq_num, POINTS)).to(cuda)
    frames = [{"xyzi": f[0], "seq_id": "00"} for f in bank]
    _stream(model, frames[:WARMUP_FRAMES])
    before = profiling.counters()
    outs = _stream(model, frames[WARMUP_FRAMES:])
    torch.cuda.synchronize()
    header = "bf16" if dtype == "bfloat16" else "f32"
    assert _launched(before) == {f"kernel.fused_header.{header}": FRAMES,
                                 "kernel.grid_gather_tta":
                                 GATHER_SITES * FRAMES,
                                 "kernel.scatter_tta": SCATTER_SITES * FRAMES,
                                 "kernel.bn_act": BN_EPILOGUES * FRAMES}
    assert len(outs) == FRAMES
    for pair in outs:
        for s in pair:
            assert s.shape == (POINTS, 3) and s.dtype == torch.float32
            assert torch.isfinite(s).all()
            assert float((s.sum(-1) - 1).abs().max()) < 1e-4
    if dtype == "float32":
        ref = serve.build_model(dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, fused_header=False)),
            with_refine=True, device=cuda, seed=SEED)
        _stream(ref, frames[:WARMUP_FRAMES])
        err = max(float((a - b).abs().max())
                  for pair, ref_pair in zip(outs, _stream(
                      ref, frames[WARMUP_FRAMES:]))
                  for a, b in zip(pair, ref_pair))
        assert err <= F32_PATH_TOL


# ---- training ------------------------------------------------------------

def train_setup(cfg, stage2: bool, dev, seed: int):
    """The trainer's objects: model (drawn from the seed), SGD with the
    config's schedule and freeze mask, state and step."""
    model = tr.build_train_model(cfg, stage2=stage2, device=dev, seed=seed)
    tx, _ = tr.build_optimizer(cfg.optimize, per_epoch_iters=100,
                               params=dict(model.named_parameters()),
                               freeze_except=cfg.freeze_except if stage2
                               else None)
    return (model, tr.create_train_state(model, tx),
            tr.make_train_step(model, cfg, tx, stage2=stage2))


def train_windows(cfg, dev, stage2: bool, points: int, seed: int,
                  batch: int = 1):
    """S windows of range-skewed scans (S, B, T, N, 4) and labels drawn
    from the seed (bf_targets for stage 2), on `dev`."""
    rng = np.random.default_rng(seed)
    xyzi = skewed_scan_bank(rng, TRAIN_WINDOWS * batch, cfg.model.seq_num,
                            points).reshape(TRAIN_WINDOWS, batch,
                                            cfg.model.seq_num, points, 4)
    shape = (TRAIN_WINDOWS, batch, points)
    w = {"xyzi": xyzi,
         "targets": rng.integers(0, 3, shape).astype(np.int32)}
    if stage2:
        w["bf_targets"] = rng.integers(0, 3, shape).astype(np.int32)
    return {k: torch.from_numpy(v).to(dev) for k, v in w.items()}


def tiny_cfg():
    """StreamMOS_tiny, dropout off, the learning rate at its peak."""
    cfg = get_config("StreamMOS_tiny")
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dropout_rate=0.0),
        optimize=dataclasses.replace(cfg.optimize, pct_start=0.0))


@pytest.mark.cuda
@pytest.mark.parametrize("stage2", [False, True], ids=["stage1", "stage2"])
def test_training_at_full_width(cuda, stage2):
    """bf16, batch 1, 130k points x T = 3 x 3 windows of streaming BPTT,
    SGD-Nesterov on the recipe's schedule, 7 steps: losses and gradient
    norm finite, no hand kernel launched; stage 1 moves every parameter,
    stage 2 (StreamMOS_seg, freeze_except="refine", bf_targets) only the
    refine head's, and every BN running statistic of the backbone."""
    cfg = get_config("StreamMOS_seg" if stage2 else "StreamMOS")
    model, state, step = train_setup(cfg, stage2, cuda, SEED)
    windows = train_windows(cfg, cuda, stage2, TRAIN_POINTS, SEED + 2)
    gen = torch.Generator().manual_seed(SEED)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    counts = profiling.counters()
    losses = []
    for _ in range(TRAIN_STEPS):
        state, metrics = step(state, windows, gen)
        losses.append(metrics["loss"])
    assert np.isfinite([float(x) for x in losses]).all()
    assert np.isfinite(float(metrics["grad_norm"]))
    assert state.step == TRAIN_STEPS
    assert _launched(counts) == {}
    after = model.state_dict()
    params = [n for n, _ in model.named_parameters()]
    changed = [n for n in params if not torch.equal(after[n], before[n])]
    if not stage2:
        assert changed == params
        return
    assert sorted(changed) == sorted(n for n in params
                                     if n.startswith("refine."))
    stats = [k for k in after if k.endswith(("running_mean", "running_var"))
             and not k.startswith("refine.")]
    assert stats and all(not torch.equal(after[k], before[k]) for k in stats)


# ---- the host side on a synthetic tree -----------------------------------

@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    """A synthetic SemanticKITTI tree (numpy, from the seed): sequences 08
    and 00 of 125k-point scans with a moving car, labels, poses, calib.
    Returns the directory the CLIs run in; the tree is its `sequences`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    work = tmp_path_factory.mktemp("kitti")
    make_sequence = _by_path("synthetic_kitti").make_sequence
    for i, (seq, n) in enumerate(DATA_FRAMES.items()):
        make_sequence(str(work / "sequences"), seq, n_frames=n,
                      n_points=RAW_POINTS, seed=SEED + i)
    return work


@pytest.mark.cuda
def test_datasets_at_full_size(cuda, kitti):
    """`EvalDataset` of sequence 08 at 160k points gives identical arrays
    on the native and the numpy path; `TrainDataset` (StreamMOS, 130k
    points) gives (3 windows, T, N, 4) samples inline and through
    `SampleWorkerPool` at the config's workers."""
    from streammos_tpu_torch.data.dataset import EvalDataset, TrainDataset
    from streammos_tpu_torch.data.loader import SampleWorkerPool

    seqs = str(kitti / "sequences")
    dcfg = dataclasses.replace(get_config("StreamMOS_seg").val, seq_dir=seqs,
                               frame_point_num=POINTS)
    native, plain = (EvalDataset(dcfg, seq_ids=[8], native=n)
                     for n in (True, False))
    assert len(native) == DATA_FRAMES["08"]
    for i in range(len(native)):
        a, b = native[i], plain[i]
        assert a.keys() == b.keys()
        for k in a:
            assert (np.array_equal(a[k], b[k])
                    if isinstance(a[k], np.ndarray) else a[k] == b[k]), k
    tcfg = dataclasses.replace(get_config("StreamMOS").train, seq_dir=seqs,
                               frame_point_num=TRAIN_POINTS)
    ds = TrainDataset(tcfg, seq_ids=[0], seed=SEED)
    want = (TRAIN_WINDOWS, 3, TRAIN_POINTS, 4)
    assert all(ds[i]["xyzi"].shape == want for i in range(len(ds)))
    with SampleWorkerPool(ds, tcfg.num_workers, seed=SEED) as pool:
        assert all(s["xyzi"].shape == want
                   for s in pool.map_ordered(list(range(len(ds))) * 2))


@pytest.fixture(scope="module")
def val_run(kitti):
    """The val CLI's function (`tools.val.run_eval`) in this process, as
    `python -m streammos_tpu_torch.tools.val --config StreamMOS_seg --tag
    smoke --data ... --points 160000` runs it over sequence 08 with weights
    drawn from the config's seed: its result, the hand kernels' launches,
    the step graphs captured, and the calls of `serve.eval_step` and of
    the stream loop."""
    from streammos_tpu_torch.tools import val as val_cli
    from streammos_tpu_torch.train import evaluate
    from streammos_tpu_torch.utils.logging import config_logger

    args = val_cli.parse_args(["--config", "StreamMOS_seg", "--tag", "smoke",
                               "--data", str(kitti / "sequences"),
                               "--points", str(POINTS)])
    cfg = val_cli.eval_config(args)
    calls = {"eval_step": 0, "stream_eval": 0}
    step, stream = serve.eval_step, evaluate.stream_eval

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    cwd = os.getcwd()
    os.chdir(kitti)
    serve.eval_step = counted("eval_step", step)
    evaluate.stream_eval = counted("stream_eval", stream)
    try:
        logger = config_logger(os.path.join("experiments", cfg.name, "smoke",
                                            "log_val.txt"))
        before = profiling.counters()
        result = val_cli.run_eval(cfg, args, True, logger)
        torch.cuda.synchronize()
        launched = _launched(before)
        captures = (profiling.counters().get("graph.captures", 0)
                    - before.get("graph.captures", 0))
    finally:
        serve.eval_step, evaluate.stream_eval = step, stream
        os.chdir(cwd)
    return dict(result=result, launched=launched, captures=captures,
                calls=calls)


@pytest.mark.cuda
def test_val_cli(cuda, kitti, val_run):
    """One `.label` a frame and scan point (values {0, 9, 251}; the refine
    head's {0, 1, 2}), one record line with a finite moving_iou, one step
    a frame; the header launches once a frame and once more for the eager
    warm-up before the one capture of the carried step's graphs, the folded
    gather and the folded scatter five times as often, the eval BN epilogue
    58 times as often, the other scatter kernels never."""
    frames = DATA_FRAMES["08"]
    exp = kitti / "experiments" / "StreamMOS_seg" / "smoke"
    for sub, allowed in (("val_results", {0, 9, 251}),
                         ("val_bf_results", {0, 1, 2})):
        d = exp / sub / "sequences" / "08" / "predictions"
        assert sorted(os.listdir(d)) == [f"{i:06d}.label"
                                         for i in range(frames)]
        for name in os.listdir(d):
            lab = np.fromfile(d / name, dtype=np.uint32)
            assert lab.shape == (RAW_POINTS,)
            assert set(np.unique(lab).tolist()) <= allowed
    record = (exp / "record_0.txt").read_text().strip().splitlines()
    assert len(record) == 1
    miou = float(record[0].split("moving_iou: ")[1].split(";")[0])
    assert np.isfinite(miou) and np.isfinite(val_run["result"]["moving_iou"])
    assert val_run["calls"] == {"eval_step": frames, "stream_eval": 1}
    assert val_run["captures"] == 1
    assert val_run["launched"] == {"kernel.fused_header.bf16": frames + 1,
                                   "kernel.grid_gather_tta":
                                   GATHER_SITES * (frames + 1),
                                   "kernel.scatter_tta":
                                   SCATTER_SITES * (frames + 1),
                                   "kernel.bn_act":
                                   BN_EPILOGUES * (frames + 1)}


@pytest.mark.cuda
def test_train_cli_resumes(cuda, kitti):
    """`python -m streammos_tpu_torch.tools.train` (StreamMOS, bs1, 130k
    points, 4 steps, one epoch, validation over sequence 08 after it): a
    checkpoint, finite losses, a `val/` scalar and the drop list; run
    again, it resumes from epoch 0 and takes no step."""
    cmd = [sys.executable, "-m", "streammos_tpu_torch.tools.train",
           "--config", "StreamMOS", "--tag", "smoke", "--data",
           str(kitti / "sequences"), "--batch-size", "1", "--points",
           str(TRAIN_POINTS), "--max-steps", str(CLI_STEPS), "--epochs", "1",
           "--start-val-epoch", "0"]
    exp = kitti / "experiments" / "StreamMOS" / "smoke"
    _run(cmd, kitti)
    first = (exp / "scalars.jsonl").read_text().splitlines()
    _run(cmd, kitti)
    assert (exp / "checkpoint" / "0000" / "state.pt").exists()
    scalars = [json.loads(line) for line in first]
    losses = [s["value"] for s in scalars if s["tag"] == "loss"]
    assert losses and np.isfinite(losses).all()
    assert any(s["tag"].startswith("val/") for s in scalars)
    drop = (exp / "train_split_dynamic_pointnumber.txt").read_text().split()
    assert len(drop) > 0 and len(drop) % 3 == 0
    assert (exp / "scalars.jsonl").read_text().splitlines() == first
    assert "resumed from epoch 0" in (exp / "log_train.txt").read_text()


VOTED = re.compile(r"seq 08: voted (\d+) frames in ([0-9.]+) s, the first "
                   r"after ([0-9.]+) s")


@pytest.mark.cuda
def test_voting_cli_numpy_against_the_device(cuda, kitti, val_run):
    """The voting CLI with --instance over the val CLI's labels of sequence
    08: the numpy backend as a subprocess (its pool spawned), the device
    backend in this process: refined files byte-equal, one a frame, the
    IoU lines equal, each run's timing line over every frame; no hand
    kernel launched."""
    from streammos_tpu_torch.tools import voting as voting_cli

    argv = ["--config", "StreamMOS_seg", "--tag", "smoke", "--data",
            str(kitti / "sequences"), "--instance"]
    refined = kitti / "experiments" / "StreamMOS_seg" / "smoke" / \
        "refine_val_results"
    by_numpy = refined.with_name(refined.name + "_numpy")
    printed = {"numpy": _run([sys.executable, "-m",
                              "streammos_tpu_torch.tools.voting", *argv,
                              "--vote", "numpy"], kitti)}
    os.rename(refined, by_numpy)
    out, cwd = io.StringIO(), os.getcwd()
    before = profiling.counters()
    os.chdir(kitti)
    try:
        with contextlib.redirect_stdout(out):
            voting_cli.main(argv + ["--vote", "device"])
    finally:
        os.chdir(cwd)
    assert _launched(before) == {}
    printed["device"] = out.getvalue()
    frames = DATA_FRAMES["08"]
    sub = os.path.join("sequences", "08", "predictions")
    names = sorted(os.listdir(refined / sub))
    assert names == [f"{i:06d}.label" for i in range(frames)]
    for name in names:
        assert ((refined / sub / name).read_bytes()
                == (by_numpy / sub / name).read_bytes()), name
    iou = {k: v.strip().splitlines()[-1] for k, v in printed.items()}
    assert iou["numpy"] == iou["device"] and "moving_iou: " in iou["numpy"]
    for v in printed.values():
        m = VOTED.search(v)
        assert m is not None and int(m.group(1)) == frames


@pytest.mark.cuda
def test_production_vote_numpy_against_the_device(cuda, tmp_path):
    """One production-size vote: 9 synthetic scans of 125k points
    (`tools/synthetic.py`), the history ego-aligned with the current scan
    as the CLI aligns it, predictions from the seed, and the current
    frame's first 60k points voted again for another class, so that many
    cells tie: numpy and CUDA equal bit for bit on every call; no hand
    kernel launched."""
    from streammos_tpu_torch import host_geometry
    from streammos_tpu_torch.postprocess.voting import (_linear_cells,
                                                        crop_mask, voxel_vote,
                                                        voxel_vote_device)
    from streammos_tpu_torch.tools.synthetic import make_big_sequence

    voxel = get_config("StreamMOS_seg").model.voxel
    make_big_sequence(str(tmp_path), "00", VOTE_SCANS, RAW_POINTS,
                      seed=SEED + 9)
    seq = str(tmp_path / "00")
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
    assert ((counts == top).sum(axis=1) >= 2)[top[:, 0] > 0].any()
    before = profiling.counters()
    for _ in range(1 + VOTE_REPS):
        assert np.array_equal(voxel_vote_device(*args, device="cuda"),
                              voxel_vote(*args))
    assert _launched(before) == {}


# ---- the dress rehearsal -------------------------------------------------

@pytest.mark.cuda
def test_dress_rehearsal(cuda, tmp_path):
    """`python -m streammos_tpu_torch.tools.dress_rehearsal` at a cut depth
    (stage 1, stage 2, val, voting, each the port's CLI on the card): its
    summary ok, one refined label file a val frame."""
    out = _run([sys.executable, "-m",
                "streammos_tpu_torch.tools.dress_rehearsal", *REHEARSAL,
                "--root", str(tmp_path)], tmp_path, timeout=900)
    summary = json.loads([line for line in out.splitlines()
                          if line.startswith("{")][-1])
    val_frames = int(REHEARSAL[REHEARSAL.index("--val-frames") + 1])
    assert summary.get("metric") == "dress_rehearsal"
    assert summary.get("ok") is True
    assert summary["refined_frames"] == val_frames
    assert len(os.listdir(summary["artifacts"]["refined_labels"])) == \
        val_frames


# ---- data-parallel -------------------------------------------------------

@pytest.mark.cuda
def test_data_parallel_world1_over_nccl(cuda):
    """Stage 1 at full width in a process group of one rank over NCCL, so
    every collective of the data-parallel step runs as an NCCL kernel: the
    first loss within 2e-2 of the step's without a process group, losses
    finite, no hand kernel launched; under the profiler, a step runs on the
    card and its collectives are NCCL's."""
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = get_config("StreamMOS")
    windows = train_windows(cfg, cuda, False, TRAIN_POINTS, SEED + 2)
    _, state, step = train_setup(cfg, False, cuda, SEED)
    alone = float(step(state, windows, torch.Generator().manual_seed(SEED))[1]
                  ["loss"])
    del state, step
    torch.cuda.set_device(cuda)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        assert parallel.active() and parallel.process_count() == 1
        _, state, step = train_setup(cfg, False, cuda, SEED)
        parallel.replicate_state(state)
        gen = torch.Generator().manual_seed(SEED)
        before = profiling.counters()
        losses = [float(step(state, windows, gen)[1]["loss"])
                  for _ in range(TRAIN_STEPS - 1)]
        launched = _launched(before)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(state, windows, gen)
            torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert np.isfinite(losses).all()
    assert abs(losses[0] - alone) < 2e-2 * abs(alone)
    assert launched == {}
    events = prof.key_averages()
    assert any(e.device_type == DeviceType.CUDA for e in events)
    calls = [e.key for e in events if e.key.startswith(("nccl:", "gloo:"))]
    assert calls and all(k.startswith("nccl:") for k in calls), calls


def dp_rank(addr: str, rank: int, out_dir: str) -> None:
    """One rank of `test_data_parallel_world2_over_gloo`, in its own
    process: StreamMOS_tiny float32, one step on this rank's row of a bs2
    batch; then StreamMOS bf16 at full width, bs1 a rank, DP_STEPS steps,
    rank 0's parameters broadcast and compared bit for bit after each."""
    import torch.distributed as dist

    from streammos_tpu_torch.tools.train import dropout_generator

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parallel.initialize_distributed(addr, DP_WORLD, rank, backend="gloo",
                                    device="cuda")
    dev = parallel.local_device("cuda")
    torch.cuda.set_device(dev)
    before = profiling.counters()
    cfg = tiny_cfg()
    model, state, step = train_setup(cfg, False, dev, SEED + 3)
    parallel.replicate_state(state)
    w = train_windows(cfg, dev, False, DP_TINY_POINTS, SEED + 4,
                      batch=DP_WORLD)
    state, metrics = step(state, {k: v[:, rank:rank + 1]
                                  for k, v in w.items()})
    res = {"tiny": {"loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "state": {k: v.cpu()
                              for k, v in model.state_dict().items()}}}
    cfg = get_config("StreamMOS")
    model, state, step = train_setup(cfg, False, dev, SEED)
    parallel.replicate_state(state)
    windows = train_windows(cfg, dev, False, TRAIN_POINTS, SEED + 2 + rank)
    gen = dropout_generator(SEED)  # as the train CLI seeds each rank
    res["losses"], res["bit_equal"] = [], []
    for _ in range(DP_STEPS):
        state, metrics = step(state, windows, gen)
        res["losses"].append(float(metrics["loss"]))
        mine = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        theirs = mine.clone()
        dist.broadcast(theirs, src=0)
        res["bit_equal"].append(bool(torch.equal(mine, theirs)))
    res["launched"] = _launched(before)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


DP_WORKER = r"""
import importlib.util, sys
spec = importlib.util.spec_from_file_location("card_paths", sys.argv[1])
paths = importlib.util.module_from_spec(spec)
spec.loader.exec_module(paths)
paths.dp_rank(sys.argv[2], int(sys.argv[3]), sys.argv[4])
"""


@pytest.mark.cuda
def test_data_parallel_world2_over_gloo(cuda, tmp_path):
    """Two ranks on the one card over gloo with CUDA tensors (NCCL refuses
    two ranks on one device). The tiny step equals the one-process step on
    the joined batch within the CPU tests' tolerances (loss 1e-5 and
    gradient norm 2e-4 relative, each update within 2e-3 of the step's
    largest update, BN statistics 1e-4), the ranks' states equal; at full
    width the ranks' parameters stay bit-equal after every step, the
    losses equal and finite; no hand kernel launched."""
    addr = f"localhost:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", DP_WORKER, os.path.abspath(__file__), addr,
         str(r), str(tmp_path)], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(DP_WORLD)]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, (out[-2000:], err[-4000:])
    res = [torch.load(tmp_path / f"rank{r}.pt", weights_only=True)
           for r in range(DP_WORLD)]

    cfg = tiny_cfg()
    model, state, step = train_setup(cfg, False, cuda, SEED + 3)
    before = {k: v.detach().cpu().clone()
              for k, v in model.state_dict().items()}
    state, metrics = step(state, train_windows(
        cfg, cuda, False, DP_TINY_POINTS, SEED + 4, batch=DP_WORLD))
    want = {k: v.cpu() for k, v in model.state_dict().items()}
    loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    got = res[0]["tiny"]
    for k, v in got["state"].items():
        assert torch.equal(v, res[1]["tiny"]["state"][k]), k
    assert abs(got["loss"] - loss) <= 1e-5 * abs(loss)
    assert abs(got["grad_norm"] - gnorm) <= 2e-4 * abs(gnorm)
    params = [n for n, _ in model.named_parameters()]
    scale = max(float((want[n] - before[n]).abs().max()) for n in params)
    for n in params:
        d_want = want[n] - before[n]
        err = (got["state"][n] - before[n] - d_want).abs()
        assert bool((err <= 2e-3 * (scale + d_want.abs())).all()), n
    for k in want:
        if k.endswith(("running_mean", "running_var")):
            err = (got["state"][k] - want[k]).abs()
            assert bool((err <= 1e-4 * (1 + want[k].abs())).all()), k
    assert all(all(r["bit_equal"]) for r in res), [r["bit_equal"]
                                                    for r in res]
    assert res[0]["losses"] == res[1]["losses"]
    assert np.isfinite(res[0]["losses"]).all()
    assert [r["launched"] for r in res] == [{}, {}]


# ---- the attention fusions -----------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["branch_att", "point_att"])
def test_fusion_unfolded_eval(cuda, mode):
    """The unfolded eval step (`make_eval_step`, one stream's TTA fan on
    the batch) of an attention fusion: StreamMOS_tiny float32 on the card
    against the CPU from the same weights over a fresh and a carried frame
    (2e-3 + 2e-3*|ref|); then StreamMOS_seg's width with the fusion, bf16,
    a frame of 160k points fresh and carried: scores (1, N, 3), finite,
    summing to 1 within 1e-2."""
    from streammos_tpu_torch.models.stream_mos import (featurize,
                                                       memory_shape,
                                                       tta_expand)

    tiny = get_config("StreamMOS_tiny")
    tiny = dataclasses.replace(tiny, model=dataclasses.replace(
        tiny.model, fusion_mode=mode))
    xyzi = torch.from_numpy(skewed_scan_bank(np.random.default_rng(SEED + 6),
                                             2, tiny.model.seq_num, 1024))
    steps, mems = {}, {}
    for d in ("cpu", cuda):
        model = tr.build_train_model(tiny, stage2=True, device=d,
                                     seed=SEED + 7).eval()
        steps[d] = tr.make_eval_step(model, tiny, with_refine=True)
        mems[d] = torch.zeros(memory_shape(tiny.model, 4), device=d)
    for i in range(2):
        res = {}
        for d in ("cpu", cuda):
            batch = featurize(tta_expand(xyzi[i].to(d)), tiny.model)
            s, bf, mems[d] = steps[d](batch, mems[d], i > 0)
            res[d] = (s.cpu(), bf.cpu(), mems[d].cpu())
        for a, b in zip(res["cpu"], res[cuda]):
            torch.testing.assert_close(b, a, rtol=2e-3, atol=2e-3)

    cfg = get_config("StreamMOS_seg")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, fusion_mode=mode))
    model = tr.build_train_model(cfg, stage2=True, device=cuda,
                                 seed=SEED).eval()
    step = tr.make_eval_step(model, cfg, with_refine=True)
    x = torch.from_numpy(skewed_scan_bank(np.random.default_rng(SEED + 8), 1,
                                          cfg.model.seq_num, POINTS)[0])
    batch = featurize(tta_expand(x.to(cuda)), cfg.model)
    mem = torch.zeros(memory_shape(cfg.model, 4), device=cuda)
    _, _, mem = step(batch, mem, False)
    for t in step(batch, mem, True)[:2]:
        assert t.shape == (1, POINTS, 3) and torch.isfinite(t).all()
        assert float((t.sum(-1) - 1).abs().max()) < 1e-2
