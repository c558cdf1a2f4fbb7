"""StreamMOS stage-1 training data-parallel, as the benchmark's
`mos_train_s1_dp4` cell runs it, on the CPU at StreamMOS_tiny's widths in
float32: two ranks over gloo, one row each.

* The cell's mode (`portbench/modes/train_dp.py`: rank 0 here, rank 1 a
  process it starts) is correct under the tiny train cell's limits
  against the plain reference on the joined batch; with the BN sums or the
  gradient all-reduce left out in both ranks (`bn_local`, `grads_local`)
  it is not.
* A step issues the collectives the model derives: each BN layer's sums
  all-reduced forward and backward in each window (the BN of the
  featurized points forward only: no gradient reaches them), each of the four
  losses' logits gathered (and their cotangents all-reduced back) and
  targets gathered, and one all-reduce a gradient bucket; the counters
  `dp.collectives` and `dp.bytes` read exactly that.
* The plain reference computed a window at a time equals its plain step.
* The exchanges are spans ``smt.dp.*`` inside the train step's phases.
* The benchmark's manifest, with the cell and its metrics, keeps its
  contract.
"""
import contextlib
import dataclasses
import socket
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from streammos_tpu_torch import parallel
from streammos_tpu_torch.config import get_config
from streammos_tpu_torch.nn.blocks import BN
from streammos_tpu_torch.train import optim, trainer
from streammos_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "portbench" / "tests"))

from portbench import check, guard, loops, manifest, modes, sut  # noqa: E402
from portbench import tracing  # noqa: E402
from portbench import weights as wts  # noqa: E402
from portbench.reference import streammos as ref  # noqa: E402
from portbench.reference import streammos_train as rt  # noqa: E402
from portbench.reference import streammos_train_global as rg  # noqa: E402
from portbench.run import Run, run_cell  # noqa: E402
from tinycells import tiny_train_cell  # noqa: E402

CELL = "mos_train_s1_dp4"
WORLD = 2
SEED = 7
CPU = torch.device("cpu")


@pytest.fixture
def few_threads(monkeypatch):
    """Two threads a process, the started rank's too: the suite runs under
    xdist with several workers."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def tiny_dp_cell():
    cell = tiny_train_cell("float32")
    return dataclasses.replace(cell, name="tiny_dp", traffic=dict(
        cell.traffic, loop="train_dp", world=WORLD, batch=1))


def _run(fault=None):
    cell = tiny_dp_cell()
    mode = modes.load("train_dp")
    with mode.FAULTS[fault]() if fault else contextlib.nullcontext():
        run, numbers, failed = run_cell(cell, SEED, 0.3, False, CPU,
                                        sut.Port())
    assert not dist.is_initialized()
    assert run.rec.kind == "train" and run.rec.steps >= 1
    return cell, run, numbers, failed


@pytest.fixture(scope="module")
def port_run():
    monkey = pytest.MonkeyPatch()
    monkey.setenv("OMP_NUM_THREADS", "2")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield _run()
    finally:
        torch.set_num_threads(threads)
        monkey.undo()


def test_train_dp_mode_is_correct_at_world_2(port_run):
    cell, run, numbers, failed = port_run
    assert check.verdict(numbers, cell.limits), numbers
    assert failed == 0
    assert numbers["finite"] == 1.0
    assert numbers["steps_checked"] == 3
    assert run.rec.world == WORLD


@pytest.mark.parametrize("fault", ["bn_local", "grads_local"])
def test_planted_exchange_fault_is_not_correct(fault, few_threads):
    cell, run, numbers, failed = _run(fault)
    assert not check.verdict(numbers, cell.limits), numbers
    assert failed > 0


def test_the_mode_plants_the_exchange_faults():
    assert set(modes.load("train_dp").FAULTS) == {
        "bn_local", "grads_local", "loss_local"}


def _derived(cell):
    """(collectives, payload bytes) of one step of rank 0 at world W, from
    the model and the traffic: the BN layers' sums forward and backward in
    each window (but the input BN's backward); per window the point
    head's and the three aux heads' logits gathered (each rank's rows) and
    their cotangents all-reduced back (the whole gathered batch), and
    their targets gathered; one all-reduce of each gradient bucket."""
    from streammos_tpu_torch.models.stream_mos import StreamMOSNet

    cfg = sut.port_config(cell.config).model
    model = StreamMOSNet(cfg, with_refine=False)
    t = cell.traffic
    S, B, N, C = t["windows"], t["batch"], t["points"], cfg.class_num
    bns = [m for m in model.modules() if isinstance(m, BN)]
    # the BN of the featurized points: no gradient reaches its input, so
    # its sums' all-reduce has no backward
    first = model.point_pre.layer[0].layer[0]
    hw = (cfg.voxel.bev_wl[0] // 2) * (cfg.voxel.bev_wl[1] // 2)
    n = (2 * len(bns) - 1) * S + S * 4 * 3
    nbytes = S * sum((2 * m.num_features + 1) * 4 * (1 if m is first else 2)
                     for m in bns)
    for elements in [N] + 3 * [hw]:  # logits float32, targets int32
        nbytes += S * (B * elements * C * 4 + WORLD * B * elements * C * 4
                       + B * elements * 4)
    params = sum(p.numel() for p in model.parameters()) * 4
    buckets = -(-params // parallel.BUCKET_BYTES)
    return n + buckets, nbytes + params


def test_a_step_issues_the_collectives_the_model_derives(port_run):
    cell, run, _, _ = port_run
    start, end = run.rec.counts
    steps = run.rec.steps
    collectives, nbytes = _derived(cell)
    assert manifest.reader("collectives.dp")(run) == collectives
    got = {k: (end[k] - start.get(k, 0)) / steps
           for k in ("dp.collectives", "dp.bytes")}
    assert got == {"dp.collectives": collectives, "dp.bytes": nbytes}


def _masks(seed):
    """A dropout mask provider: the same keep mask for the same window, site
    and call, whatever order it is asked in."""
    drawn = {}

    def mask(i, site, call, shape):
        key = (i, site, call)
        if key not in drawn:
            gen = torch.Generator().manual_seed(
                seed + 1000 * i + 10 * call + rt.SITES.index(site))
            drawn[key] = torch.rand(shape, generator=gen) < 0.8
        return drawn[key]
    return mask


def test_blocked_global_reference_equals_the_plain_step(few_threads):
    cell = tiny_train_cell("float32")
    t = dict(cell.traffic, batch=4, bank_samples=1)
    cell = dataclasses.replace(cell, traffic=t)
    meta = ref.StreamMOS(cell.config["model"], False).to("meta")
    weights = wts.draw_weights(meta, 11, CPU)
    xyzi, labels = modes.load("train").draw_bank(cell, 12, CPU)
    opt = cell.config["optimize"]
    plain = rt.Trainer(rt.train_model(cell.config, weights, CPU), opt,
                       t["epoch_steps"])
    blocked = rg.Trainer(rg.train_model(cell.config, weights, CPU), opt,
                         t["epoch_steps"])
    for step in range(2):
        seen = {}
        losses = [tr.step(xyzi[0], labels[0], _masks(step),
                          lambda i, out, tr=tr: seen.setdefault(
                              (id(tr), i), out["pred"].detach()))
                  for tr in (plain, blocked)]
        assert torch.allclose(losses[0], losses[1], rtol=1e-6, atol=0)
        for i in range(t["windows"]):
            assert torch.allclose(seen[(id(plain), i)],
                                  seen[(id(blocked), i)], rtol=0, atol=1e-5)
        for name, p in plain.params.items():
            q = blocked.params[name]
            assert torch.allclose(p.grad, q.grad, rtol=1e-4,
                                  atol=1e-4 * float(p.grad.abs().max())
                                  + 1e-12), name
            assert torch.allclose(p, q, rtol=1e-5, atol=1e-6), name
        stats = rt.bn_buffers(blocked.model)
        for name, b in rt.bn_buffers(plain.model).items():
            assert torch.allclose(b, stats[name], rtol=1e-5, atol=1e-6), name
        assert blocked.count == plain.count == step + 1


def _free_address() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def test_a_missing_rank_ends_the_rendezvous_within_its_timeout():
    """`initialize_distributed(timeout=...)`: a rank whose peer never comes
    raises after the timeout (torch's defaults wait 10 to 30 minutes)."""
    t0 = time.perf_counter()
    with pytest.raises(dist.DistError):
        parallel.initialize_distributed(_free_address(), 2, 0, device="cpu",
                                        timeout=2)
    assert time.perf_counter() - t0 < 30
    assert not parallel.active()


def test_exchanges_are_spans_inside_the_train_step(few_threads):
    """A process group of one rank over gloo runs every exchange: the
    set-up broadcast in ``smt.dp.replicate``, the BN sums (forward and
    backward) in ``smt.dp.bn`` inside the windows and the backward, the
    losses' gathers in ``smt.dp.gather`` inside ``smt.train.loss`` and the
    backward, the gradient buckets in ``smt.dp.grads`` between the
    backward and the optimizer; each counted."""
    cfg = get_config("StreamMOS_tiny")
    dist.init_process_group("gloo", init_method=f"tcp://{_free_address()}",
                            world_size=1, rank=0)
    try:
        model = trainer.build_train_model(cfg, device="cpu", seed=3)
        tx, _ = optim.build_optimizer(cfg.optimize, 100)
        state = trainer.create_train_state(model, tx)
        step = trainer.make_train_step(model, cfg, tx)
        rng = np.random.RandomState(0)
        xyzi = rng.uniform(-30, 30, (2, 1, 3, 256, 4)).astype(np.float32)
        windows = {"xyzi": torch.from_numpy(xyzi), "targets": torch.from_numpy(
            rng.randint(0, 3, (2, 1, 256)).astype(np.int32))}
        stack, seen = [], []

        class Mark:
            def __init__(self, name):
                self.name = name

            def __enter__(self):
                seen.append((self.name, tuple(stack)))
                stack.append(self.name)

            def __exit__(self, *exc):
                stack.pop()

        before = profiling.counters()
        with profiling.spans_to(Mark):
            parallel.replicate_state(state)
            step(state, windows, torch.Generator().manual_seed(0))
        after = profiling.counters()
    finally:
        dist.destroy_process_group()
    dp = [(n, s) for n, s in seen if n.startswith("smt.dp.")]
    assert {n for n, _ in dp} == {"smt.dp.replicate", "smt.dp.bn",
                                  "smt.dp.gather", "smt.dp.grads"}
    for name, outer in dp:
        if name == "smt.dp.replicate":
            assert outer == ()
        elif name == "smt.dp.grads":
            assert outer == ("smt.train.step",)
        elif name == "smt.dp.gather":
            assert outer[-1] in ("smt.train.loss", "smt.train.backward"), outer
        else:
            assert "smt.train.window" in outer or \
                outer[-1] == "smt.train.backward", outer
    # two windows, each BN forward and backward but the input BN's backward
    assert sum(n == "smt.dp.bn" for n, _ in dp) == 2 * (2 * sum(
        isinstance(m, BN) for m in model.modules()) - 1)
    # one collective a span, but the one broadcast a tensor of the state
    broadcasts = len(state.model.state_dict()) + sum(
        len(v) for v in state.opt_state.values() if isinstance(v, dict))
    assert after["dp.collectives"] - before.get("dp.collectives", 0) == (
        len(dp) - 1 + broadcasts)


def test_dp_readers_read_the_program():
    run = Run(tiny_dp_cell(), loops.Record("train"), 0.0)
    # the counters at the window's start and end, over its steps
    run.rec.steps = 4
    run.rec.counts = ({"dp.collectives": 100}, {"dp.collectives": 500})
    assert manifest.reader("collectives.dp")(run) == 100
    run.rec.counts = ({}, {})  # a program without the counter
    assert manifest.reader("collectives.dp")(run) is None
    # NCCL's kernels in the traced window, ms a step
    run.rec.world = 4
    run.rec.trace = tracing.Summary((0.0, 1e6), [
        (0.0, 2000.0, "ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)"),
        (10.0, 20.0, "void at::native::elementwise_kernel"),
        (3000.0, 5000.0, "ncclKernel_AllGather_RING_LL_Sum_int8_t")])
    assert manifest.reader("collective_ms.dp")(run) == 1.0
    run.rec.world = 1
    assert manifest.reader("collective_ms.dp")(run) is None


def test_loss_gib_reads_the_loss_bytes_a_step(monkeypatch):
    read = manifest.reader("loss_gib.dp")
    run = Run(tiny_dp_cell(), loops.Record("train"), 0.0)
    monkeypatch.setattr(profiling, "_COUNTS", {
        "train.steps": 4, "train.loss_bytes": 4 * 2 ** 29})
    assert read(run) == 0.5
    monkeypatch.setattr(profiling, "_COUNTS", {"train.steps": 4})
    assert read(run) is None
    assert read(Run(tiny_dp_cell(), loops.Record("eval"), 0.0)) is None


def test_a_train_step_off_a_card_counts_no_loss_bytes():
    cfg = get_config("StreamMOS_tiny")
    model = trainer.build_train_model(cfg, device="cpu", seed=3)
    tx, _ = optim.build_optimizer(cfg.optimize, 100)
    step = trainer.make_train_step(model, cfg, tx)
    rng = np.random.RandomState(1)
    windows = {"xyzi": torch.from_numpy(rng.uniform(
        -30, 30, (2, 1, 3, 128, 4)).astype(np.float32)),
        "targets": torch.from_numpy(rng.randint(0, 3, (2, 1, 128)).astype(
            np.int32))}
    before = profiling.counters().get("train.loss_bytes")
    step(trainer.create_train_state(model, tx), windows,
         torch.Generator().manual_seed(0))
    assert profiling.counters().get("train.loss_bytes") == before


def test_manifest_with_the_dp_cell_keeps_its_contract():
    m = manifest.load_manifest()
    assert manifest.problems(m) == []
    cell = manifest.resolve(m, CELL)
    assert cell.chips == 4
    assert cell.config["port_config"] == "StreamMOS"
    t = cell.traffic
    assert t["loop"] == "train_dp" and t["world"] * t["batch"] == 12
    assert {e["name"] for e in cell.end_to_end} == {"peak_mem_gib", "setup_s"}
    assert {e["name"] for e in cell.per_layer} == {"loss_gib.dp"}
    assert set(cell.limits) == set(manifest.resolve(m, "mos_train_s1").limits)
    # readers that wait for `step_s` to be an entry
    entries = {e["name"] for e in m["end_to_end"] + m["per_layer"]}
    for name in ("collective_ms.dp", "collectives.dp"):
        assert name not in entries
        assert callable(manifest.reader(name))
    assert guard.reference_violations() == []
