"""StreamMOS stage-1 training as the benchmark's `mos_train_s1` cell runs it,
on the CPU at StreamMOS_tiny's widths.

* One train step marks its phases with spans (`utils/profiling.span`):
  ``smt.train.step`` around S x (``smt.train.window`` around
  ``smt.train.loss``), then ``smt.train.backward`` and
  ``smt.train.optimizer``; and counts one ``train.steps``.
* A whole run of the cell in bfloat16 (`portbench`'s train mode, the plain
  float32 training reference as the judge) is correct under limits of its
  own size, `TINY_BF16_LIMITS`: the card cell's limits are fitted at the
  published widths, where bfloat16's round-off lands elsewhere.
* On a card a train step counts the bytes it holds for its backward
  (``train.saved_bytes``), which the benchmark's `saved_gib.train` reads.
* The benchmark's manifest, with the cell and its metrics, keeps its
  contract.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from streammos_tpu_torch.config import get_config
from streammos_tpu_torch.train import optim, trainer
from streammos_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "portbench" / "tests"))

from portbench import check, loops, manifest, sut  # noqa: E402
from portbench.run import Run  # noqa: E402
from portbench.run import run_cell  # noqa: E402
from tinycells import tiny_train_cell  # noqa: E402

CELL = "mos_train_s1"
S = 3
# The tiny cell in bfloat16 on the CPU, each limit between the port's
# largest reading over 9 seeds and the smallest of the float8 control
# (2 seeds) or of the fault it is there for (2 seeds each): port / upper.
TINY_BF16_LIMITS = {
    "chain_logits_rel": 0.15,     # 0.070 / control 0.345
    "logits_rel": 0.12,           # 0.037 / control 0.363
    "chain_row_grad_max": 0.1,    # 0.011 / half batch 1.04
    "row_grad_max": 0.1,          # 0.009 / half batch 1.06
    "chain_update_rel": 0.45,     # 0.301 / control 0.578, no momentum 0.628
    "update_rel": 0.3,            # 0.187 / control 0.435, no momentum 0.631
    "update_leaf_max": 0.45,      # 0.203 / no momentum 0.634, control 0.887
    "chain_bn_stats_rel": 0.016,  # 0.0090 / control 0.0257
    "bn_stats_rel": 0.01,         # 0.0036 / control 0.0266
}


def _scans(rng: np.random.RandomState, shape):
    """(..., 4) xyzi, range-skewed, inside the tiny configuration's crop
    and a little beyond (`tests/test_torch_common.py:lidar_points`, here
    without the JAX package, so the card's test runs where it is absent)."""
    az = rng.uniform(-np.pi, np.pi, shape)
    r = np.minimum(1.0 + rng.exponential(12.0, shape), 45.0 * 1.4)
    z = rng.uniform(-3.9, 1.9, shape)
    i = rng.uniform(0, 1, shape)
    return np.stack([r * np.cos(az), r * np.sin(az), z, i],
                    axis=-1).astype(np.float32)


def _windows(seed: int, batch: int = 2, n: int = 256):
    rng = np.random.RandomState(seed)
    return {"xyzi": torch.from_numpy(_scans(rng, (S, batch, 3, n))),
            "targets": torch.from_numpy(
                rng.randint(0, 3, (S, batch, n)).astype(np.int32))}


def _tiny_step(device):
    cfg = get_config("StreamMOS_tiny")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="bfloat16"))
    model = trainer.build_train_model(cfg, device=device, seed=3)
    tx, _ = optim.build_optimizer(cfg.optimize, 100)
    state = trainer.create_train_state(model, tx)
    return state, trainer.make_train_step(model, cfg, tx)


def test_train_step_spans_and_counter():
    state, step = _tiny_step("cpu")
    events = []

    class Mark:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            events.append(("enter", self.name))

        def __exit__(self, *exc):
            events.append(("exit", self.name))

    before = profiling.counters().get("train.steps", 0)
    with profiling.spans_to(Mark):
        step(state, _windows(11), torch.Generator().manual_seed(0))
    assert profiling.counters()["train.steps"] == before + 1

    train = [(k, n) for k, n in events if n.startswith("smt.train.")]
    window = [("enter", "smt.train.window"), ("enter", "smt.train.loss"),
              ("exit", "smt.train.loss"), ("exit", "smt.train.window")]
    assert train == ([("enter", "smt.train.step")] + S * window + [
        ("enter", "smt.train.backward"), ("exit", "smt.train.backward"),
        ("enter", "smt.train.optimizer"), ("exit", "smt.train.optimizer"),
        ("exit", "smt.train.step")])
    # the forward's own spans open and close inside a window, outside the
    # loss
    depth = {}
    for kind, name in events:
        depth[name] = depth.get(name, 0) + (1 if kind == "enter" else -1)
        if not name.startswith("smt.train."):
            assert depth.get("smt.train.window") == 1, name
            assert depth.get("smt.train.loss", 0) == 0, name
    assert any(not n.startswith("smt.train.") for _, n in events)


def test_tiny_bf16_train_cell_is_correct_under_the_cells_limits():
    limits = TINY_BF16_LIMITS
    cell = dataclasses.replace(tiny_train_cell("bfloat16"),
                               limits=dict(limits))
    run, numbers, failed = run_cell(cell, 5, 0.3, False,
                                    torch.device("cpu"), sut.Port())
    assert run.rec.kind == "train" and run.rec.steps >= 1
    assert numbers["steps_checked"] == 3
    assert check.verdict(numbers, limits), numbers
    assert failed == 0


def test_manifest_with_the_train_cell_keeps_its_contract():
    m = manifest.load_manifest()
    assert manifest.problems(m) == []
    cell = manifest.resolve(m, CELL)
    assert cell.chips == 1
    assert cell.config["port_config"] == "StreamMOS"
    assert cell.traffic["loop"] == "train"
    assert {e["name"] for e in cell.end_to_end} == {
        "peak_mem_gib", "setup_s"}
    assert {e["name"] for e in cell.per_layer} == {"saved_gib.train"}


def _train_run():
    return Run(tiny_train_cell(), loops.Record("train"), 0.0)


def test_saved_gib_reads_the_held_bytes_a_step(monkeypatch):
    read = manifest.reader("saved_gib.train")
    monkeypatch.setattr(profiling, "_COUNTS", {
        "train.steps": 4, "train.saved_bytes": 4 * 3 * 2 ** 30})
    assert read(_train_run()) == 3.0
    # an eval run has no train step
    evaluated = Run(tiny_train_cell(), loops.Record("eval"), 0.0)
    assert read(evaluated) is None
    # off a card, or in a program without the counter: nothing to read
    monkeypatch.setattr(profiling, "_COUNTS", {"train.steps": 4})
    assert read(_train_run()) is None
    monkeypatch.setattr(profiling, "_COUNTS", {})
    assert read(_train_run()) is None


def test_a_train_step_off_a_card_counts_no_held_bytes():
    state, step = _tiny_step("cpu")
    before = profiling.counters().get("train.saved_bytes")
    step(state, _windows(12), torch.Generator().manual_seed(0))
    assert profiling.counters().get("train.saved_bytes") == before


@pytest.mark.cuda
def test_a_train_step_on_a_card_counts_the_bytes_it_holds():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the allocator's counts)")
    device = torch.device("cuda", 0)
    state, step = _tiny_step(device)
    windows = {k: v.to(device) for k, v in _windows(13).items()}
    held = []
    for _ in range(3):
        before = profiling.counters().get("train.saved_bytes", 0)
        step(state, windows, torch.Generator().manual_seed(0))
        held.append(profiling.counters()["train.saved_bytes"] - before)
    # the first step also builds the step's constants and keeps them;
    # after it, a step's own bytes, not a running total: the same within
    # what OHEM's share of kept points moves as the weights move
    assert held[0] >= held[1] > 0, held
    assert abs(held[2] - held[1]) < 0.1 * held[1], held
