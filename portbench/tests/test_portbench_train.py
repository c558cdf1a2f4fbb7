"""A whole train run but the look for a card, at tiny widths in float32
(the measured package's bfloat16 training has a known fault, PERF.md §7),
with the limits proposed for the stage-1 cell: the measured package comes
out correct; the control (the plain training reference in its place, in
float8) and every planted training fault come out not correct."""
from __future__ import annotations

import pytest
import torch

from tinycells import tiny_train_cell
from portbench import check, loops, manifest, modes, sut, train_faults
from portbench.reference import streammos as ref
from portbench.run import Run, run_cell

CPU = torch.device("cpu")


def _run(system, seed=5):
    cell = tiny_train_cell()
    run, numbers, failed = run_cell(cell, seed, 0.3, False, CPU, system)
    assert run.rec.kind == "train" and run.rec.steps >= 1
    return check.verdict(numbers, cell.limits), numbers, failed


def test_program_is_correct():
    ok, numbers, failed = _run(sut.Port())
    assert ok, numbers
    assert failed == 0
    assert numbers["steps_checked"] == 3
    assert numbers["finite"] == 1.0


def test_control_in_float8_is_not_correct():
    ok, numbers, failed = _run(sut.Reference(ref.FP8()))
    assert not ok, numbers
    assert failed > 0


@pytest.mark.parametrize("fault", sorted(train_faults.FAULTS))
def test_planted_fault_is_not_correct(fault):
    with train_faults.FAULTS[fault]():
        ok, numbers, failed = _run(sut.Port())
    assert not ok, numbers


def test_the_train_mode_plants_the_train_faults():
    assert modes.load("train").FAULTS is train_faults.FAULTS


TRAIN_METRICS = [
    ("end_to_end", {"name": "step_s", "unit": "s", "better": "lower",
                    "bound": 0.25, "source": "host_clock"}),
    ("per_layer", {"name": "launches.train", "unit": "launches/step",
                   "better": "lower", "source": "device_trace",
                   "layer": "train loop", "moves": "step_s"}),
    ("per_layer", {"name": "idle_share.train", "unit": "%",
                   "better": "lower", "source": "device_trace",
                   "layer": "device", "moves": "step_s"}),
    ("per_layer", {"name": "mfu.train", "unit": "%", "better": "higher",
                   "source": "host_clock", "layer": "model step",
                   "moves": "step_s"}),
]


def _with_train_metrics(cells):
    """The manifest with a stage-1 train cell and the train metrics as
    entries, each listing `cells`."""
    m = manifest.load_manifest()
    m["configs"].append({"name": "StreamMOS", "source": "x",
                         "file": "portbench/configs/StreamMOS.json",
                         "reduced": [], "why": "stage 1"})
    m["workloads"].append({"name": "mos_train_s1", "config": "StreamMOS",
                           "traffic": "train_s1", "chips": 1,
                           "why": "stage-1 training"})
    for group, entry in TRAIN_METRICS:
        m[group].append(dict(entry, workloads=list(cells)))
    return m


def test_train_metrics_join_as_entries_with_their_cell():
    assert manifest.problems(_with_train_metrics(["mos_train_s1"])) == []
    problems = manifest.problems(_with_train_metrics([]))
    for _, entry in TRAIN_METRICS:
        assert f"{entry['name']} lists no cell under 'workloads'" in problems


def test_train_metric_readers_read_a_train_run():
    cell = tiny_train_cell()
    run, _, _ = run_cell(cell, 7, 0.3, False, CPU, sut.Port())
    step_s = manifest.reader("step_s")(run)
    assert step_s == pytest.approx(run.rec.window_s / run.rec.steps)
    # untraced: the trace's readers find nothing to read
    for name in ("launches.train", "idle_share.train", "mfu.train"):
        assert manifest.reader(name)(run) is None
    # an eval run has no train step
    evaluated = Run(run.cell, loops.Record("eval"), 0.0)
    for _, entry in TRAIN_METRICS:
        assert manifest.reader(entry["name"])(evaluated) is None
