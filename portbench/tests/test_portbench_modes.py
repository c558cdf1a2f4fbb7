"""Cells by mode: the traffic file's `loop` names the mode file
(`modes/<loop>.py`), and a new kind of cell (its mode, configuration,
traffic, limits and metrics) runs from new files and manifest entries
alone."""
from __future__ import annotations

import json
import shutil

import pytest
import torch

from test_portbench_manifest import _digests
from tinycells import ROOT
from portbench import faults, manifest, modes, run, sut, train_faults

TOY = '''"""Loop ``toy``: row sums of a seeded matrix, checked in float64."""
import time

import torch

from portbench import loops

FAULTS = {}


def run(system, cell, w_seed, t_seed, seconds, trace, device):
    gen = torch.Generator().manual_seed(t_seed)
    x = torch.randn(cell.traffic["rows"], 4, generator=gen)
    rec = loops.Record("toy")
    rec.window_t0 = time.perf_counter()
    sums = []
    while not sums or time.perf_counter() - rec.window_t0 < seconds:
        sums.append(x.sum(1) + cell.traffic.get("bias", 0.0))
        rec.steps += 1
    rec.window_s = time.perf_counter() - rec.window_t0

    def compare():
        want = x.double().sum(1)
        err = max(float((s - want).abs().max()) for s in sums)
        return {"sum_err": err, "finite": 1.0}, len(sums)
    return rec, compare
'''


def test_loops_find_their_modes():
    assert modes.load("stream").FAULTS is faults.FAULTS
    assert modes.load("batched").FAULTS is faults.FAULTS
    assert modes.load("train").FAULTS is train_faults.FAULTS
    with pytest.raises(KeyError):
        modes.load("no_such_loop")


@pytest.mark.parametrize("bias, correct", [(0.0, True), (0.5, False)])
def test_new_mode_is_new_files_only(tmp_path, bias, correct):
    """A copy of the benchmark gains a mode, a configuration, a traffic
    mix, limits, an end-to-end and a per-layer metric as new files and
    manifest entries, and runs the new cell through `run.run_cell` with no
    file of the harness changed."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(root / "portbench")
    here = root / "portbench"
    (here / "modes/toy.py").write_text(TOY)
    (here / "configs/toy.json").write_text(json.dumps({"name": "toy"}))
    (here / "traffic/toy8.json").write_text(json.dumps(
        {"loop": "toy", "rows": 8, "bias": bias}))
    (here / "limits/toy_sums.json").write_text('{"sum_err": 1e-5}')
    (here / "metrics/sum_s.py").write_text(
        "def read(run):\n    return run.rec.window_s / run.rec.steps\n")
    (here / "metrics/sums.toy.py").write_text(
        "def read(run):\n    return float(run.rec.steps)\n")
    m = manifest.load_manifest()
    m["configs"].append({"name": "toy", "source": "x",
                         "file": "portbench/configs/toy.json", "reduced": [],
                         "why": "a toy"})
    m["workloads"].append({"name": "toy_sums", "config": "toy",
                           "traffic": "toy8", "chips": 1, "why": "a toy"})
    m["end_to_end"].append({"name": "sum_s", "unit": "s", "better": "lower",
                            "bound": 0.25, "source": "host_clock",
                            "workloads": ["toy_sums"]})
    m["per_layer"].append({"name": "sums.toy", "unit": "sums",
                           "better": "higher", "source": "program_counter",
                           "layer": "toy loop", "moves": "sum_s",
                           "workloads": ["toy_sums"]})
    assert manifest.problems(m) == []
    cell = manifest.resolve(m, "toy_sums", root, here)
    result, numbers, failed = run.run_cell(cell, 3, 0.05, False,
                                           torch.device("cpu"), sut.Port(),
                                           here=here)
    assert result.rec.kind == "toy" and result.rec.steps >= 1
    assert (numbers["sum_err"] < 1e-5) is correct
    assert failed == (0 if correct else result.rec.steps)
    read = {x["name"]: manifest.reader(x["name"], here)(result)
            for x in cell.end_to_end + cell.per_layer}
    assert read["sums.toy"] == result.rec.steps
    assert read["sum_s"] > 0 and read["setup_s"] >= 0
    after = _digests(root / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before
