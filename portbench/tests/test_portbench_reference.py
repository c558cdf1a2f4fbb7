"""The plain reference agrees with the measured package's plain path (its
CPU path: no kernel) at StreamMOS_tiny in float32, fresh and carried, and
imports nothing it must not."""
from __future__ import annotations

import subprocess
import sys

import pytest
import torch

from tinycells import ROOT, tiny_cell
from portbench import guard, scans, sut, weights
from portbench.reference import streammos as ref

CPU = torch.device("cpu")


def _weights(cell):
    meta = ref.StreamMOS(cell.config["model"], cell.config["with_refine"])
    return weights.draw_weights(meta, 7, CPU)


def test_reference_keys_are_the_measured_models():
    cell = tiny_cell("stream", "float32")
    w = _weights(cell)
    model = sut.Port().eval_model(cell.config, w, CPU)
    keys = {k for k in model.state_dict() if "num_batches" not in k}
    assert keys == set(w)


@pytest.mark.parametrize("bt", [1, 2])
def test_eval_agrees_fresh_and_carried(bt):
    cell = tiny_cell("stream", "float32")
    w = _weights(cell)
    port = sut.Port()
    model = port.eval_model(cell.config, w, CPU)
    plain = sut.reference_model(cell.config, w, CPU)
    bank = scans.scan_bank(torch.Generator().manual_seed(3), 6, 3, 1024, CPU)
    memory = port.initial_memory(model, bt)
    for i in range(3):
        x = bank[i * bt:(i + 1) * bt]
        got = port.eval_step(model, x, memory, i > 0)
        want = ref.eval_frame(plain, x, memory, i > 0)
        for g, r in zip(got, want):
            assert (g - r).abs().max() < 5e-5
        memory = got[2]


def test_import_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded(["streammos_tpu_torch", "streammos_tpu_torch.ops",
                                   "jaxtyping", "numpy"]) == []
    assert guard.forbidden_loaded(["streammos_tpu.ops", "jax.numpy", "flax",
                                   "jaxlib"]) == ["flax", "jax.numpy", "jaxlib",
                                                  "streammos_tpu.ops"]
    assert guard.reference_violations() == []


def test_reference_and_harness_load_no_jax_and_the_reference_no_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.streammos, portbench.check; "
            "from portbench import guard; "
            "print(guard.forbidden_loaded(), "
            "[m for m in sys.modules if m.split('.')[0] == 'streammos_tpu_torch'])"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] []"


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "seg_eval_1s", "--seed", "3", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=120, cwd=ROOT, env={"CUDA_VISIBLE_DEVICES": "",
                                                     "PATH": "/usr/bin:/bin"})
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
