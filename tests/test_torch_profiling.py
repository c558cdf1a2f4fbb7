"""`utils/profiling.py` on the CPU: `trace` writes a Chrome trace of the
block into its directory, `chained_time` and `measure_rtt` return positive
seconds, and `chained_time` chains the step K times a run."""
import json
import os

import torch

from streammos_tpu_torch.utils import profiling


def test_trace_writes_a_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)) as prof:
        x = torch.randn(64, 64)
        (x @ x).sum().item()
    files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    events = json.loads((log_dir / files[0]).read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
    assert any("matmul" in e.key for e in prof.key_averages())


def test_chained_time_on_the_cpu():
    calls = []

    def step(c):
        calls.append(1)
        return torch.tanh(c @ c)

    t = profiling.chained_time(step, torch.eye(32) * 0.5, K=3, reps=2)
    assert t > 0
    assert len(calls) == 3 * (1 + 2)  # one untimed run, then reps runs


def test_measure_rtt_on_the_cpu():
    assert profiling.measure_rtt(reps=3, device="cpu") > 0
