"""On the card: one short run of every cell prints the contract's result
line with `correct` true (run with ``python -m pytest --noconftest -m cuda
portbench/tests``; skips where there is no card)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from tinycells import ROOT
from portbench import manifest


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      manifest.load_manifest()["workloads"]])
def test_a_short_run_is_correct(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          workload, "--seed", str(2 ** 31 + 12345),
                          "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"], out.stderr[-3000:]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    cell = manifest.resolve(manifest.load_manifest(), workload)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
