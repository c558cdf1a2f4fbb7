"""BENCHMARK.json keeps the benchmark's contract, and the harness finds a
new configuration, traffic mix and per-layer metric from new files alone."""
from __future__ import annotations

import hashlib
import json
import shutil

import pytest

from tinycells import ROOT
from portbench import manifest


def test_manifest_keeps_the_contract():
    m = manifest.load_manifest()
    assert manifest.problems(m) == []
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["command"][1].startswith(m["paths"][0] + "/")
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      manifest.load_manifest()["workloads"]])
def test_every_cell_resolves_with_its_readers(workload):
    m = manifest.load_manifest()
    cell = manifest.resolve(m, workload)
    assert any(x["name"] == "setup_s" for x in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for metric in cell.end_to_end + cell.per_layer:
        assert callable(manifest.reader(metric["name"]))
    # every per-layer metric's end-to-end metric is reported in the cell
    names = {x["name"] for x in cell.end_to_end}
    assert all(p["moves"] in names for p in cell.per_layer)
    assert cell.limits and all(v > 0 for v in cell.limits.values())


@pytest.mark.parametrize("bad, problem", [
    (lambda m: m["end_to_end"][0].update(unit="ms per frame"), "bad unit"),
    (lambda m: m["workloads"][0].update(name="a b"), "bad name"),
    (lambda m: m["per_layer"][0].update(moves="nothing"), "moves unknown"),
    (lambda m: [w.update(chips=4) for w in m["workloads"][:2]], "chips"),
    (lambda m: m["end_to_end"][0].update(bound=0.3), "bound"),
    (lambda m: m["per_layer"][0].update(layer="Streaming Loop"), "one layer"),
])
def test_problems_are_found(bad, problem):
    m = manifest.load_manifest()
    bad(m)
    assert any(problem in p for p in manifest.problems(m))


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()}


def test_new_cell_and_metric_are_new_files_only(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    cell and a per-layer metric through new files and manifest entries,
    and resolves them with no file of the harness changed."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(root / "portbench")
    m = manifest.load_manifest()
    here = root / "portbench"
    conf = json.loads((ROOT / "portbench/configs/StreamMOS_seg.json").read_text())
    conf["name"] = "StreamMOS_seg.f32"
    conf["model"]["compute_dtype"] = "float32"
    (here / "configs/StreamMOS_seg.f32.json").write_text(json.dumps(conf))
    traffic = json.loads((here / "traffic/stream1.json").read_text())
    traffic["bank_frames"] = 16
    (here / "traffic/stream1_small_bank.json").write_text(json.dumps(traffic))
    (here / "limits/seg32_eval_1s.json").write_text('{"scores_max": 1e-3}')
    (here / "metrics/header_roofline.f32.py").write_text(
        "def read(run):\n    return 42.0\n")
    m["configs"].append({"name": "StreamMOS_seg.f32", "source": "x",
                         "file": "portbench/configs/StreamMOS_seg.f32.json",
                         "reduced": [], "why": "float32"})
    m["workloads"].append({"name": "seg32_eval_1s",
                           "config": "StreamMOS_seg.f32",
                           "traffic": "stream1_small_bank", "chips": 1,
                           "why": "float32 eval"})
    m["end_to_end"][0]["workloads"].append("seg32_eval_1s")
    m["per_layer"].append({"name": "header_roofline.f32", "unit": "%",
                           "better": "higher", "source": "device_trace",
                           "layer": "fused TTA header kernel",
                           "moves": "frame_ms",
                           "workloads": ["seg32_eval_1s"]})
    assert manifest.problems(m) == []
    cell = manifest.resolve(m, "seg32_eval_1s", root, here)
    assert cell.config["model"]["compute_dtype"] == "float32"
    assert cell.traffic["bank_frames"] == 16
    assert [p["name"] for p in cell.per_layer] == ["header_roofline.f32"]
    assert manifest.reader("header_roofline.f32", here)(None) == 42.0
    after = _digests(root / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before
