"""`BENCHMARK.json` and the files it names, found by name.

A cell (an entry of ``workloads``) is one configuration under one traffic
mix. Everything that belongs to one of them sits in a file of its own:

  configs/<config>.json     the configuration as it is run (its `file` in
                            the manifest), naming its plain reference
  traffic/<traffic>.json    the traffic mix: parameters that the general
                            loop its ``loop`` names reads
  modes/<loop>.py           that loop's mode: how the system builds what it
                            runs, the loop, what it records, the compared
                            numbers (`modes/__init__.py`)
  limits/<workload>.json    the limits of the output comparison
  metrics/<metric>.py       one reader a metric: ``read(rec) -> float or
                            None`` (None: nothing to read in this run)

so a later cell, traffic mix, kind of cell or metric is added as new files
alone.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]   # the manifest entries this cell reports
    per_layer: List[Dict]


def load_manifest(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(manifest: Dict, workload: str, root: Path = ROOT,
            here: Path = HERE) -> Cell:
    """The cell named `workload`, with its files read."""
    entry = next((w for w in manifest["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in manifest['workloads']]}")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    return Cell(
        name=workload, chips=entry["chips"],
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((here / "traffic" / f"{entry['traffic']}.json"
                            ).read_text()),
        limits=json.loads((here / "limits" / f"{workload}.json").read_text()),
        end_to_end=[m for m in manifest["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in manifest["per_layer"] if _reports(m, workload)])


def reader(metric: str, here: Path = HERE) -> Callable:
    """The `read` function of ``metrics/<metric>.py``."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def problems(manifest: Dict) -> List[str]:
    """What in the manifest breaks the benchmark's contract (empty: none)."""
    out: List[str] = []
    names = lambda xs: [x["name"] for x in xs]
    cells = names(manifest["workloads"])
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    everything = (names(manifest["configs"]) + cells
                  + names(manifest["end_to_end"]) + names(manifest["per_layer"]))
    for n in everything:
        if not NAME.match(n):
            out.append(f"bad name {n!r}")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        ns = names(manifest[group])
        if len(ns) != len(set(ns)):
            out.append(f"duplicate names in {group}")
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    if len(set(names(metrics))) != len(metrics):
        out.append("an end-to-end and a per-layer metric share a name")
    for m in metrics:
        if not UNIT.match(m["unit"]):
            out.append(f"bad unit {m['unit']!r} of {m['name']}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"bad 'better' of {m['name']}")
        if m["source"] not in SOURCES:
            out.append(f"bad source of {m['name']}")
        if "workloads" in m and not m["workloads"]:
            out.append(f"{m['name']} lists no cell under 'workloads'")
        for w in m.get("workloads", []):
            if w not in cells:
                out.append(f"{m['name']} lists unknown cell {w}")
    for m in manifest["end_to_end"]:
        if m["source"] not in ("host_clock", "device_trace"):
            out.append(f"end-to-end {m['name']} from {m['source']}")
        if not 0.01 <= m["bound"] <= 0.25:
            out.append(f"bound of {m['name']} outside [0.01, 0.25]")
    if "setup_s" not in e2e:
        out.append("no setup_s")
    layers = {}
    for m in manifest["per_layer"]:
        if m["moves"] not in e2e:
            out.append(f"{m['name']} moves unknown {m['moves']}")
            continue
        for w in m.get("workloads", cells):
            if not _reports(e2e[m["moves"]], w):
                out.append(f"{m['name']} in {w}, which lacks {m['moves']}")
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    for spellings in layers.values():
        if len(spellings) > 1:
            out.append(f"one layer spelt {sorted(spellings)}")
    for w in manifest["workloads"]:
        for key in ("config", "traffic"):
            if not NAME.match(w[key]):
                out.append(f"bad {key} of {w['name']}")
        if w["chips"] not in (1, 4):
            out.append(f"{w['name']} asks for {w['chips']} chips")
        if not 1 <= len(w["why"]) <= 200:
            out.append(f"why of {w['name']} has {len(w['why'])} characters")
        reported = [m for m in manifest["end_to_end"] if _reports(m, w["name"])]
        if len(reported) < 2:
            out.append(f"{w['name']} reports no end-to-end metric but setup_s")
        if not any(_reports(m, w["name"]) for m in manifest["per_layer"]):
            out.append(f"{w['name']} reports no per-layer metric")
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    if len(pairs) != len(set(pairs)):
        out.append("a pair of configuration and traffic appears twice")
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    if four > max(1, len(cells) // 4):
        out.append(f"{four} cells ask for 4 chips")
    used = {w["config"] for w in manifest["workloads"]}
    for c in manifest["configs"]:
        if c["name"] not in used:
            out.append(f"config {c['name']} is in no cell")
        if not c["file"].startswith(tuple(p + "/" for p in manifest["paths"])):
            out.append(f"config file {c['file']} outside paths")
        if len(c["reduced"]) > 16 or not all(NAME.match(k) for k in c["reduced"]):
            out.append(f"bad reduced of {c['name']}")
    if not 1 <= manifest["run_seconds"] <= 51:
        out.append("run_seconds outside 1..51")
    if len(json.dumps(manifest)) > 64 * 1024:
        out.append("manifest over 64 KiB")
    return out
