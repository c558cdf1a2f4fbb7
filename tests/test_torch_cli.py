"""The port's CLIs end to end on the CPU, on a synthetic SemanticKITTI tree,
as a user runs them (`python -m streammos_tpu_torch.tools.{train,val}
--device cpu`) at StreamMOS_tiny with 4096 points: train with in-train
validation, checkpoint, drop list and resume; then val with its `.label`
files and record; stage 2 grafted from stage 1's checkpoint; and, on a
machine without CUDA, both CLIs without ``--device`` exit non-zero with the
CUDA message."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.synthetic_kitti import make_sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = [sys.executable, "-m", "streammos_tpu_torch.tools.train"]
VAL = [sys.executable, "-m", "streammos_tpu_torch.tools.val"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    data = root / "sequences"
    make_sequence(str(data), "00", n_frames=8, n_points=2600)
    make_sequence(str(data), "08", n_frames=4, n_points=2600)
    return root


def _run(cmd, cwd, ok=True):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    res = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=600)
    if ok and res.returncode != 0:
        raise AssertionError(
            f"cmd failed: {' '.join(cmd)}\nstdout:{res.stdout[-3000:]}\n"
            f"stderr:{res.stderr[-3000:]}")
    return res


def _scalars(exp):
    return [json.loads(line) for line in
            (exp / "scalars.jsonl").read_text().strip().splitlines()]


@pytest.fixture(scope="module")
def trained(workdir):
    """One epoch of stage 1 (2 steps) with validation after it, then the
    same command again, which resumes and takes no step."""
    cmd = TRAIN + ["--config", "StreamMOS_tiny", "--tag", "cli", "--data",
                   str(workdir / "sequences"), "--epochs", "1", "--points",
                   "4096", "--max-steps", "2", "--start-val-epoch", "0",
                   "--device", "cpu"]
    first = _run(cmd, str(workdir))
    exp = workdir / "experiments" / "StreamMOS_tiny" / "cli"
    scalars_after_first = _scalars(exp)
    second = _run(cmd, str(workdir))
    return exp, first, second, scalars_after_first


def test_train_cli_checkpoint_log_and_drop_list(trained):
    exp, first, _, scalars = trained
    assert (exp / "checkpoint" / "0000" / "state.pt").exists()
    losses = [s["value"] for s in scalars if s["tag"] == "loss"]
    assert losses and all(np.isfinite(losses))
    assert {s["tag"] for s in scalars} >= {"loss", "lr", "val/moving_iou"}
    record = (exp / "record_0.txt").read_text().splitlines()
    assert record[0].startswith("Epoch 0; ") and "moving_iou" in record[0]
    drop = (exp / "train_split_dynamic_pointnumber.txt").read_text().split()
    assert len(drop) == 3 * 8  # every frame of 00 has a moving car
    log = (exp / "log_train.txt").read_text()
    assert "epoch 0: 2 steps in" in log and "s/step" in log
    assert "evaluated 4 frames" in log


def test_train_cli_resumes(trained):
    exp, _, second, scalars = trained
    log = (exp / "log_train.txt").read_text()
    assert "resumed from epoch 0" in log
    assert _scalars(exp) == scalars  # no step taken, nothing validated
    assert sorted(os.listdir(exp / "checkpoint")) == ["0000"]


def test_val_cli_writes_labels_and_record(trained, workdir):
    exp = trained[0]
    _run(VAL + ["--config", "StreamMOS_tiny", "--tag", "cli", "--data",
                str(workdir / "sequences"), "--points", "4096",
                "--device", "cpu"], str(workdir))
    pred_dir = exp / "val_results" / "sequences" / "08" / "predictions"
    preds = sorted(os.listdir(pred_dir))
    assert preds == [f"{i:06d}.label" for i in range(4)]
    for name in preds:
        lab = np.fromfile(pred_dir / name, dtype=np.uint32)
        assert lab.shape == (2600,)
        assert set(np.unique(lab)) <= {0, 9, 251}
    record = (exp / "record_0.txt").read_text().splitlines()
    assert len(record) == 2 and record[1].startswith("Epoch 0; ")
    assert "loaded checkpoint epoch 0" in (exp / "log_val.txt").read_text()
    assert not (exp / "val_bf_results").exists()  # stage 1: no refine head


def test_stage2_grafts_stage1(trained, workdir, monkeypatch):
    """Stage 2 from stage 1's checkpoint, in process: a tiny stage-2
    config (refine head on, only it trained), one step, then the val CLI's
    function writes label and bf-label files."""
    import torch

    from streammos_tpu_torch import config as config_lib
    from streammos_tpu_torch.tools import train as train_cli
    from streammos_tpu_torch.tools import val as val_cli
    from streammos_tpu_torch.train import checkpoint
    from streammos_tpu_torch.utils.logging import config_logger

    torch.set_num_threads(2)
    base = config_lib.get_config("StreamMOS_tiny")
    seg = config_lib.get_config("StreamMOS_seg")
    monkeypatch.setitem(config_lib._REGISTRY, "StreamMOS_seg_tiny",
                        lambda: dataclasses.replace(
                            base, name="StreamMOS_seg_tiny",
                            train=dataclasses.replace(base.train,
                                                      with_bf_labels=True,
                                                      num_workers=0),
                            val=dataclasses.replace(base.val,
                                                    with_bf_labels=True),
                            model=dataclasses.replace(base.model,
                                                      name="stream_mos_seg"),
                            optimize=seg.optimize,
                            freeze_except="refine"))
    monkeypatch.chdir(workdir)
    stage1 = str(trained[0] / "checkpoint")
    data = str(workdir / "sequences")
    train_cli.main(["--config", "StreamMOS_seg_tiny", "--tag", "s2",
                    "--data", data, "--checkpoint", stage1, "--ckpt-epoch",
                    "0", "--epochs", "1", "--points", "4096",
                    "--max-steps", "1", "--no-val", "--device", "cpu"])
    exp = workdir / "experiments" / "StreamMOS_seg_tiny" / "s2"
    assert "grafted stage-1 checkpoint epoch 0" in \
        (exp / "log_train.txt").read_text()
    s1 = checkpoint.load_model_state(stage1, 0)
    s2 = checkpoint.load_model_state(str(exp / "checkpoint"), 0)
    params = [k for k in s2 if not k.endswith(("running_mean", "running_var",
                                               "num_batches_tracked"))]
    assert any(k.startswith("refine.") for k in params)
    for k in params:  # frozen: bit-identical to stage 1; refine: trained
        if not k.startswith("refine."):
            assert torch.equal(s2[k], s1[k]), k

    args = val_cli.parse_args(["--config", "StreamMOS_seg_tiny", "--tag", "s2",
                               "--data", data, "--points", "4096",
                               "--device", "cpu"])
    cfg = val_cli.eval_config(args)
    result = val_cli.run_eval(cfg, args, True,
                              config_logger(str(exp / "log_val.txt")))
    assert np.isfinite(result["moving_iou"])
    for sub in ("val_results", "val_bf_results"):
        d = exp / sub / "sequences" / "08" / "predictions"
        assert len(os.listdir(d)) == 4
    bf = np.fromfile(exp / "val_bf_results" / "sequences" / "08" /
                     "predictions" / "000000.label", dtype=np.uint32)
    assert set(np.unique(bf)) <= {0, 1, 2}


@pytest.mark.parametrize("cli", ["train", "val"])
def test_cli_without_device_needs_cuda(workdir, cli):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device works")
    res = _run((TRAIN if cli == "train" else VAL)
               + ["--config", "StreamMOS_tiny", "--tag", "nodev", "--data",
                  str(workdir / "sequences"), "--points", "4096"],
               str(workdir), ok=False)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert not (workdir / "experiments" / "StreamMOS_tiny" / "nodev").exists()
