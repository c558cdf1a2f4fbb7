"""The port's offline tools against the JAX package's on the same trees and
weights: the voting CLI (numpy and torch-on-the-CPU backends, against JAX's
`tools/voting.py`), the object-bank extractor, the drop-list writer, the
reference-checkpoint import (through the val CLI), and the rehearsal's
data writers. Exact: the same bytes on disk."""
import contextlib
import filecmp
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.synthetic_kitti import make_sequence
from tests.test_torch_common import (jax_tiny_model, tiny_cfgs,
                                     use_few_threads, without_refine)

use_few_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_VOTING = [sys.executable, "-m", "streammos_tpu_torch.tools.voting"]
JAX_TOOLS = os.path.join(REPO, "tools")


def _run(cmd, cwd):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2",
               JAX_PLATFORMS="cpu")
    res = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"cmd failed: {' '.join(cmd)}\nstdout:"
                             f"{res.stdout[-3000:]}\nstderr:{res.stderr[-3000:]}")
    return res.stdout


# --------------------------------------------------------------- voting CLI

def _write_predictions(exp, data, seq, seed):
    """Prediction and bf files in the val CLI's layout: the ground truth
    with a fifth of the points flipped, the moving car called movable."""
    from streammos_tpu_torch.data import semantic_kitti as sk

    rng = np.random.default_rng(seed)
    inv = sk.label_lut(sk.LEARNING_MAP_INV)
    pred_dir = os.path.join(exp, "val_results", "sequences", seq, "predictions")
    bf_dir = os.path.join(exp, "val_bf_results", "sequences", seq,
                          "predictions")
    os.makedirs(pred_dir)
    os.makedirs(bf_dir)
    for name in sorted(os.listdir(os.path.join(data, seq, "labels"))):
        raw = np.fromfile(os.path.join(data, seq, "labels", name), np.uint32)
        gt = sk.relabel((raw & 0xFFFF).astype(np.int64), sk.LEARNING_MAP)
        flip = rng.random(gt.size) < 0.2
        pred = np.where(flip, rng.integers(0, 3, gt.size), gt)
        inv[pred].astype(np.uint32).tofile(os.path.join(pred_dir, name))
        bf = np.where(gt == 2, 2, rng.integers(0, 2, gt.size))
        bf.astype(np.uint32).tofile(os.path.join(bf_dir, name))


@pytest.fixture(scope="module")
def voted(tmp_path_factory):
    """One tree, three working dirs with the same predictions: the port's
    CLI with each backend and JAX's CLI, all with --instance."""
    root = tmp_path_factory.mktemp("voting")
    data = str(root / "sequences")
    make_sequence(data, "08", n_frames=10, n_points=2600, seed=3)
    runs = {"numpy": PORT_VOTING + ["--vote", "numpy"],
            "device": PORT_VOTING + ["--vote", "device", "--device", "cpu"],
            "jax": [sys.executable, os.path.join(JAX_TOOLS, "voting.py"),
                    "--vote", "numpy"]}
    out = {}
    for name, cmd in runs.items():
        cwd = root / name
        exp = cwd / "experiments" / "StreamMOS_tiny" / "t"
        _write_predictions(str(exp), data, "08", seed=5)
        stdout = _run(cmd + ["--config", "StreamMOS_tiny", "--tag", "t",
                             "--data", data, "--instance", "--workers", "2"],
                      str(cwd))
        out[name] = (exp / "refine_val_results" / "sequences" / "08" /
                     "predictions", stdout)
    return out


@pytest.mark.parametrize("backend", ["numpy", "device"])
def test_voting_cli_writes_jax_files(voted, backend):
    got_dir, got_out = voted[backend]
    want_dir, want_out = voted["jax"]
    names = sorted(os.listdir(want_dir))
    assert names == [f"{i:06d}.label" for i in range(10)]
    assert sorted(os.listdir(got_dir)) == names
    match, mismatch, errors = filecmp.cmpfiles(want_dir, got_dir, names,
                                               shallow=False)
    assert mismatch == [] and errors == [] and match == names
    iou = got_out.strip().splitlines()[-1]
    assert iou == want_out.strip().splitlines()[-1]
    assert iou.startswith("static_iou: ") and "moving_iou: " in iou


def test_voting_cli_refines_something(voted):
    """The vote changed labels (the check above is not of a no-op)."""
    got_dir, _ = voted["numpy"]
    exp = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(got_dir))))
    pred_dir = os.path.join(exp, "val_results", "sequences", "08",
                            "predictions")
    changed = sum(not filecmp.cmp(os.path.join(pred_dir, n),
                                  os.path.join(got_dir, n), shallow=False)
                  for n in os.listdir(pred_dir))
    assert changed == 10


def test_voting_cli_helpers():
    from streammos_tpu_torch.tools import voting as cli

    assert cli.split_sequences("val") == ["08"]
    assert cli.split_sequences("test") == [
        "11", "12", "13", "14", "15", "16", "17", "18", "19", "20", "21"]
    assert cli.resolve_vote_backend("numpy") is False
    assert cli.resolve_vote_backend("device") is True


def test_voting_auto_rule():
    """'auto' follows the measurement on the H100 written in
    `resolve_vote_backend`'s docstring."""
    from streammos_tpu_torch.tools import voting as cli

    assert cli.resolve_vote_backend("auto") is True


def test_voting_device_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device works")
    from streammos_tpu_torch.tools import voting as cli

    for vote in ("device", "auto"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["--config", "StreamMOS_tiny", "--data", str(tmp_path),
                      "--vote", vote])


def test_voting_one_frame_sequence(tmp_path):
    """A one-frame sequence votes on the current frame alone, as JAX's
    `process_frame` does."""
    sys.path.insert(0, JAX_TOOLS)
    try:
        import voting as jax_cli
    finally:
        sys.path.remove(JAX_TOOLS)
    from streammos_tpu.config import VoxelConfig as JaxVoxelConfig
    from streammos_tpu_torch.config import VoxelConfig
    from streammos_tpu_torch.tools import voting as cli

    data = str(tmp_path / "sequences")
    make_sequence(data, "08", n_frames=1, n_points=2600, seed=4)
    _write_predictions(str(tmp_path), data, "08", seed=6)
    vel = os.path.join(data, "08", "velodyne")
    preds = str(tmp_path / "val_results" / "sequences" / "08" / "predictions")
    bf = str(tmp_path / "val_bf_results" / "sequences" / "08" / "predictions")
    grid = (64, 64, 30)
    for device in (None, "cpu"):
        out = str(tmp_path / f"port_{device}")
        assert cli.process_frame((vel, preds, bf, out, ["000000"], 0,
                                  [np.eye(4)], VoxelConfig(bev_shape=grid),
                                  True, device)) == "000000"
    jax_cli.process_frame((vel, preds, bf, str(tmp_path / "jax"), ["000000"],
                           0, [np.eye(4)], JaxVoxelConfig(bev_shape=grid),
                           True, False))
    want = str(tmp_path / "jax" / "000000.label")
    for device in (None, "cpu"):
        assert filecmp.cmp(str(tmp_path / f"port_{device}" / "000000.label"),
                           want, shallow=False)


# ------------------------------------------- extract_objects, make_drop_list

@pytest.fixture(scope="module")
def train_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_tree")
    data = str(root / "sequences")
    make_sequence(data, "00", n_frames=6, n_points=2600, seed=0)
    make_sequence(data, "03", n_frames=3, n_points=2600, seed=1)
    make_sequence(data, "08", n_frames=3, n_points=2600, seed=2)
    return root, data


def test_extract_objects_writes_jax_banks(train_tree):
    from streammos_tpu_torch.data.copy_paste import SequenceCutPaste
    from streammos_tpu_torch.tools import extract_objects

    root, data = train_tree
    extract_objects.main(["--data", data, "--out", str(root / "bank_port"),
                          "--stride", "2"])
    _run([sys.executable, os.path.join(JAX_TOOLS, "extract_objects.py"),
          "--data", data, "--out", str(root / "bank_jax"), "--stride", "2"],
         str(root))
    files = sorted(os.path.relpath(os.path.join(d, f), root / "bank_jax")
                   for d, _, fs in os.walk(root / "bank_jax") for f in fs)
    assert files == ["car/00_000000_0.npz", "car/00_000002_0.npz",
                     "car/00_000004_0.npz", "car/03_000000_0.npz",
                     "car/03_000002_0.npz"]
    for rel in files:
        got = np.load(root / "bank_port" / rel)
        want = np.load(root / "bank_jax" / rel)
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    cp = SequenceCutPaste(str(root / "bank_port"))
    assert [os.path.basename(f) for f in cp.bank["car"]] == [
        os.path.basename(f) for f in files]


def test_make_drop_list_writes_jax_file(train_tree):
    from streammos_tpu_torch.tools import make_drop_list

    root, data = train_tree
    make_drop_list.main(["--data", data, "--out", str(root / "drop_port.txt"),
                         "--min-dynamic", "250"])
    _run([sys.executable, os.path.join(JAX_TOOLS, "make_drop_list.py"),
          "--data", data, "--out", str(root / "drop_jax.txt"),
          "--min-dynamic", "250"], str(root))
    text = (root / "drop_port.txt").read_text()
    assert text == (root / "drop_jax.txt").read_text()
    assert len(text.splitlines()) == 9  # train sequences only


# ------------------------------------------------------------ port_weights

def _reference_pth(path, stage2: bool, wrap: bool):
    """JAX's inverse port of the tiny model, saved as the reference's
    trainer saves it under DataParallel: ``module.`` keys, the BN step
    counters and a dead module's key, optionally in a ``state_dict``
    wrapper."""
    from streammos_tpu.train.port_torch import flax_to_torch_state_dict

    variables = jax_tiny_model()[1]
    if not stage2:
        variables = without_refine(variables)
    jcfg, _ = tiny_cfgs()
    sd = {f"module.{k}": torch.from_numpy(v) for k, v in
          flax_to_torch_state_dict(variables, jcfg, stage2).items()}
    sd["module.point_pre.layer.0.layer.0.num_batches_tracked"] = torch.tensor(7)
    sd["module.bev_net.header_bev.0.up1.weight"] = torch.zeros(3)
    torch.save({"state_dict": sd, "epoch": 3} if wrap else sd, path)
    return variables


@pytest.fixture(scope="module")
def ported(tmp_path_factory):
    """Both stages' reference files through the port's CLI and JAX's."""
    from streammos_tpu_torch.tools import port_weights

    root = tmp_path_factory.mktemp("port_weights")
    runs = {}
    for stage2 in (False, True):
        tag = "s2" if stage2 else "s1"
        pth = str(root / f"{tag}.pth")
        variables = _reference_pth(pth, stage2, wrap=stage2)
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            port_path = port_weights.main(
                ["--pth", pth, "--out", str(root / tag / "port"), "--epoch",
                 "3", "--config", "StreamMOS_tiny"])
        jax_out = _run([sys.executable,
                        os.path.join(JAX_TOOLS, "port_weights.py"), "--pth",
                        pth, "--out", str(root / tag / "jax"), "--epoch", "3",
                        "--config", "StreamMOS_tiny"], str(root))
        runs[stage2] = (variables, port_path, root / tag,
                        printed.getvalue().strip(),
                        jax_out.strip().splitlines()[-1])
    return runs


@pytest.mark.parametrize("stage2", [False, True])
def test_port_weights_equals_jax_import(ported, stage2):
    """The port's `state.pt` equals JAX's imported variables carried
    across by `from_flax_variables`; the summary line is JAX's."""
    from streammos_tpu.train import checkpoint as jax_ckpt
    from streammos_tpu_torch.train.checkpoint import load_model_state
    from streammos_tpu_torch.weights import from_flax_variables

    variables, port_path, tag_dir, port_line, jax_line = ported[stage2]
    assert port_line == f"{jax_line.split(' at ')[0]} at {port_path}"
    assert f"(refine={stage2})" in port_line
    state = load_model_state(str(tag_dir / "port"), 3)
    restored = jax_ckpt.restore(str(tag_dir / "jax"), 3, variables)
    want = from_flax_variables(restored, tiny_cfgs()[1], stage2)
    live = {k: v for k, v in state.items()
            if not k.endswith("num_batches_tracked")}
    assert sorted(live) == sorted(want)
    for k, v in want.items():
        assert torch.equal(live[k], v), k
    assert any(k.startswith("refine.") for k in live) == stage2


@pytest.mark.parametrize("stage2", [False, True])
def test_ported_checkpoint_through_val_cli(ported, stage2, tmp_path,
                                           monkeypatch):
    """The val CLI (`--device cpu`) loads the ported checkpoint and writes
    the labels of the same weights loaded in memory."""
    import dataclasses

    from streammos_tpu_torch import config as config_lib
    from streammos_tpu_torch import serve
    from streammos_tpu_torch.tools import val as val_cli
    from streammos_tpu_torch.train.evaluate import stream_eval
    from streammos_tpu_torch.utils.logging import config_logger
    from streammos_tpu_torch.weights import from_flax_variables

    variables, _, tag_dir, _, _ = ported[stage2]
    base = config_lib.get_config("StreamMOS_tiny")
    name = "StreamMOS_tiny"
    if stage2:
        name = "StreamMOS_seg_tiny"
        monkeypatch.setitem(config_lib._REGISTRY, name,
                            lambda: dataclasses.replace(
                                base, name=name,
                                val=dataclasses.replace(base.val,
                                                        with_bf_labels=True),
                                freeze_except="refine"))
    data = str(tmp_path / "sequences")
    make_sequence(data, "08", n_frames=4, n_points=2600, seed=7)
    monkeypatch.chdir(tmp_path)
    args = val_cli.parse_args(["--config", name, "--tag", "ported", "--data",
                               data, "--points", "4096", "--checkpoint",
                               str(tag_dir / "port"), "--epoch", "3",
                               "--device", "cpu"])
    cfg = val_cli.eval_config(args)
    exp = tmp_path / "experiments" / name / "ported"
    logger = config_logger(str(exp / "log_val.txt"))
    val_cli.run_eval(cfg, args, stage2, logger)
    assert "loaded checkpoint epoch 3" in (exp / "log_val.txt").read_text()

    model = serve.build_model(cfg, with_refine=stage2, device="cpu",
                              state_dict=from_flax_variables(
                                  variables, cfg.model, stage2))
    stream_eval(cfg, cfg.val, model, with_refine=stage2, with_labels=True,
                logger=logger, save_root=str(tmp_path / "mem"),
                bf_root=str(tmp_path / "mem_bf") if stage2 else None)
    pairs = [(exp / "val_results" / "sequences", tmp_path / "mem")]
    if stage2:
        pairs.append((exp / "val_bf_results" / "sequences",
                      tmp_path / "mem_bf"))
    for cli_root, mem_root in pairs:
        d = os.path.join("08", "predictions")
        names = sorted(os.listdir(cli_root / d))
        assert names == [f"{i:06d}.label" for i in range(4)]
        assert filecmp.cmpfiles(cli_root / d, mem_root / d, names,
                                shallow=False)[0] == names


def test_port_weights_refuses_other_files(tmp_path):
    from streammos_tpu_torch.tools import port_weights

    torch.save([torch.zeros(3)], tmp_path / "list.pth")
    with pytest.raises(SystemExit, match="expected a state_dict"):
        port_weights.main(["--pth", str(tmp_path / "list.pth"), "--out",
                           str(tmp_path / "out"), "--config", "StreamMOS_tiny"])
    torch.save({"not.a.key": torch.zeros(3)}, tmp_path / "keys.pth")
    with pytest.raises(SystemExit, match="structure mismatch"):
        port_weights.main(["--pth", str(tmp_path / "keys.pth"), "--out",
                           str(tmp_path / "out"), "--config", "StreamMOS_tiny"])
    assert not (tmp_path / "out").exists()


# --------------------------------------------------------- rehearsal data

def test_rehearsal_data_loads(tmp_path):
    """`tools/synthetic.py` writes JAX's `make_big_sequence` files byte for
    byte, and its tree and bank feed the port's datasets and copy-paste."""
    import dataclasses
    import importlib.util

    from streammos_tpu_torch.config import get_config
    from streammos_tpu_torch.data.copy_paste import SequenceCutPaste
    from streammos_tpu_torch.data.dataset import EvalDataset, TrainDataset
    from streammos_tpu_torch.tools.synthetic import make_bank, make_big_sequence

    spec = importlib.util.spec_from_file_location(
        "bench_pipeline", os.path.join(JAX_TOOLS, "bench_pipeline.py"))
    bench_pipeline = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench_pipeline)

    data = str(tmp_path / "sequences")
    make_big_sequence(data, "00", n_frames=10, n_points=3000)
    make_big_sequence(data, "08", n_frames=4, n_points=3000, seed=1)
    bench_pipeline.make_big_sequence(str(tmp_path / "jax"), "08", n_frames=4,
                                     n_points=3000, seed=1)
    for sub in ("velodyne", "labels", "."):
        d = os.path.join("08", sub)
        names = sorted(f for f in os.listdir(os.path.join(data, d))
                       if os.path.isfile(os.path.join(data, d, f)))
        assert filecmp.cmpfiles(os.path.join(data, d),
                                str(tmp_path / "jax" / d), names,
                                shallow=False)[0] == names
    cfg = get_config("StreamMOS")
    bank = str(tmp_path / cfg.train.copy_paste.obj_bank_dir)
    make_bank(bank, np.random.default_rng(0))
    cp = SequenceCutPaste(bank, cfg.train.copy_paste.paste_max_obj_num)
    assert len(cp.bank["car"]) == 8

    ev = EvalDataset(dataclasses.replace(cfg.val, seq_dir=data,
                                         frame_point_num=4096),
                     split="valid", with_labels=True)
    assert len(ev) == 4 and ev[0]["xyzi"].shape == (3, 4096, 4)
    tr = TrainDataset(dataclasses.replace(cfg.train, seq_dir=data,
                                          frame_point_num=4096),
                      copy_paste=cp, seed=0, seq_ids=[0])
    sample = tr[0]
    assert sample["xyzi"].shape == (3, 3, 4096, 4)
    assert np.isfinite(sample["xyzi"]).all()
