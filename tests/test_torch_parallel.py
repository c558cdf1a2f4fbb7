"""Data-parallel training of the port over `torch.distributed` on the CPU:
two spawned processes on gloo, each holding one row of the global batch.

* One stage-1 step of StreamMOS_tiny (float32, dropout off, bs1 a rank)
  equals JAX's one-device step on the joined bs2 batch (compiled with
  fusion off, `compile_unfused`) and the port's one-process step on it:
  loss rtol 1e-5, gradient norm rtol 2e-4, each update within 2e-3 of the
  step's largest update (the train-step tolerance of
  `tests/test_torch_train_step.py`), BN running statistics rtol = atol =
  1e-4; the two ranks' parameters bit-equal after it, and rank 1's
  perturbed weights replaced by rank 0's before it (`replicate_state`);
  with `remat` (each window's collectives run again in the backward) the
  step is bit-equal to the plain one.
* A loss case built so that each rank's OHEM top-k set differs from the
  global one: for `loss_mode` ohem, wce and ce, the loss over the global
  batch and each rank's gradient equal the joined batch's (rtol 1e-5);
  for ohem the mean of the per-rank losses misses it by far more.
* The shards of an epoch are disjoint and cover the padded epoch; the
  ranks' dropout masks differ, rank 0's seed is the one-process seed.
* The train CLI as two processes (`--device cpu`, synthetic tree, two
  steps): only rank 0 writes the checkpoint and validates, and
  `record_0.txt` is the only record. The val CLI of rank R evaluates
  `--epoch` + R.
"""
import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streammos_tpu.config import get_config as jax_get_config
from streammos_tpu.models.stream_mos import StreamMOSNet as JaxStreamMOSNet
from streammos_tpu.train import build_optimizer as jax_build_optimizer
from streammos_tpu.train import create_train_state as jax_create_train_state
from streammos_tpu.train import make_train_step as jax_make_train_step

from streammos_tpu_torch import parallel
from streammos_tpu_torch.config import get_config
from streammos_tpu_torch.losses import cross_entropy_per_element
from streammos_tpu_torch.models.stream_mos import refine_loss
from streammos_tpu_torch.weights import from_flax_variables
from tests.synthetic_kitti import make_sequence
from tests.test_torch_common import (compile_unfused, jax_tiny_model,
                                     jnp_tree, lidar_points, port_model,
                                     use_few_threads, without_refine)
from tests.test_torch_train_step import (assert_updates_match, port_step,
                                         train_cfgs)

use_few_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 256
S = 3
WORLD = 2
OHEM_N = 500
TIMEOUT = 600

WORKER = r"""
import copy
import dataclasses
import sys

import numpy as np
import torch

from streammos_tpu_torch import parallel
from streammos_tpu_torch.config import get_config
from streammos_tpu_torch.models.stream_mos import StreamMOSNet, refine_loss
from streammos_tpu_torch.nn.blocks import Dropout
from streammos_tpu_torch.tools.train import dropout_generator
from streammos_tpu_torch import train as t_train

torch.set_num_threads(2)
addr, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
parallel.initialize_distributed(addr, 2, rank, device="cpu")
assert parallel.active() and parallel.process_count() == 2
assert parallel.process_index() == rank
assert torch.distributed.get_backend() == "gloo"
res = {}

# the epoch's shard of this rank
res["order"] = torch.from_numpy(parallel.process_shard_indices(
    10, np.random.default_rng(0), 4))

# the loss case: this rank's row of the global batch, each loss mode
case = np.load(out + "/loss_case.npz")
targets = torch.from_numpy(case["targets"][rank:rank + 1])
cfg = get_config("StreamMOS_tiny")
for mode in ("ohem", "wce", "ce"):
    logits = torch.from_numpy(case["logits"][rank:rank + 1]).requires_grad_()
    mcfg = dataclasses.replace(cfg.model, loss_mode=mode)
    loss = refine_loss(mcfg, {"bf_pred": logits}, targets)
    (loss / parallel.process_count()).backward()
    res[mode] = {"loss": loss.detach(), "grad": logits.grad}

# dropout as the train CLI seeds it: the first window's mask
gen = dropout_generator(cfg.seed)
res["dropout_seed"] = torch.randint(0, 2 ** 62, (1,), generator=gen)
drop = Dropout(0.5).train()
drop.generator = torch.Generator().manual_seed(int(res["dropout_seed"]))
res["dropout_mask"] = drop(torch.ones(4096)) > 0

# one train step on this rank's row, from rank 0's weights
cfg = dataclasses.replace(
    cfg, model=dataclasses.replace(cfg.model, dropout_rate=0.0),
    optimize=dataclasses.replace(cfg.optimize, pct_start=0.0))
model = StreamMOSNet(cfg.model, with_refine=False, tta_fold=False)
model.load_state_dict(torch.load(out + "/weights.pt"), strict=False)
if rank == 1:  # replicate_state must overwrite these
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
params = dict(model.named_parameters())
tx, _ = t_train.build_optimizer(cfg.optimize, 100, params=params)
state = t_train.create_train_state(model, tx)
parallel.replicate_state(state)
windows = np.load(out + "/windows.npz")
windows = {k: torch.from_numpy(v[:, rank:rank + 1]) for k, v in windows.items()}
# the same step with remat: the collectives of each window run again in
# the backward, in the same order on every rank
model_r = copy.deepcopy(model)
tx_r, _ = t_train.build_optimizer(cfg.optimize, 100,
                                  params=dict(model_r.named_parameters()))
step_r = t_train.make_train_step(model_r, cfg, tx_r, remat=True)
_, metrics_r = step_r(t_train.create_train_state(model_r, tx_r), windows,
                      torch.Generator().manual_seed(0))
step = t_train.make_train_step(model, cfg, tx)
state, metrics = step(state, windows, torch.Generator().manual_seed(0))
res["loss"] = metrics["loss"]
res["grad_norm"] = metrics["grad_norm"]
res["state"] = model.state_dict()
res["remat"] = {"loss": metrics_r["loss"], "grad_norm": metrics_r["grad_norm"],
                "state": model_r.state_dict()}
torch.save(res, f"{out}/rank{rank}.pt")
torch.distributed.destroy_process_group()
print("DONE", rank, flush=True)
"""


def free_address() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def run_ranks(cmds, cwd):
    """Start one process a command, wait for all; kill all on a timeout.
    Returns (returncode, stdout, stderr) a process."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(c, cwd=cwd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rc, out, err in outs:
        assert rc == 0, f"rank failed:\n{out[-3000:]}\n{err[-3000:]}"
    return outs


def loss_case():
    """A bs2 batch whose row 0 is much harder than row 1: the global top-k
    (k = 0.2 * 2n) lies almost all in row 0, where each rank alone would
    take 0.2 * n of its own."""
    rng = np.random.RandomState(4)
    targets = rng.randint(1, 3, (2, OHEM_N)).astype(np.int64)
    logits = rng.normal(0, 1, (2, OHEM_N, 3)).astype(np.float32)
    onehot = np.eye(3, dtype=np.float32)[targets]
    logits += np.where(np.arange(2)[:, None, None] == 0, -2.0, 4.0) * onehot
    targets[:, :20] = 0  # a few ignored points
    return logits, targets


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results, the weights and windows they started from."""
    out = tmp_path_factory.mktemp("dp")
    _, variables = jax_tiny_model(N)
    variables = without_refine(variables)
    cfg = train_cfgs(get_config).model
    torch.save(from_flax_variables(variables, cfg), out / "weights.pt")
    rng = np.random.RandomState(31)
    windows = {"xyzi": lidar_points(rng, (S, WORLD, 3, N)),
               "targets": rng.randint(0, 3, (S, WORLD, N)).astype(np.int32)}
    np.savez(out / "windows.npz", **windows)
    logits, targets = loss_case()
    np.savez(out / "loss_case.npz", logits=logits, targets=targets)
    addr = free_address()
    run_ranks([[sys.executable, "-c", WORKER, addr, str(r), str(out)]
               for r in range(WORLD)], REPO)
    res = [torch.load(out / f"rank{r}.pt", weights_only=True)
           for r in range(WORLD)]
    return res, variables, windows


@pytest.fixture(scope="module")
def joined(ranks):
    """JAX's one-device step and the port's one-process step on the
    joined bs2 batch, from the same weights."""
    _, variables, windows = ranks
    jcfg = train_cfgs(jax_get_config)
    model = JaxStreamMOSNet(jcfg.model, with_refine=False, tta_fold=False)
    jvars = jnp_tree(variables)
    tx, _ = jax_build_optimizer(jcfg.optimize, 100, params=jvars["params"])
    step = jax_make_train_step(model, jcfg, tx, donate=False)
    args = (jax_create_train_state(jvars, tx),
            {k: jnp.asarray(v) for k, v in windows.items()},
            jax.random.key(0))
    new, metrics = compile_unfused(step, *args)(*args)
    cfg = train_cfgs(get_config).model
    jax_after = from_flax_variables(
        {"params": jax.device_get(new.params),
         "batch_stats": jax.device_get(new.batch_stats)}, cfg)

    port = port_model(variables, with_refine=False, tta_fold=False, cfg=cfg)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    _, port_metrics = port_step(port, windows, stage2=False)
    return {"jax": (float(metrics["loss"]), float(metrics["grad_norm"]),
                    jax_after),
            "port": (float(port_metrics["loss"]),
                     float(port_metrics["grad_norm"]), port.state_dict()),
            "before": before}


def _split(state):
    params = [k for k in state if not k.endswith(("running_mean",
                                                  "running_var",
                                                  "num_batches_tracked"))]
    stats = [k for k in state if k.endswith(("running_mean", "running_var"))]
    return params, stats


def test_remat_equals_plain_across_ranks(ranks):
    res, _, _ = ranks
    for r in range(WORLD):
        remat = res[r]["remat"]
        assert torch.equal(remat["loss"], res[r]["loss"])
        assert torch.equal(remat["grad_norm"], res[r]["grad_norm"])
        for k, v in res[r]["state"].items():
            assert torch.equal(remat["state"][k], v), (r, k)


def test_ranks_replicate_and_stay_equal(ranks, joined):
    res, _, _ = ranks
    assert float(res[0]["loss"]) == float(res[1]["loss"])
    assert float(res[0]["grad_norm"]) == float(res[1]["grad_norm"])
    for k, v in res[0]["state"].items():
        assert torch.equal(v, res[1]["state"][k]), k
    moved = [k for k in _split(res[0]["state"])[0]
             if not torch.equal(res[0]["state"][k], joined["before"][k])]
    assert len(moved) == len(_split(res[0]["state"])[0])


@pytest.mark.parametrize("ref", ["jax", "port"])
def test_two_process_step_equals_joined_batch(ranks, joined, ref):
    """Two ranks of bs1 against the one-device step on the bs2 batch."""
    res, _, _ = ranks
    loss, grad_norm, want = joined[ref]
    got = res[0]["state"]
    np.testing.assert_allclose(float(res[0]["loss"]), loss, rtol=1e-5)
    np.testing.assert_allclose(float(res[0]["grad_norm"]), grad_norm,
                               rtol=2e-4)
    params, stats = _split(want)
    assert_updates_match(joined["before"], got, want, params)
    assert len(stats) > 100
    for k in stats:
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-4,
                                   msg=k)


def joined_loss(mode: str, logits, targets):
    """The loss of `mode` on the joined batch: value and d/dlogits."""
    cfg = dataclasses.replace(get_config("StreamMOS_tiny").model,
                              loss_mode=mode)
    x = torch.from_numpy(logits).requires_grad_()
    loss = refine_loss(cfg, {"bf_pred": x}, torch.from_numpy(targets))
    loss.backward()
    per_rank = [float(refine_loss(cfg, {"bf_pred": x[r:r + 1].detach()},
                                  torch.from_numpy(targets[r:r + 1])))
                for r in range(WORLD)]
    return float(loss.detach()), x.grad, per_rank


@pytest.mark.parametrize("mode", ["ohem", "wce", "ce"])
def test_loss_is_global(ranks, mode):
    """Every rank's loss is the joined batch's, and so is its gradient of
    its own logits (after the gathers' backward)."""
    res, _, _ = ranks
    want, grad, _ = joined_loss(mode, *loss_case())
    for r in range(WORLD):
        np.testing.assert_allclose(float(res[r][mode]["loss"]), want,
                                   rtol=1e-5)
        torch.testing.assert_close(res[r][mode]["grad"], grad[r:r + 1],
                                   rtol=1e-5, atol=1e-7)


def test_ohem_case_splits_the_top_k():
    """In the built case the global top-k lies in row 0, where each rank
    alone would take its own: the mean of the per-rank losses misses the
    global loss by far more than the tolerance above."""
    logits, targets = loss_case()
    ce = cross_entropy_per_element(torch.from_numpy(logits),
                                   torch.from_numpy(targets))
    k = int(0.2 * ce.numel())
    top = torch.topk(ce.reshape(-1), k).indices
    assert int((top < OHEM_N).sum()) > 0.9 * k
    want, _, per_rank = joined_loss("ohem", logits, targets)
    assert abs(np.mean(per_rank) - want) > 1e3 * 1e-5 * want


def test_shards_are_disjoint_and_cover_the_padded_epoch(ranks):
    res, _, _ = ranks
    orders = [res[r]["order"].tolist() for r in range(WORLD)]
    both = orders[0] + orders[1]
    assert len(orders[0]) == len(orders[1]) == 6  # 10 padded to 12
    assert sorted(set(both)) == list(range(10))
    # padding repeats the order's head: 2 indices twice, none more
    counts = np.bincount(both, minlength=10)
    assert sorted(counts.tolist()) == [1] * 8 + [2] * 2
    full = parallel.process_shard_indices(10, np.random.default_rng(0), 4)
    assert sorted(both) == sorted(full.tolist())


def test_ranks_draw_different_dropout_masks(ranks):
    res, _, _ = ranks
    m0, m1 = res[0]["dropout_mask"], res[1]["dropout_mask"]
    assert not torch.equal(m0, m1)
    assert 0.4 < float(m0.float().mean()) < 0.6
    # rank 0 draws what one process draws (seed + 1)
    seed = get_config("StreamMOS_tiny").seed
    one = torch.randint(0, 2 ** 62, (1,),
                        generator=torch.Generator().manual_seed(seed + 1))
    assert torch.equal(res[0]["dropout_seed"], one)
    assert not torch.equal(res[1]["dropout_seed"], one)


def test_record_file_is_per_rank(tmp_path, monkeypatch):
    import logging

    from streammos_tpu_torch.train.evaluate import record_metrics

    logger = logging.getLogger("test_record")
    record_metrics({"moving_iou": 0.5}, 3, str(tmp_path), logger)
    monkeypatch.setattr(parallel, "process_index", lambda: 1)
    record_metrics({"moving_iou": 0.25}, 4, str(tmp_path), logger)
    assert sorted(os.listdir(tmp_path)) == ["record_0.txt", "record_1.txt"]
    assert (tmp_path / "record_1.txt").read_text().startswith("Epoch 4; ")


def test_val_cli_evaluates_epoch_plus_rank(tmp_path, monkeypatch):
    """With a process group of several ranks, rank R of the val CLI
    evaluates `--epoch` + R (and writes `record_R.txt`)."""
    from streammos_tpu_torch import serve
    from streammos_tpu_torch.tools import val as val_cli
    from streammos_tpu_torch.train import checkpoint
    from streammos_tpu_torch.utils.logging import config_logger

    data = tmp_path / "sequences"
    make_sequence(str(data), "08", n_frames=4, n_points=900)
    cfg = get_config("StreamMOS_tiny")
    sd = serve.build_model(cfg, with_refine=False, device="cpu",
                           seed=0).state_dict()
    ckpt = tmp_path / "ckpt"
    for epoch in (3, 4):
        checkpoint.save_model_state(str(ckpt), epoch, sd)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(parallel, "process_count", lambda: 2)
    monkeypatch.setattr(parallel, "process_index", lambda: 1)
    args = val_cli.parse_args(["--config", "StreamMOS_tiny", "--tag", "v",
                               "--data", str(data), "--points", "1024",
                               "--checkpoint", str(ckpt), "--epoch", "3",
                               "--device", "cpu"])
    exp = tmp_path / "experiments" / "StreamMOS_tiny" / "v"
    val_cli.run_eval(val_cli.eval_config(args), args, False,
                     config_logger(str(exp / "log_val.txt")))
    assert "loaded checkpoint epoch 4" in (exp / "log_val.txt").read_text()
    assert (exp / "record_1.txt").read_text().startswith("Epoch 4; ")


def test_train_cli_two_processes(tmp_path):
    """Rank 0 alone saves and validates; one record, `record_0.txt`."""
    data = tmp_path / "sequences"
    make_sequence(str(data), "00", n_frames=8, n_points=2600)
    make_sequence(str(data), "08", n_frames=4, n_points=2600)
    addr = free_address()
    outs = run_ranks(
        [[sys.executable, "-m", "streammos_tpu_torch.tools.train",
          "--config", "StreamMOS_tiny", "--tag", "dp", "--data", str(data),
          "--epochs", "1", "--points", "4096", "--max-steps", "2",
          "--start-val-epoch", "0", "--device", "cpu", "--coordinator", addr,
          "--num-processes", str(WORLD), "--process-id", str(r)]
         for r in range(WORLD)], str(tmp_path))
    exp = tmp_path / "experiments" / "StreamMOS_tiny" / "dp"
    assert sorted(f for f in os.listdir(exp) if f.startswith("record_")) == [
        "record_0.txt"]
    assert sorted(os.listdir(exp / "checkpoint")) == ["0000"]
    log0 = (exp / "log_train.txt").read_text()
    log1 = (exp / "log_train_1.txt").read_text()
    for log, rank in ((log0, 0), (log1, 1)):
        assert f"rank={rank}/2 global_batch=2" in log
        assert "epoch 0: 2 steps in" in log
    assert "evaluated 4 frames" in log0 and "evaluated" not in log1
    assert "moving_iou" in (exp / "record_0.txt").read_text()
    # the ranks logged the same global loss
    loss = [[line.split(" loss ")[1].split()[0]
             for line in log.splitlines() if " loss " in line]
            for log in (log0, log1)]
    assert loss[0] and loss[0] == loss[1]
    assert all(o[0] == 0 for o in outs)
