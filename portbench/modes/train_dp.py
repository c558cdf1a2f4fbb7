"""Loop ``train_dp``: the streaming train step data-parallel over `world`
ranks, one card a rank, as the recipe's ``torch.distributed.launch
--nproc_per_node=<world>`` runs it, through the measured package's own
path (`tools/train.py`'s): `parallel.initialize_distributed` (NCCL on
cards, gloo on the CPU), the rank's card, `trainer.build_train_model`,
`parallel.replicate_state`, then `trainer.make_train_step` on the rank's
rows of each global batch.

Traffic parameters: those of ``train`` (`modes/train.py`), `batch` being
a rank's rows, and `world`. Rank 0 is the calling process: it starts
ranks 1.. as processes of this file (``python3 modes/train_dp.py --rank
r ...``, on ``cuda:r``), and its window, peak and set-up (the start of
the other ranks and of the group included) are the run's. Every rank
draws the same weights and the same global bank of `world` x `batch` rows
from the seeds, and rank r trains on rows r x batch .. (r + 1) x batch -
1, its dropout seeded as the train CLI seeds rank r (``seed + 1 + 7919
r``). Rank 0 alone decides when the window ends: before each step it
tells the other ranks, through a store of its own, whether to take it.

Each rank records the chain and the seeded reservoir of steps as
``train`` does (the same steps on every rank). After the window, the
rows' parts of the record (each rank's dropout masks, first-window
logits and rows' gradient norms) reach rank 0, the other ranks leave the
group and exit, and `compare()` replays each recorded step on all
`world` x `batch` rows with the plain float32 training reference,
computed a window at a time (`reference/streammos_train_global.py`), on
rank 0's card: `train_check`'s numbers, on the global batch.

With `sut.Reference` in the program's place (the float8 control) rank 0
alone runs that reference on the whole global batch, no group.

A rank that dies ends the run: rank 0 watches the others and exits 1 as
soon as one exits with an error; the other ranks die with rank 0 (the
parent-death signal) and the group's collectives time out after
`TIMEOUT_S`.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import inspect
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import traceback
from datetime import timedelta
from pathlib import Path
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    # a rank > 0, run as a script: the checkout's root on the path instead
    # of this folder, so `portbench` is a package
    sys.path = [str(HERE.parent)] + [
        p for p in sys.path if Path(p or ".").resolve() != HERE / "modes"]

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from portbench import loops, manifest, modes, sut, train_check  # noqa: E402
from portbench import weights as wts  # noqa: E402
from portbench.faults import _patched  # noqa: E402
from portbench.reference import streammos as ref  # noqa: E402
from portbench.reference import streammos_train_global as rg  # noqa: E402

TRAIN = modes.load("train", HERE)
TIMEOUT_S = 60.0
ROW_DIM = {"row_sq": 1, "logits0": 0}  # a slot's per-row tensors, by batch dim


# -------------------------------------------------------------------- faults

@contextlib.contextmanager
def _bn_local():
    """The BN sums not all-reduced: each rank's statistics its own rows'."""
    from streammos_tpu_torch.nn import blocks

    def local(xf, axes, C):
        mean = xf.mean(axes)
        return mean, torch.clamp(xf.square().mean(axes) - mean.square(),
                                 min=0.0)
    # the class's own entry: `getattr` would hand back the bare function
    # and put it back as a method
    old = vars(blocks.BN)["_global_moments"]
    blocks.BN._global_moments = staticmethod(local)
    try:
        yield
    finally:
        blocks.BN._global_moments = old


@contextlib.contextmanager
def _grads_local():
    """The gradient all-reduce left out."""
    from streammos_tpu_torch import parallel

    with _patched(parallel, "all_reduce_grads", lambda grads: None):
        yield


@contextlib.contextmanager
def _loss_local():
    """Each rank's losses over its own rows (no gather): the mean of the
    ranks' losses, as the recipe's DDP takes it."""
    from streammos_tpu_torch.models import stream_mos

    with _patched(stream_mos, "gather_batch", lambda x: x):
        yield


PATCHES = {"bn_local": _bn_local, "grads_local": _grads_local,
           "loss_local": _loss_local}
ACTIVE: List[str] = []  # the faults planted in this process, for the ranks


def _planted(name: str):
    @contextlib.contextmanager
    def fault():
        ACTIVE.append(name)
        try:
            with PATCHES[name]():
                yield
        finally:
            ACTIVE.remove(name)
    return fault


FAULTS = {name: _planted(name) for name in PATCHES}


# --------------------------------------------------------------------- ranks

class Record(loops.Record):
    """`loops.Record` with the ranks' number and the program's counters at
    the window's start and end (rank 0)."""
    world: int = 1
    counts: Optional[Tuple[Dict[str, int], Dict[str, int]]] = None


def _global(cell):
    """`cell` with the traffic's batch the global batch."""
    t = cell.traffic
    return dataclasses.replace(cell, traffic=dict(
        t, batch=t["world"] * t["batch"]))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _counters() -> Dict[str, int]:
    from streammos_tpu_torch.utils.profiling import counters
    return counters()


def _gather(t: torch.Tensor, dim: int, rank: int, world: int
            ) -> Optional[torch.Tensor]:
    """Every rank's `t` joined along `dim` in rank order, in host memory on
    rank 0 (None on the others)."""
    wire = t.contiguous()
    wire = wire.view(torch.uint8) if t.dtype == torch.bool else wire
    parts = ([torch.empty_like(wire) for _ in range(world)] if rank == 0
             else None)
    dist.gather(wire, parts, dst=0)
    if rank != 0:
        return None
    out = torch.cat([p.cpu() for p in parts], dim)
    return out.view(torch.bool) if t.dtype == torch.bool else out


def _gather_rows(slots: List[Dict], rank: int, world: int) -> None:
    """Replace each slot's per-row tensors by every rank's, on rank 0."""
    for slot in slots:
        for key in sorted(slot["masks"]):
            slot["masks"][key] = _gather(slot["masks"][key], 0, rank, world)
        for key, dim in ROW_DIM.items():
            slot[key] = _gather(slot[key], dim, rank, world)


def train_rank(cell, rank: int, world: int, addr: str, store, w_seed: int,
               t_seed: int, device, seconds: float = 0.0,
               trace: bool = False):
    """One rank of the run, rank 0 or another, from joining the group to
    leaving it. Returns, on rank 0, the window's record, the recorder (its
    slots holding every rank's rows), the weights and the global bank in
    host memory; on the others None. On an error the group is left as it
    is: the caller stops the other ranks first (`_distributed`), since
    NCCL's teardown can wait on a peer that waits on this rank."""
    from streammos_tpu_torch import parallel

    t, config = cell.traffic, cell.config
    if device.type == "cuda":
        torch.cuda.set_device(device)  # the card NCCL's communicator binds
    parallel.initialize_distributed(addr, world, rank, device=device,
                                    timeout=TIMEOUT_S)
    meta = ref.StreamMOS(config["model"], config["with_refine"]).to("meta")
    weights = wts.draw_weights(meta, w_seed, device)
    side = TRAIN.PortSide(config, weights, device, t)
    parallel.replicate_state(side.state)
    xyzi, labels = TRAIN.draw_bank(_global(cell), t_seed, device)
    rows = slice(rank * t["batch"], (rank + 1) * t["batch"])
    bank = xyzi[:, :, rows].clone(), labels[:, :, rows].clone()
    held = (xyzi.cpu(), labels.cpu()) if rank == 0 else None
    del xyzi, labels
    generator = torch.Generator().manual_seed(t_seed + 1 + 7919 * rank)
    rec, recorder = _loop(side, bank, cell, t_seed, generator, store,
                          rank, device, seconds, trace)
    del side, bank
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    _gather_rows(recorder.chain + recorder.sample(), rank, world)
    dist.destroy_process_group()
    if rank == 0:
        rec.world = world
        return rec, recorder, weights, held
    return None


def _loop(side, bank, cell, t_seed, generator, store, rank, device,
          seconds, trace):
    """`modes/train.py`'s loop on this rank's rows; with a `store`, rank 0
    says before each step whether the others take it too."""
    t, config = cell.traffic, cell.config
    recorder = TRAIN.StepRecorder(t["check_steps"], t["chain_steps"], t_seed)
    undo = side.hook(recorder)
    log_every = config["log_frequency"]
    rec = Record("train")
    rows = bank[1].shape[2]
    n, win, ended = 0, None, False
    try:
        while True:
            if rank == 0:
                if ended:
                    break
                if n == t["warmup_steps"]:
                    win = loops._window(rec, recorder, device, trace)
                    win.__enter__()
                    rec.counts = (_counters(), {})
                if store is not None:
                    store.set(f"go{n}", "1")
            elif store.get(f"go{n}") != b"1":
                break
            elif n == t["warmup_steps"]:
                recorder.in_window = True  # the window's steps, as rank 0's
            k = n % t["bank_samples"]
            recorder.begin(side, k, (t["windows"], rows))
            loss = side.step({"xyzi": bank[0][k], "targets": bank[1][k]},
                             generator)
            recorder.end(side, loss)
            if n % log_every == 0:
                float(loss)
            n += 1
            if win is not None:
                rec.steps += 1
                ended = loops._done(rec, time.perf_counter(), seconds,
                                    t["trace_steps"], trace)
        if win is not None:
            win.__exit__(None, None, None)
            rec.counts = (rec.counts[0], _counters())
        if rank == 0 and store is not None:
            store.set(f"go{n}", "0")
    finally:
        undo()
    rec.frames = rec.steps
    return rec, recorder


class Ranks:
    """Ranks 1.. as processes of this file. A watcher thread ends the run
    (exit 1) when one exits with an error before `join`; `stop` kills
    those still running."""

    def __init__(self, cell, world, addr, control, w_seed, t_seed, device):
        payload = json.dumps({"config": cell.config, "traffic": cell.traffic})
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(HERE.parent)] + [p for p in [env.get("PYTHONPATH")] if p])
        self.procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rank", str(r),
             "--world", str(world), "--addr", addr, "--control", control,
             "--w-seed", str(w_seed), "--t-seed", str(t_seed),
             "--device", device.type, "--faults", ",".join(ACTIVE),
             "--parent", str(os.getpid()), "--cell", payload],
            cwd=str(HERE.parent), env=env, stdout=subprocess.DEVNULL)
            for r in range(1, world)]
        self.joined = False
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self):
        while not self.joined:
            for r, p in enumerate(self.procs, 1):
                rc = p.poll()
                if rc not in (None, 0) and not self.joined:
                    print(f"portbench: rank {r} exited with {rc}; ending the "
                          f"run", file=sys.stderr, flush=True)
                    self.stop()
                    os._exit(1)
            time.sleep(0.2)

    def join(self) -> None:
        for r, p in enumerate(self.procs, 1):
            rc = p.wait(timeout=TIMEOUT_S)
            if rc != 0:
                raise RuntimeError(f"rank {r} exited with {rc}")
        self.joined = True

    def stop(self) -> None:
        self.joined = True
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


# -------------------------------------------------------------------- check

class Replay(train_check.Replay):
    """`train_check.Replay` with the reference computed a window at a time
    on the global batch."""

    def __init__(self, cell, weights, device, layouts):
        self.trainer = rg.Trainer(rg.train_model(cell.config, weights, device),
                                  cell.config["optimize"],
                                  cell.traffic["epoch_steps"])
        self.params = self.trainer.params
        self.p_lay, self.b_lay = layouts


def _on(slot: Dict, device) -> Dict:
    out = {k: v.to(device) if isinstance(v, torch.Tensor) else v
           for k, v in slot.items() if k != "masks"}
    out["masks"] = {k: v.to(device) for k, v in slot["masks"].items()}
    return out


def global_numbers(cell, bank, chain, sample, layouts, weights, device
                   ) -> Dict:
    """`train_check.train_numbers` on the global batch (`bank` in host
    memory), the reference computed a window at a time."""
    xyzi, labels = bank
    out = {p + k: 0.0 for p in ("chain_", "") for k in train_check.NUMBERS}
    out["finite"] = 1.0
    with train_check.float32_exact():
        replay = Replay(cell, weights, device, layouts)
        for prefix, steps in (("chain_", chain), ("", sample)):
            for c in steps:
                c = _on(c, device)
                if not prefix:
                    replay.set_state(c)
                r = replay.step(c, xyzi[c["sample"]].to(device),
                                labels[c["sample"]].to(device))
                train_check.compare(c, r, layouts[0], prefix, out)
                del c, r
    out["steps_checked"] = float(len(chain) + len(sample))
    return out


class ReferenceSide(TRAIN.ReferenceSide):
    """The plain reference on the whole global batch, a window at a time,
    in the system's precision (the control)."""

    def __init__(self, config, weights, device, traffic, precision):
        self.model = rg.train_model(config, weights, device, precision)
        self.trainer = rg.Trainer(self.model, config["optimize"],
                                  traffic["epoch_steps"])
        self.params = self.trainer.params
        self.keep = 1.0 - config["model"]["dropout_rate"]
        self.device = device
        self.recorder = None


# ---------------------------------------------------------------------- run

def run(system, cell, w_seed, t_seed, seconds, trace, device):
    t = cell.traffic
    gcell = _global(cell)
    if isinstance(system, sut.Reference):
        meta = ref.StreamMOS(cell.config["model"], False).to("meta")
        weights = wts.draw_weights(meta, w_seed, device)
        side = ReferenceSide(cell.config, weights, device, t, system.precision)
        held = TRAIN.draw_bank(gcell, t_seed, device)
        rec, recorder = _loop(side, held, gcell, t_seed,
                              torch.Generator().manual_seed(t_seed + 1), None,
                              0, device, seconds, trace)
        held = tuple(h.cpu() for h in held)
        del side
    elif isinstance(system, sut.Port):
        rec, recorder, weights, held = _distributed(cell, w_seed, t_seed,
                                                    seconds, trace, device)
    else:
        raise TypeError(f"no train side for {type(system).__name__}")
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    def compare():
        chain, sample = recorder.chain, recorder.sample()
        numbers = global_numbers(gcell, held, chain, sample,
                                 recorder.layouts, weights, device)
        if (len(chain) != t["chain_steps"]
                or len(sample) != min(t["check_steps"], rec.steps)):
            numbers["finite"] = 0.0
        return numbers, len(chain) + len(sample)

    return rec, compare


def _distributed(cell, w_seed, t_seed, seconds, trace, device):
    from streammos_tpu_torch import parallel

    if "timeout" not in inspect.signature(
            parallel.initialize_distributed).parameters:
        raise RuntimeError("the program's initialize_distributed takes no "
                           "timeout: a rank that dies would leave the others "
                           "waiting")
    world = cell.traffic["world"]
    if device.type == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} ranks need {world} cards; "
                           f"{torch.cuda.device_count()} present")
    addr = f"127.0.0.1:{_free_port()}"
    port = _free_port()
    store = dist.TCPStore("127.0.0.1", port, world, True,
                          timedelta(seconds=TIMEOUT_S),
                          wait_for_workers=False)
    ranks = Ranks(cell, world, addr, f"127.0.0.1:{port}", w_seed, t_seed,
                  device)
    try:
        out = train_rank(cell, 0, world, addr, store, w_seed, t_seed, device,
                         seconds, trace)
        ranks.join()
    except BaseException:
        ranks.stop()
        # NCCL's teardown could wait on the ranks just stopped; gloo's not
        if dist.is_initialized() and dist.get_backend() == "gloo":
            dist.destroy_process_group()
        raise
    return out


# ------------------------------------------------------------ ranks 1 .. W-1

def _die_with_parent(parent: int) -> None:
    """Ask Linux to kill this process when its parent dies."""
    try:
        import ctypes
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one rank > 0 of train_dp")
    for name in ("--rank", "--world", "--w-seed", "--t-seed", "--parent"):
        ap.add_argument(name, type=int, required=True)
    for name in ("--addr", "--control", "--device", "--faults", "--cell"):
        ap.add_argument(name, required=True)
    args = ap.parse_args(argv)
    _die_with_parent(args.parent)
    cell = manifest.Cell(name="", chips=args.world, limits={}, end_to_end=[],
                         per_layer=[], **json.loads(args.cell))
    device = (torch.device("cuda", args.rank) if args.device == "cuda"
              else torch.device(args.device))
    host, port = args.control.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), args.world, False,
                          timedelta(seconds=TIMEOUT_S))
    try:
        with contextlib.ExitStack() as stack:
            for name in filter(None, args.faults.split(",")):
                stack.enter_context(PATCHES[name]())
            train_rank(cell, args.rank, args.world, args.addr, store,
                       args.w_seed, args.t_seed, device)
    except BaseException:
        # no teardown of the group: it could wait on a rank that waits here
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
