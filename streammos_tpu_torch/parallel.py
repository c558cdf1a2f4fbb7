"""Data-parallel training over `torch.distributed`.

Counterpart of `streammos_tpu/parallel.py`. JAX runs one jitted step over
a 1-D device mesh with the batch axis sharded, so everything that reduces
over the batch reduces over the global batch. The port runs one process a
card, each holding its local rows of the batch, and makes the same
reductions global by hand:

* BatchNorm statistics: `nn/blocks.py:BN` all-reduces its per-channel sums
  (`all_reduce_sum`, differentiable);
* the losses: the logits and targets are gathered along the batch axis in
  rank order (`gather_batch`, differentiable) before the criterion and the
  Lovász loss, so OHEM's k and top-k set, the Lovász order and the `wce`
  weight sums are the global batch's;
* the gradient: summed over the ranks in flat buckets (`all_reduce_grads`).

`DistributedDataParallel` is not used: a train step calls the model once a
window before one backward, and DDP's reducer expects one forward a
backward. Everything above is a no-op while no process group is active,
so one process runs exactly the code it runs without this module.

Each exchange is a span (`utils/profiling.span`): ``smt.dp.bn`` (the BN
sums' all-reduce, forward and backward), ``smt.dp.gather`` (the losses'
all-gather and its backward all-reduce), ``smt.dp.grads`` (the bucketed
gradient all-reduce) and ``smt.dp.replicate`` (the set-up broadcast); and
every collective counts one ``dp.collectives`` and its payload, the bytes
this rank hands to it, in ``dp.bytes``.
"""
from __future__ import annotations

import datetime
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from streammos_tpu_torch.utils.profiling import count, span

BUCKET_BYTES = 32 << 20  # gradient all-reduce bucket


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device="cuda",
                           timeout: Optional[float] = None) -> None:
    """Join the process group at ``tcp://<coordinator>`` (host:port) as rank
    `process_id` of `num_processes`. Does nothing when `num_processes` is
    1 or less, as JAX's does. The backend defaults to ``nccl`` for a CUDA
    `device` and ``gloo`` for the CPU; ``gloo`` may be asked for on a CUDA
    device, so that two ranks can share one card (NCCL refuses two ranks on
    one device). `timeout` (seconds; torch's default when None) bounds the
    rendezvous and every collective: a rank left waiting on a dead peer
    raises (gloo) or is torn down by NCCL's watchdog instead of hanging."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator is None or process_id is None:
        raise ValueError("a process group of more than one process needs "
                         "a coordinator address and a process id")
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    kwargs = ({} if timeout is None else
              {"timeout": datetime.timedelta(seconds=timeout)})
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            **kwargs)


def active() -> bool:
    """True while a process group is initialized."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if active() else 0


def process_count() -> int:
    return dist.get_world_size() if active() else 1


def local_device(device="cuda") -> torch.device:
    """`device` for this rank: while a process group is active, bare
    ``cuda`` becomes ``cuda:<rank mod cards>`` (ranks beyond the card count
    share cards); anything else is `device` itself."""
    device = torch.device(device)
    if not active() or device.type != "cuda" or device.index is not None:
        return device
    return torch.device("cuda", process_index() % torch.cuda.device_count())


def replicate_state(state) -> None:
    """Broadcast rank 0's parameters, buffers and optimizer-state tensors to
    every rank, in place (JAX's replicated sharding of the train state)."""
    if not active():
        return
    tensors = list(state.model.state_dict().values())
    for v in state.opt_state.values():
        if isinstance(v, dict):
            tensors += list(v.values())
    with span("smt.dp.replicate"):
        for t in tensors:
            dist.broadcast(t, src=0)
            _issued(t)


def _issued(t: torch.Tensor) -> None:
    """Count one collective and the bytes this rank hands to it."""
    count("dp.collectives")
    count("dp.bytes", t.numel() * t.element_size())


def _summed(t: torch.Tensor, name: str) -> torch.Tensor:
    """A contiguous copy of `t` summed over the ranks, in span `name`."""
    t = t.clone(memory_format=torch.contiguous_format)
    with span(name):
        dist.all_reduce(t)
    _issued(t)
    return t


class _GatherBatch(torch.autograd.Function):
    """All-gather along dim 0 in rank order. Backward: the cotangents of
    the gathered tensor summed over the ranks (an all-reduce), then this
    rank's rows: a reduce-scatter sum, from the one collective gloo also
    runs on CUDA tensors."""

    @staticmethod
    def forward(ctx, x):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        with span("smt.dp.gather"):
            dist.all_gather(parts, x)
        _issued(x)
        ctx.rows = x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        start = dist.get_rank() * ctx.rows
        return _summed(grad, "smt.dp.gather")[start:start + ctx.rows]


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """Every rank's `x` concatenated along dim 0 in rank order (the global
    batch, as JAX's batch-sharded array holds it); differentiable. `x`
    itself while no process group is active. Every rank must pass the same
    shape."""
    return _GatherBatch.apply(x) if active() else x


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the cotangents over the ranks
    too (every rank's output depends on every rank's input). Span
    ``smt.dp.bn``: the BN sums are its one caller."""

    @staticmethod
    def forward(ctx, x):
        return _summed(x, "smt.dp.bn")

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, "smt.dp.bn")


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over the ranks, differentiable (requires an active
    process group)."""
    return _AllReduceSum.apply(x)


def all_reduce_grads(grads: Dict[str, torch.Tensor]) -> None:
    """Sum each gradient over the ranks in place, packed into flat buckets
    of at most BUCKET_BYTES (one tensor larger than that is a bucket of
    its own), one all-reduce a bucket, in the dict's order on every rank."""
    if not active():
        return
    bucket: List[torch.Tensor] = []
    size = 0

    def flush():
        flat = torch.cat([g.reshape(-1) for g in bucket])
        with span("smt.dp.grads"):
            dist.all_reduce(flat)
        _issued(flat)
        parts = flat.split([g.numel() for g in bucket])
        torch._foreach_copy_(bucket, [p.view_as(g)
                                      for p, g in zip(parts, bucket)])

    for g in grads.values():
        nbytes = g.numel() * g.element_size()
        if bucket and (size + nbytes > BUCKET_BYTES
                       or g.dtype != bucket[0].dtype
                       or g.device != bucket[0].device):
            flush()
            bucket, size = [], 0
        bucket.append(g)
        size += nbytes
    if bucket:
        flush()


def process_shard_indices(num_samples: int,
                          shuffle_rng: Optional[np.random.Generator],
                          batch_size_global: int) -> np.ndarray:
    """This rank's share of the epoch's sample order, as torch's
    DistributedSampler makes it: shuffled with ``shuffle_rng`` (when given,
    the same seed on every rank), padded with its own head to a multiple
    of the global batch, then every `process_count()`-th index from
    `process_index()` on."""
    idx = np.arange(num_samples)
    if shuffle_rng is not None:
        shuffle_rng.shuffle(idx)
    pad = (-len(idx)) % batch_size_global
    if pad:
        idx = np.concatenate([idx, idx[:pad]])
    return idx[process_index()::process_count()]
