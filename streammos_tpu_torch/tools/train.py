"""Stage-1 / stage-2 trainer CLI, one process a card.

    python -m streammos_tpu_torch.tools.train --config StreamMOS --tag base \
        --data /path/sequences
    python -m streammos_tpu_torch.tools.train --config StreamMOS_seg \
        --tag base --data /path/sequences \
        --checkpoint experiments/StreamMOS/base/checkpoint --ckpt-epoch 47
    # data-parallel: one such command a rank, R = 0 .. W-1
    python -m streammos_tpu_torch.tools.train ... --coordinator host:port \
        --num-processes W --process-id R

Counterpart of `tools/train.py` of the JAX package. Writes under
`experiments/<cfg>/<tag>/`: `checkpoint/<epoch:04d>/state.pt` after every
epoch, `log_train.txt`, `scalars.jsonl` (loss and learning rate every
`log_frequency` steps, `val/*` after each validation), `record_0.txt`, and
the drop list `train_split_dynamic_pointnumber.txt` when the config drops
mostly static frames and `--drop-list` is not given. Resumes from the
tag's latest checkpoint. Stage 2 grafts the stage-1 checkpoint
(`--checkpoint`/`--ckpt-epoch`) and trains only the refine head. The graft
takes every entry of stage 1's model dict whose key and shape stage 2 has,
the BN running statistics included, as the original torch trainer's
``load_state_dict(strict=False)`` does. This deliberately differs from the
JAX CLI (`tools/train.py` there grafts ``params`` only, so its stage 2
starts from fresh statistics, mean 0 and variance 1). Samples
are assembled by `SampleWorkerPool` (the config's `num_workers`) behind a
`PrefetchLoader`. Runs on the CUDA card unless `--device cpu`.

Data-parallel, with JAX's roles and seeds: the process group over
``tcp://<coordinator>`` (NCCL on CUDA, gloo on the CPU), rank R on
``cuda:<R mod cards>``; a global batch of ``batch_size_per_device x W``
rows, this rank's `process_shard_indices` of the epoch, the epoch's
length from the global batch; `TrainDataset` seeded ``seed + R``, the
worker pool ``seed + 7919 R``; dropout from ``seed + 1 + 7919 R``, so the
ranks draw different masks (JAX draws one mask over the global batch from
one key, ``seed + 1``, which no per-rank draw reproduces). Rank 0 alone
saves the checkpoints, validates, writes `record_0.txt` and
`scalars.jsonl`, and logs to `log_train.txt`; rank R > 0 logs to
`log_train_R.txt`.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="StreamMOS trainer (PyTorch "
                                             "port)")
    ap.add_argument("--config", default="StreamMOS")
    ap.add_argument("--tag", default="base")
    ap.add_argument("--data", default=None, help="SemanticKITTI sequences dir")
    ap.add_argument("--checkpoint", default=None,
                    help="stage-1 checkpoint dir to graft (stage 2)")
    ap.add_argument("--ckpt-epoch", type=int, default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--drop-list", default=None,
                    help="train_split_dynamic_pointnumber.txt path "
                         "(generated from the labels when omitted and the "
                         "config enables drop_few_static_frames)")
    ap.add_argument("--start-val-epoch", type=int, default=1,
                    help="run sequence-08 validation at the end of every "
                         "epoch >= this")
    ap.add_argument("--no-val", action="store_true",
                    help="disable in-train validation")
    ap.add_argument("--points", type=int, default=None,
                    help="override frame_point_num")
    ap.add_argument("--max-steps", type=int, default=None,
                    help="cap optimizer steps per epoch (the epoch's "
                         "checkpoint and validation still happen)")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="override batch_size_per_device")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0 (data-parallel)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    return ap.parse_args(argv)


def dropout_generator(seed: int):
    """The generator of the step's dropout seeds on this rank:
    ``seed + 1 + 7919 * rank``."""
    import torch

    from streammos_tpu_torch.parallel import process_index

    return torch.Generator().manual_seed(seed + 1 + 7919 * process_index())


def train_config(args):
    """The registered config with the CLI's overrides."""
    from streammos_tpu_torch.config import get_config

    cfg = get_config(args.config)
    if args.data:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, seq_dir=args.data),
            val=dataclasses.replace(cfg.val, seq_dir=args.data))
    if args.points:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train,
                                           frame_point_num=args.points),
            val=dataclasses.replace(cfg.val, frame_point_num=args.points))
    if args.epochs:
        cfg = dataclasses.replace(
            cfg, optimize=dataclasses.replace(cfg.optimize,
                                              end_epoch=args.epochs))
    if args.batch_size:
        cfg = dataclasses.replace(cfg, batch_size_per_device=args.batch_size)
    return cfg


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch

    from streammos_tpu_torch import parallel, serve
    from streammos_tpu_torch import train as tr
    from streammos_tpu_torch.data.copy_paste import SequenceCutPaste
    from streammos_tpu_torch.data.dataset import EvalDataset, TrainDataset
    from streammos_tpu_torch.data.droplist import write_drop_list
    from streammos_tpu_torch.data.loader import (PrefetchLoader,
                                                 SampleWorkerPool)
    from streammos_tpu_torch.train.evaluate import record_metrics, stream_eval
    from streammos_tpu_torch.utils.logging import ScalarWriter, config_logger

    parallel.initialize_distributed(args.coordinator, args.num_processes,
                                    args.process_id, device=args.device)
    rank, world = parallel.process_index(), parallel.process_count()
    device = serve.resolve_device(parallel.local_device(args.device))
    if device.type == "cuda" and parallel.active():
        torch.cuda.set_device(device)  # the card NCCL's communicator binds
    cfg = train_config(args)
    stage2 = cfg.freeze_except is not None

    save_path = os.path.join("experiments", cfg.name, args.tag)
    ckpt_dir = os.path.join(save_path, "checkpoint")
    logger = config_logger(os.path.join(
        save_path, "log_train.txt" if rank == 0 else f"log_train_{rank}.txt"))
    writer = (ScalarWriter(os.path.join(save_path, "scalars.jsonl"))
              if rank == 0 else None)
    global_bs = cfg.batch_size_per_device * world
    local_bs = global_bs // world
    logger.info("device=%s rank=%d/%d global_batch=%d stage2=%s", device,
                rank, world, global_bs, stage2)

    # dataset
    cp = None
    if cfg.train.copy_paste.is_use and args.data:
        bank = os.path.join(os.path.dirname(args.data.rstrip("/")),
                            cfg.train.copy_paste.obj_bank_dir)
        if os.path.isdir(bank):
            cp = SequenceCutPaste(bank, cfg.train.copy_paste.paste_max_obj_num)
    drop_list = args.drop_list
    if drop_list is None and cfg.train.drop_few_static_frames:
        drop_list = os.path.join(save_path,
                                 "train_split_dynamic_pointnumber.txt")
        if not os.path.exists(drop_list):
            n_kept, n_total = write_drop_list(cfg.train.seq_dir, drop_list)
            logger.info("drop list: kept %d/%d frames -> %s", n_kept, n_total,
                        drop_list)
    ds = TrainDataset(cfg.train, copy_paste=cp, drop_list_path=drop_list,
                      seed=cfg.seed + rank)
    if len(ds) == 0:
        raise SystemExit(f"no training samples under {cfg.train.seq_dir}")
    # every rank takes ceil(len / global batch) steps: the order is padded
    # to a multiple of the global batch
    per_epoch_iters = max(-(-len(ds) // global_bs), 1)

    val_ds = None
    if not args.no_val and rank == 0:
        val_ds = EvalDataset(cfg.val, split="valid", with_labels=True)
        if len(val_ds) == 0:
            logger.warning("no sequence-08 frames under %s — in-train "
                           "validation disabled", cfg.val.seq_dir)
            val_ds = None

    # model + optimizer
    state_dict = None
    if stage2 and args.checkpoint:
        epoch = (args.ckpt_epoch if args.ckpt_epoch is not None
                 else tr.latest_epoch(args.checkpoint))
        state_dict = tr.load_model_state(args.checkpoint, epoch)
        logger.info("grafted stage-1 checkpoint epoch %s", epoch)
    model = tr.build_train_model(cfg, stage2=stage2, device=device,
                                 state_dict=state_dict)
    params = dict(model.named_parameters())
    tx, sched = tr.build_optimizer(cfg.optimize, per_epoch_iters,
                                   params=params,
                                   freeze_except=cfg.freeze_except)
    state = tr.create_train_state(model, tx)

    resume = tr.latest_epoch(ckpt_dir)
    start_epoch = 0
    if resume is not None:
        state = tr.restore(ckpt_dir, resume, state)
        start_epoch = resume + 1
        logger.info("resumed from epoch %d", resume)
    parallel.replicate_state(state)

    step_fn = tr.make_train_step(model, cfg, tx, stage2=stage2)
    n_params = sum(p.numel() for p in params.values())
    logger.info("Total Parameters: %.2fM", n_params / 1e6)

    generator = dropout_generator(cfg.seed)
    eval_model = None
    pool = SampleWorkerPool(ds, cfg.train.num_workers,
                            seed=cfg.seed + 7919 * rank)
    try:
        for epoch in range(start_epoch, cfg.optimize.end_epoch):
            order = parallel.process_shard_indices(
                len(ds), np.random.default_rng(cfg.seed + epoch), global_bs)
            t_epoch = time.time()
            loader = PrefetchLoader(
                pool.batches(order, local_bs, TrainDataset.collate), depth=2)
            n_steps, t_first = 0, None
            for it, batch in enumerate(loader):
                if args.max_steps is not None and it >= args.max_steps:
                    break
                if t_first is None:
                    t_first = time.time()
                windows = {k: torch.from_numpy(v).to(device)
                           for k, v in batch.items()}
                state, metrics = step_fn(state, windows, generator)
                n_steps += 1
                if it % cfg.log_frequency == 0:
                    loss = float(metrics["loss"])
                    lr = float(sched(state.step))
                    logger.info("epoch %d iter %d loss %.4f lr %.5f", epoch,
                                it, loss, lr)
                    if writer is not None:
                        writer.add_scalars({"loss": loss, "lr": lr},
                                           state.step)
                if n_steps == 1:
                    float(metrics["loss"])  # waits for the first step
                    t_warm = time.time()
            if n_steps:
                float(metrics["loss"])  # waits for the last step
                t_end = time.time()
                after = ((t_end - t_warm) / (n_steps - 1) if n_steps > 1
                         else float("nan"))
                logger.info("epoch %d: %d steps in %.3fs, %.4f s/step, "
                            "%.4f s/step after the first (from the first "
                            "batch in hand to the last step done)", epoch,
                            n_steps, t_end - t_first,
                            (t_end - t_first) / n_steps, after)

            if rank == 0:
                tr.save(ckpt_dir, epoch, state)
            if val_ds is not None and epoch >= args.start_val_epoch:
                if eval_model is None:
                    eval_model = serve.build_model(
                        cfg, with_refine=stage2, device=device,
                        state_dict=model.state_dict())
                else:
                    eval_model.load_state_dict(model.state_dict())
                result = stream_eval(cfg, cfg.val, eval_model,
                                     with_refine=stage2, with_labels=True,
                                     logger=logger, dataset=val_ds)
                record_metrics(result, epoch, save_path, logger, writer)
            logger.info("epoch %d done in %.1fs", epoch, time.time() - t_epoch)
    finally:
        pool.close()
        if writer is not None:
            writer.close()
        if parallel.active():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
