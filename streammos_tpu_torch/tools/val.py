"""Streaming evaluation CLI: runs sequence 08 (or the test sequences) in
order with the short-term memory carried from frame to frame, TTA x4
folded on the card, computes moving-IoU and writes KITTI `.label`
prediction files.

    python -m streammos_tpu_torch.tools.val --config StreamMOS_seg \
        --tag base --data /path/sequences [--epoch 9] [--device cpu]

Writes `experiments/<cfg>/<tag>/<split>_results/sequences/<seq>/predictions/
<frame>.label` (`<split>_bf_results` too for a stage-2 config) and appends
the metrics to `experiments/<cfg>/<tag>/record_<rank>.txt` (rank 0 in one
process). Loads the port's checkpoints (`train/checkpoint.py`) from
`--checkpoint`, by default the tag's own `checkpoint/` directory; without
one it evaluates weights drawn from the config's seed. Runs on the CUDA
card unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import dataclasses
import os


def run_eval(cfg, args, with_refine: bool, logger):
    """The streaming eval of `args.split` as the CLI runs it; returns the
    metric dict (None on the test split, which has no labels)."""
    from streammos_tpu_torch import parallel, serve
    from streammos_tpu_torch.data.dataset import EvalDataset
    from streammos_tpu_torch.train import checkpoint as ckpt_lib
    from streammos_tpu_torch.train.evaluate import record_metrics, stream_eval

    device = serve.resolve_device(args.device)
    dcfg = cfg.test if args.split == "test" else cfg.val
    with_labels = args.split != "test"
    ds = EvalDataset(dcfg, split="valid" if args.split == "val" else args.split,
                     with_labels=with_labels)
    if len(ds) == 0:
        raise SystemExit(f"no eval frames under {dcfg.seq_dir}")

    ckpt_dir = args.checkpoint or os.path.join("experiments", cfg.name,
                                               args.tag, "checkpoint")
    epoch = args.epoch if args.epoch is not None else ckpt_lib.latest_epoch(ckpt_dir)
    # with a process group of several ranks, each evaluates another epoch
    # (the original torch val script's `epoch + rank`, kept by JAX's)
    if epoch is not None and parallel.process_count() > 1:
        epoch += parallel.process_index()
    state_dict = None
    if epoch is not None:
        state_dict = ckpt_lib.load_model_state(ckpt_dir, epoch)
        logger.info("loaded checkpoint epoch %s from %s", epoch, ckpt_dir)
    else:
        logger.warning("no checkpoint found — evaluating weights drawn from "
                       "seed %d", cfg.seed)
    # folded TTA: the 4 flip variants share one scatter/gather index
    # structure, and the fused header runs once a frame
    model = serve.build_model(cfg, with_refine=with_refine, device=device,
                              state_dict=state_dict)

    save_path = os.path.join("experiments", cfg.name, args.tag)
    save_root = os.path.join(save_path, f"{args.split}_results", "sequences")
    bf_root = os.path.join(save_path, f"{args.split}_bf_results", "sequences")
    result = stream_eval(cfg, dcfg, model, with_refine=with_refine,
                         with_labels=with_labels, logger=logger, dataset=ds,
                         save_root=save_root,
                         bf_root=bf_root if with_refine else None,
                         carry_across_sequences=args.carry_across_sequences)
    if result is not None:
        record_metrics(result, epoch, save_path, logger)
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="StreamMOS streaming eval "
                                             "(PyTorch port)")
    ap.add_argument("--config", default="StreamMOS")
    ap.add_argument("--tag", default="base")
    ap.add_argument("--data", default=None, help="SemanticKITTI sequences dir")
    ap.add_argument("--split", default="val", choices=["val", "test"])
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--epoch", type=int, default=None)
    ap.add_argument("--points", type=int, default=None,
                    help="override frame_point_num")
    ap.add_argument("--carry-across-sequences", action="store_true",
                    help="carry the short-term memory over sequence "
                         "boundaries (the reference's test-split "
                         "behaviour); by default it resets per sequence")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    return ap.parse_args(argv)


def eval_config(args):
    """The registered config with the CLI's overrides."""
    from streammos_tpu_torch.config import get_config

    cfg = get_config(args.config)
    if args.data:
        cfg = dataclasses.replace(
            cfg,
            val=dataclasses.replace(cfg.val, seq_dir=args.data),
            test=dataclasses.replace(cfg.test, seq_dir=args.data))
    if args.points:
        cfg = dataclasses.replace(
            cfg,
            val=dataclasses.replace(cfg.val, frame_point_num=args.points),
            test=dataclasses.replace(cfg.test, frame_point_num=args.points))
    return cfg


def main(argv=None):
    args = parse_args(argv)
    from streammos_tpu_torch.serve import resolve_device
    from streammos_tpu_torch.utils.logging import config_logger

    resolve_device(args.device)  # fail before any work without a card
    cfg = eval_config(args)
    logger = config_logger(os.path.join("experiments", cfg.name, args.tag,
                                        "log_val.txt"))
    return run_eval(cfg, args, cfg.freeze_except is not None, logger)


if __name__ == "__main__":
    main()
