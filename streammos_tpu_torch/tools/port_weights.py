"""Import a reference StreamMOS checkpoint (a torch ``.pth`` state dict, as
the original trainer saves it, the published pretrained model included)
as a checkpoint of the port:

    python -m streammos_tpu_torch.tools.port_weights --pth 10-model.pth \
        --out experiments/StreamMOS_seg/ported/checkpoint --epoch 10

Counterpart of `tools/port_weights.py` of the JAX package. The port's
modules carry the reference's key names, so the dict loads as it is: a
``state_dict`` wrapper is unwrapped, ``module.`` prefixes are stripped, the
stage-2 refine head is detected from its ``refine.*`` keys, and the dict is
loaded into a model built on the CPU (`weights.load_state_dict_checked`,
which drops the reference's dead keys and refuses any other mismatch).
Writes ``<out>/<epoch:04d>/state.pt`` in the layout of
`train/checkpoint.py`, which ``tools.val --checkpoint <out> --epoch N`` and
``tools.train --checkpoint <out> --ckpt-epoch N`` (stage 2) read.
"""
from __future__ import annotations

import argparse
import pickle


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="reference .pth -> port "
                                             "checkpoint")
    ap.add_argument("--pth", required=True, help="reference state_dict .pth")
    ap.add_argument("--out", required=True, help="output checkpoint dir")
    ap.add_argument("--epoch", type=int, default=0)
    ap.add_argument("--config", default="StreamMOS")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from streammos_tpu_torch.config import get_config
    from streammos_tpu_torch.models.stream_mos import StreamMOSNet
    from streammos_tpu_torch.train.checkpoint import save_model_state
    from streammos_tpu_torch.weights import load_state_dict_checked

    try:
        sd = torch.load(args.pth, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise SystemExit(f"{args.pth}: not a state_dict ({e})")
    if not isinstance(sd, dict):
        raise SystemExit(f"{args.pth}: expected a state_dict")
    if "state_dict" in sd:  # tolerate {'state_dict': ...} wrappers
        sd = sd["state_dict"]
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    if not all(isinstance(v, torch.Tensor) for v in sd.values()):
        raise SystemExit(f"{args.pth}: expected a state_dict of tensors")

    with_refine = any(k.startswith("refine.") for k in sd)
    model = StreamMOSNet(get_config(args.config).model,
                         with_refine=with_refine)
    try:
        load_state_dict_checked(model, sd)
    except (KeyError, RuntimeError) as e:
        raise SystemExit(f"structure mismatch:\n{e}")

    n = sum(p.numel() for p in model.parameters())
    path = save_model_state(args.out, args.epoch, model.state_dict())
    print(f"ported {len(sd)} torch keys -> {n / 1e6:.3f}M params "
          f"(refine={with_refine}) at {path}")
    return path


if __name__ == "__main__":
    main()
