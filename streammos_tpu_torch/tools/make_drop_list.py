"""Generate the dynamic-point-count frame list used by
``drop_few_static_frames``.

Counterpart of `tools/make_drop_list.py` of the JAX package: a whitelist
of (seq, frame, #dynamic-points) lines that `TrainDataset` reads to drop
frames with few moving points, written from the labels by
`data/droplist.py:write_drop_list` (the train CLI also writes it when no
--drop-list is given):

    python -m streammos_tpu_torch.tools.make_drop_list --data /path/sequences \
        --out train_split_dynamic_pointnumber.txt --min-dynamic 100
"""
from __future__ import annotations

import argparse

from streammos_tpu_torch.data.droplist import write_drop_list


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True)
    ap.add_argument("--out", default="train_split_dynamic_pointnumber.txt")
    ap.add_argument("--min-dynamic", type=int, default=100,
                    help="keep frames with at least this many moving points")
    args = ap.parse_args(argv)

    n_kept, n_total = write_drop_list(args.data, args.out, args.min_dynamic)
    print(f"kept {n_kept}/{n_total} frames -> {args.out}")


if __name__ == "__main__":
    main()
