"""Train/test splits of the SynMirror tree, the port's copy of
`reflecting_reality_tpu/tools/create_splits.py` (reference:
examples/brushnet/create_train_splits.ipynb): train.csv/test.csv indexes
over the SynMirror tree, grouped by object uid so all camera views of an
object land in the same split.

Usage:
  python -m reflecting_reality_tpu_torch.tools.create_splits --data_dir <dir> \
    [--test_fraction 0.1] [--seed 42] [--captions_csv captions.csv]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_index(data_dir: str):
    rows = []
    for root, _, names in os.walk(data_dir):
        for n in sorted(names):
            if not n.endswith(".hdf5"):
                continue
            rel = os.path.relpath(os.path.join(root, n), data_dir)
            uid = os.path.basename(os.path.dirname(rel)) or os.path.splitext(n)[0]
            rows.append({"uid": uid, "path": rel})
    return rows


def main(argv=None):
    import pandas as pd

    p = argparse.ArgumentParser(description="Build SynMirror train/test csv splits")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--test_fraction", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--captions_csv", type=str, default=None,
                   help="optional csv with uid,auto_caption columns to join")
    p.add_argument("--caption_column", type=str, default="auto_caption")
    args = p.parse_args(argv)

    rows = build_index(args.data_dir)
    df = pd.DataFrame(rows)
    if args.captions_csv:
        caps = pd.read_csv(args.captions_csv)
        df = df.merge(caps[["uid", args.caption_column]], on="uid", how="left")
        df[args.caption_column] = df[args.caption_column].fillna("")
    else:
        df[args.caption_column] = ""

    # group split by object uid: all cameras of an object share a split
    uids = sorted(df["uid"].unique())
    rng = np.random.RandomState(args.seed)
    rng.shuffle(uids)
    n_test = max(1, int(len(uids) * args.test_fraction))
    test_uids = set(uids[:n_test])
    test_df = df[df["uid"].isin(test_uids)]
    train_df = df[~df["uid"].isin(test_uids)]

    train_df.to_csv(os.path.join(args.data_dir, "train.csv"), index=False)
    test_df.to_csv(os.path.join(args.data_dir, "test.csv"), index=False)
    print(f"{len(train_df)} train / {len(test_df)} test rows "
          f"({len(uids) - n_test}/{n_test} objects)")


if __name__ == "__main__":
    main()
