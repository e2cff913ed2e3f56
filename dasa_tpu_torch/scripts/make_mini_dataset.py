"""Carve a mini dataset from R2R data and feature stores.

Equivalent of the reference's preprocess_mini_dataset.py: filters each
split to the items of a single scan (capped at ``--max_items``) and subsets
the image / depth feature stores to those scans, so the whole train and
validation loop runs in minutes (read back through ``--data_dir`` /
``--img_features_path``):

    python -m dasa_tpu_torch.scripts.make_mini_dataset --data_dir data/task \
        --features data/img_features.npz --out data/mini
"""

from __future__ import annotations

import argparse
import json
import os

from dasa_tpu_torch.data.datasets import load_datasets
from dasa_tpu_torch.data.features import FeatureDB


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", required=True)
    p.add_argument("--features", default=None)
    p.add_argument("--dfeatures", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--max_items", type=int, default=100)
    p.add_argument("--splits", nargs="+",
                   default=["train", "val_seen", "val_unseen"])
    args = p.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    scans = set()
    for split in args.splits:
        data = load_datasets([split], args.data_dir)
        scan = data[0]["scan"]
        mini = [d for d in data if d["scan"] == scan][: args.max_items]
        scans.add(scan)
        with open(os.path.join(args.out, f"R2R_{split}.json"), "w") as f:
            json.dump(mini, f)
        print(f"{split}: {len(mini)} items from scan {scan}")

    for name, path in (("img_features", args.features),
                       ("depth_features", args.dfeatures)):
        if path is None:
            continue
        db = FeatureDB.from_npz(path) if path.endswith(".npz") else \
            FeatureDB.from_tsv(path)
        keep = [i for i, lid in enumerate(db.ids)
                if lid.split("_")[0] in scans]
        sub = FeatureDB([db.ids[i] for i in keep], db.values[keep])
        sub.save(os.path.join(args.out, f"{name}.npz"))
        print(f"{name}: {len(keep)} viewpoints")


if __name__ == "__main__":
    main()
