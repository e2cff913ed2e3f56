"""Generate a synthetic R2R-format task over the connectivity graphs
(stand-in for the non-redistributable R2R annotations; reference analog:
r2r_src/preprocess_mini_dataset.py):

    python -m dasa_tpu_torch.scripts.make_task --out data/task \
        --connectivity connectivity --train_scans 4 --unseen_scans 2 \
        --n_train 60 --n_val 20

The first ``train_scans`` scans of ``<connectivity>/scans.txt`` hold the
train, val_seen and aug splits, the next ``unseen_scans`` val_unseen.
``--connectivity`` defaults to the config's ``$DASA_CONNECTIVITY_DIR`` or
``./connectivity``.
"""

from __future__ import annotations

import argparse
import os

from dasa_tpu_torch.config import _default_connectivity_dir
from dasa_tpu_torch.data.datasets import make_synthetic_task


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="data/task")
    p.add_argument("--connectivity", default=_default_connectivity_dir())
    p.add_argument("--train_scans", type=int, default=4)
    p.add_argument("--unseen_scans", type=int, default=2)
    p.add_argument("--n_train", type=int, default=60)
    p.add_argument("--n_val", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    with open(os.path.join(args.connectivity, "scans.txt")) as f:
        scans = f.read().split()
    train_scans = scans[: args.train_scans]
    unseen = scans[args.train_scans: args.train_scans + args.unseen_scans]
    make_synthetic_task(args.out, train_scans, unseen,
                        n_train=args.n_train, n_val=args.n_val,
                        connectivity_dir=args.connectivity,
                        seed=args.seed)
    print(f"wrote synthetic task to {args.out}: train scans "
          f"{train_scans}, unseen {unseen}")


if __name__ == "__main__":
    main()
