"""Synthetic navigation worlds for tests and smoke runs, and the CPU
test suite's thread setting.

The R2R connectivity graphs are not redistributable with this repository,
so tests and ``chip_smoke.py`` write small worlds of their own in the same
``<scan>_connectivity.json`` format that ``sim/graph.py:load_scan_graph``
reads: one entry per viewpoint with ``image_id``, a flat row-major 4x4
``pose`` whose translation sits at indices 3, 7 and 11, ``included``,
``unobstructed`` (the adjacency row) and ``height``.
:func:`write_ndh_task` writes CVDN-format NDH dialogs over such a world,
:func:`write_feature_tsv` a feature store in the reference's TSV layout.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Sequence

import numpy as np


def write_synthetic_connectivity(out_dir: str, scans: Sequence[str],
                                 n_nodes: int = 40, seed: int = 0) -> None:
    """Write one connected floor-plan graph per scan into ``out_dir``.

    Viewpoints sit on a jittered grid 2 m apart, each joined to its
    grid neighbours (diagonals included), so every node has 3 to 8
    candidates and shortest paths run up to a dozen hops — the range
    ``generate_synthetic_dataset`` samples its 3-6 hop paths from.
    Scan ids must not contain "_" (feature long-ids split on it)."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    cols = int(np.ceil(np.sqrt(n_nodes * 1.6)))
    for scan in scans:
        if "_" in scan:
            raise ValueError(f"scan id {scan!r} must not contain '_'")
        grid = np.array([(i % cols, i // cols) for i in range(n_nodes)],
                        np.float64)
        pos = np.zeros((n_nodes, 3))
        pos[:, :2] = grid * 2.0 + rng.uniform(-0.4, 0.4, (n_nodes, 2))
        pos[:, 2] = 1.5 + rng.uniform(-0.05, 0.05, n_nodes)
        gap = np.abs(grid[:, None, :] - grid[None, :, :]).max(-1)
        adj = gap == 1
        entries = []
        for i in range(n_nodes):
            pose = np.eye(4)
            pose[:3, 3] = pos[i]
            entries.append({
                "image_id": f"{scan}vp{i:04d}",
                "pose": [float(v) for v in pose.reshape(-1)],
                "included": True,
                "unobstructed": [bool(v) for v in adj[i]],
                "height": float(pos[i, 2]),
            })
        with open(os.path.join(out_dir, f"{scan}_connectivity.json"),
                  "w") as f:
            json.dump(entries, f)


# the words of the synthetic dialogs
_DIALOG_WORDS = ("go", "turn", "left", "right", "past", "the", "door", "stairs",
                 "kitchen", "hall", "table", "couch", "where", "is", "it",
                 "near", "bedroom", "then", "stop", "window", "up", "down",
                 "should", "i", "yes", "no", "keep", "walking", "straight")


def write_ndh_task(data_dir: str, train_scans: Sequence[str],
                   unseen_scans: Sequence[str], connectivity_dir: str,
                   n_train: int = 8, n_val: int = 4, dialog_words: int = 120,
                   seed: int = 0) -> None:
    """Write ``NDH_{train,val_seen,val_unseen}.json`` in the CVDN format
    that ``data/ndh.py:convert_ndh_items`` reads: ``inst_idx``, ``scan``,
    ``target``, ``start_pano`` {pano, heading}, ``dialog_history`` (turns
    of navigator questions and oracle answers), ``planner_path``,
    ``player_path`` and ``nav_steps``.  The paths are the synthetic
    world's 3-6 hop shortest paths; every other item's player stopped a
    node short (so ``trusted_path`` takes the player's path there).  The
    dialog turns hold about ``dialog_words`` words in all, which with the
    ``all`` history's tags gives an instruction of about that many
    tokens."""
    from dasa_tpu_torch.data.datasets import generate_synthetic_dataset

    rng = np.random.default_rng(seed)
    splits = {"train": (train_scans, n_train, 0),
              "val_seen": (train_scans, n_val, 100000),
              "val_unseen": (unseen_scans, n_val, 200000)}
    os.makedirs(data_dir, exist_ok=True)
    for i, (split, (scans, n, base)) in enumerate(splits.items()):
        items = generate_synthetic_dataset(scans, n, connectivity_dir,
                                           seed=seed + i, path_id_base=base)
        out = []
        for j, item in enumerate(items):
            path = item["path"]
            player = path[:-1] if j % 2 and len(path) > 2 else list(path)
            turns, words = [], 0
            while words < dialog_words:
                n_words = int(rng.integers(4, 16))
                role = "navigator" if len(turns) % 2 == 0 else "oracle"
                turns.append({"nav_idx": len(turns) // 2, "role": role,
                              "message": " ".join(
                                  rng.choice(_DIALOG_WORDS, n_words))})
                words += n_words + 1
            out.append({
                "inst_idx": item["path_id"], "scan": item["scan"],
                "target": str(rng.choice(_DIALOG_WORDS)),
                "start_pano": {"pano": path[0],
                               "heading": item["heading"]},
                "dialog_history": turns, "planner_path": list(path),
                "player_path": player, "nav_steps": list(player)})
        with open(os.path.join(data_dir, f"NDH_{split}.json"), "w") as f:
            json.dump(out, f)


def write_feature_tsv(db, path: str) -> None:
    """Write a ``data/features.py:FeatureDB`` in the reference's TSV layout
    (ResNet-152-imagenet.tsv, which ``FeatureDB.from_tsv`` reads): scan,
    viewpoint, image_w, image_h, vfov and the base64 of the (views, dim)
    float32 features, a viewpoint a line."""
    import base64

    with open(path, "w") as f:
        for long_id, values in zip(db.ids, db.values):
            scan, vp = long_id.split("_", 1)
            blob = base64.b64encode(np.ascontiguousarray(
                values, np.float32).tobytes()).decode("ascii")
            f.write(f"{scan}\t{vp}\t640\t480\t60\t{blob}\n")


@contextlib.contextmanager
def torch_threads(n: int):
    """Run the block with ``n`` intra-op torch threads, then restore the
    count.  The CPU test suite runs in parallel worker processes on a few
    cores: its tiny-width ops gain nothing from more threads, and each
    worker's idle threads spinning on every core slow all the others."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)
