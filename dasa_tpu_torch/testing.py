"""Synthetic navigation worlds for tests and smoke runs, and the CPU
test suite's thread setting.

The R2R connectivity graphs are not redistributable with this repository,
so tests and ``chip_smoke.py`` write small worlds of their own in the same
``<scan>_connectivity.json`` format that ``sim/graph.py:load_scan_graph``
reads: one entry per viewpoint with ``image_id``, a flat row-major 4x4
``pose`` whose translation sits at indices 3, 7 and 11, ``included``,
``unobstructed`` (the adjacency row) and ``height``.
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
