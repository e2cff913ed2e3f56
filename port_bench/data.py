"""The benchmark's inputs, made from the seed: the world's connectivity,
the R2R-format items or CVDN-format dialogs, the vocabulary, the two
feature tables and the policy's weights.

The raw files (connectivity JSON, items, vocab) are what both the program
and the reference read.  The feature tables and the weights are made on
the device in one draw each and handed to both.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# the words of the instructions and dialogs (every one in the vocab)
WORDS = ("walk", "go", "turn", "left", "right", "past", "the", "door",
         "stairs", "kitchen", "hall", "table", "couch", "stop", "at",
         "bedroom", "window", "into", "up", "down", "and", "straight",
         "wait", "near", "lamp", "rug", "through", "exit", "enter", "room",
         "bathroom", "sink", "bed", "chair", "painting", "then", "where",
         "is", "it", "should", "i", "yes", "no", "keep", "walking", "a",
         "on", "your", "of", "to", "in", "by", "out", "around", "next",
         "first", "second", "hallway", "doorway", "plant", "mirror",
         "shelf", "railing", "counter")
BASE_VOCAB = ("<PAD>", "<UNK>", "<EOS>")
NDH_TAGS = ("<", ">", "nav", "ora", "tar")


def scan_ids(n: int) -> List[str]:
    return [f"scan{i:03d}" for i in range(n)]


def write_connectivity(out_dir: str, scans: Sequence[str], n_nodes: int,
                       rng: np.random.Generator) -> None:
    """One floor-plan graph a scan: viewpoints on a jittered grid 2 m
    apart, each joined to its grid neighbours (diagonals included)."""
    os.makedirs(out_dir, exist_ok=True)
    cols = int(np.ceil(np.sqrt(n_nodes * 1.6)))
    grid = np.array([(i % cols, i // cols) for i in range(n_nodes)],
                    np.float64)
    gap = np.abs(grid[:, None, :] - grid[None, :, :]).max(-1)
    adj = (gap == 1).tolist()
    for scan in scans:
        pos = np.zeros((n_nodes, 3))
        pos[:, :2] = grid * 2.0 + rng.uniform(-0.4, 0.4, (n_nodes, 2))
        pos[:, 2] = 1.5 + rng.uniform(-0.05, 0.05, n_nodes)
        entries = []
        for i in range(n_nodes):
            pose = np.eye(4)
            pose[:3, 3] = pos[i]
            entries.append({"image_id": f"{scan}vp{i:04d}",
                            "pose": pose.reshape(-1).tolist(),
                            "included": True, "unobstructed": adj[i],
                            "height": float(pos[i, 2])})
        with open(os.path.join(out_dir, f"{scan}_connectivity.json"),
                  "w") as f:
            json.dump(entries, f)


def _hops(n_nodes: int) -> np.ndarray:
    """Hop counts between grid nodes: the grid's Chebyshev distance."""
    cols = int(np.ceil(np.sqrt(n_nodes * 1.6)))
    grid = np.array([(i % cols, i // cols) for i in range(n_nodes)])
    return np.abs(grid[:, None, :] - grid[None, :, :]).max(-1)


def sample_paths(scans: Sequence[str], n_nodes: int, n_paths: int,
                 hops: Sequence[int], rng: np.random.Generator,
                 shortest) -> List[dict]:
    """``n_paths`` (scan, node path, heading) with a hop count in the
    inclusive range ``hops``; ``shortest(scan, a, b)`` is the node path."""
    hop = _hops(n_nodes)
    out = []
    for _ in range(n_paths):
        scan = scans[int(rng.integers(len(scans)))]
        while True:
            a = int(rng.integers(n_nodes))
            want = int(rng.integers(hops[0], hops[1] + 1))
            ends = np.nonzero(hop[a] == want)[0]
            if len(ends):
                break
        b = int(ends[int(rng.integers(len(ends)))])
        out.append({"scan": scan, "path": shortest(scan, a, b),
                    "heading": float(rng.uniform(0.0, 2.0 * np.pi))})
    return out


class Sentences:
    """Sentences of seeded words, drawn in one block."""

    def __init__(self, rng: np.random.Generator, lengths: np.ndarray):
        self.words = np.asarray(WORDS)[rng.integers(len(WORDS),
                                                    size=int(lengths.sum()))]
        self.ends = np.cumsum(lengths)

    def __getitem__(self, i: int) -> str:
        start = self.ends[i - 1] if i else 0
        return " ".join(self.words[start:self.ends[i]])


def write_task(root: str, traffic: dict, seed: int) -> dict:
    """Write the world and the split of ``traffic`` under ``root``;
    returns the paths and sizes both sides read."""
    from port_bench.reference.world import Graph

    rng = np.random.default_rng(seed)
    world = traffic["world"]
    conn = os.path.join(root, "connectivity")
    data = os.path.join(root, "task")
    os.makedirs(data, exist_ok=True)
    scans = scan_ids(world["scans"])
    write_connectivity(conn, scans, world["viewpoints"], rng)
    graphs: Dict[str, Graph] = {}

    def shortest(scan, a, b):
        g = graphs.get(scan)
        if g is None:
            g = graphs[scan] = Graph(os.path.join(
                conn, f"{scan}_connectivity.json"))
        path = [a]
        while path[-1] != b:
            path.append(int(g.next_hop[path[-1], b]))
        return [g.ids[i] for i in path]

    split = traffic["split"]
    paths = sample_paths(scans, world["viewpoints"], split["paths"],
                         split["hops"], rng, shortest)
    lo, hi = split["words"]
    if traffic["task"] == "ndh":
        # turns of lo..hi words (and a 3-token tag each) until the dialog
        # holds dialog_words tokens
        n_turns = int(np.ceil(split["dialog_words"] / (lo + 3))) + 1
        lengths = rng.integers(lo, hi + 1, size=(len(paths), n_turns))
        text = Sentences(rng, lengths.reshape(-1))
        items = []
        for i, p in enumerate(paths):
            turns, words = [], 0
            while words < split["dialog_words"]:
                j = len(turns)
                turns.append({"nav_idx": j // 2,
                              "role": "navigator" if j % 2 == 0 else "oracle",
                              "message": text[i * n_turns + j]})
                words += int(lengths[i, j]) + 3
            items.append({"inst_idx": i, "scan": p["scan"],
                          "target": WORDS[i % len(WORDS)],
                          "start_pano": {"pano": p["path"][0],
                                         "heading": p["heading"]},
                          "dialog_history": turns,
                          "planner_path": p["path"],
                          "player_path": p["path"],
                          "nav_steps": p["path"]})
        name = f"NDH_{split['name']}.json"
    else:
        n = split["instructions"]
        text = Sentences(rng, rng.integers(lo, hi + 1, size=len(paths) * n))
        items = [{"path_id": i, "scan": p["scan"], "path": p["path"],
                  "heading": p["heading"], "distance": 0.0,
                  "instructions": [text[i * n + j] for j in range(n)]}
                 for i, p in enumerate(paths)]
        name = f"R2R_{split['name']}.json"
    with open(os.path.join(data, name), "w") as f:
        json.dump(items, f)
    vocab = list(BASE_VOCAB) + sorted(set(WORDS) | set(NDH_TAGS))
    with open(os.path.join(data, "train_vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    feature_ids = [f"{s}_{s}vp{i:04d}" for s in scans
                   for i in range(world["viewpoints"])]
    return {"connectivity": conn, "data": data, "scans": scans,
            "items_file": os.path.join(data, name), "vocab": vocab,
            "feature_ids": feature_ids}


def ndh_to_r2r(items: Sequence[dict]) -> List[dict]:
    """CVDN dialogs as R2R items: the trusted path (the planner's where the
    player reached its end, else the player's) and the whole dialog
    history with its tags as the instruction."""
    out = []
    for item in items:
        planner, player = item["planner_path"], item["player_path"]
        path = planner if player and player[-1] == planner[-1] else player
        parts = [f"{'<NAV>' if t['role'] == 'navigator' else '<ORA>'} "
                 f"{t['message']}" for t in item["dialog_history"]]
        parts.append(f"<TAR> {item['target']}")
        out.append({"scan": item["scan"], "path_id": item["inst_idx"],
                    "path": list(path),
                    "heading": float(item["start_pano"]["heading"]),
                    "instructions": [" ".join(parts)]})
    return out


def feature_tables(n_rows: int, views: int, dim: int, seed: int, device,
                   dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ResNet and the depth table: non-negative (ReLU of a standard
    normal), one draw a table on the device."""
    gen = torch.Generator(device=device)
    out = []
    for salt in (0, 1):
        gen.manual_seed(seed * 4 + salt)
        t = torch.randn((n_rows, views, dim), generator=gen, device=device,
                        dtype=torch.float32 if dtype == torch.float32
                        else dtype)
        out.append(t.relu_())
    return out[0], out[1]


def weights(shapes: Dict[str, Tuple[int, ...]], seed: int,
            device) -> Dict[str, torch.Tensor]:
    """The policy's weights from the seed, in one draw on the device:
    U(-1, 1) / sqrt(last dim) for every tensor, LayerNorm scales 1 and
    shifts 0, and the LSTMs' second biases 0 (they are held at 0)."""
    names = sorted(shapes)
    sizes = [int(np.prod(shapes[n])) for n in names]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 4 + 2)
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out, off = {}, 0
    for name, size in zip(names, sizes):
        shape = shapes[name]
        t = flat[off:off + size].view(shape)
        off += size
        leaf = name.rsplit(".", 1)
        norm = "LayerNorm" in name or "layer_norm" in name
        if norm and leaf[-1] == "weight":
            t = torch.ones_like(t)
        elif (norm and leaf[-1] == "bias") or "bias_hh" in leaf[-1]:
            t = torch.zeros_like(t)
        else:
            t = t / float(np.sqrt(shape[-1]))
        out[name] = t.clone()
    return out
