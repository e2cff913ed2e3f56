"""R2R dataset loading and synthetic fixture generation.

`load_datasets` mirrors the reference loader (r2r_src/utils.py:84-126):
R2R_{split}.json files, `split@N` deterministic subsampling (seed 0,
additive), absolute paths passed straight through.

`generate_synthetic_dataset` builds R2R-format items by sampling shortest
paths through the *real* Matterport connectivity graphs and rendering
template instructions from the path geometry (turn directions + step
counts), so the full train/eval stack runs — and models can actually
learn — without the non-redistributable R2R annotations/features.  It
plays the role the reference's mini-dataset generator plays for fast
testing (r2r_src/preprocess_mini_dataset.py).
"""

from __future__ import annotations

import json
import math
import os
import random
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np

from dasa_tpu_torch.sim.graph import load_scan_graph


def load_datasets(splits: Sequence[str], data_dir: str = "data/task") -> List[dict]:
    data: List[dict] = []
    old_state = random.getstate()
    for split in splits:
        components = split.split("@")
        number = -1
        if len(components) > 1:
            split, number = components[0], int(components[1])
        filename = split if "/" in split else os.path.join(
            data_dir, f"R2R_{split}.json")
        with open(filename) as f:
            new_data = json.load(f)
        if number > 0:
            random.seed(0)
            random.shuffle(new_data)
            new_data = new_data[:number]
        data += new_data
    random.setstate(old_state)
    return data


def expand_instructions(data: List[dict], tokenizer=None,
                        max_input: Optional[int] = None) -> List[dict]:
    """Split each item's 3 instructions into separate entries with
    instr_id '{path_id}_{j}' (reference: r2r_src/env.py:137-154)."""
    out = []
    for item in data:
        for j, instr in enumerate(item["instructions"]):
            new_item = dict(item)
            new_item["instr_id"] = "%s_%d" % (item["path_id"], j)
            new_item["instructions"] = instr
            if tokenizer is not None:
                enc = tokenizer.encode_sentence(instr, max_length=max_input)
                if enc is None:
                    continue
                new_item["instr_encoding"] = enc
            out.append(new_item)
    return out


def expand_instruction_groups(data: List[dict], tokenizer=None,
                              max_input: Optional[int] = None,
                              n_sentences: int = 3) -> List[dict]:
    """Multi* 3-instruction mode: one item per n_sentences-combination
    of an item's instructions, with `instr_encoding` stacked to
    (n_sentences, L) (reference tasks/R2R/env.py:475-490 builds the
    combination groups consumed by the Multi* encoders).  Items with
    fewer than n_sentences instructions are skipped with a notice, like
    the reference's 'ignore path_id' print (env.py:468-470)."""
    from itertools import combinations

    out = []
    for item in data:
        instrs = item["instructions"]
        if len(instrs) < n_sentences:
            print(f"ignore path_id {item.get('path_id')} with only "
                  f"{len(instrs)} instructions")
            continue
        for k, perm in enumerate(combinations(range(len(instrs)),
                                              n_sentences)):
            new_item = dict(item)
            new_item["instr_id"] = "%s_%d" % (item["path_id"], k)
            new_item["instructions"] = [instrs[j] for j in perm]
            if tokenizer is not None:
                encs = [tokenizer.encode_sentence(instrs[j],
                                                  max_length=max_input)
                        for j in perm]
                if any(e is None for e in encs):
                    continue
                new_item["instr_encoding"] = np.stack(encs)
            out.append(new_item)
    return out


# ---------------------------------------------------------------------------
# Synthetic R2R-format data over the real navigation graphs
# ---------------------------------------------------------------------------

_TURN_WORDS = {
    "forward": ["go straight", "walk forward", "continue ahead"],
    "left": ["turn left and walk", "take a left", "go left"],
    "right": ["turn right and walk", "take a right", "go right"],
    "back": ["turn around and walk", "go back", "turn all the way around"],
}
_STOP_WORDS = ["stop there", "wait there", "you are done", "stop and wait"]
_LANDMARKS = [
    "doorway", "hallway", "table", "stairs", "window", "couch", "lamp",
    "counter", "rug", "shelf", "plant", "mirror", "painting", "railing",
]


def _bearing(p, q) -> float:
    d = q - p
    return math.atan2(d[0], d[1])


def _turn_kind(prev_bearing: float, new_bearing: float) -> str:
    d = math.atan2(math.sin(new_bearing - prev_bearing),
                   math.cos(new_bearing - prev_bearing))
    deg = math.degrees(d)
    if abs(deg) < 45:
        return "forward"
    if abs(deg) > 135:
        return "back"
    return "right" if deg > 0 else "left"


def _path_instruction(g, path: List[int], heading: float,
                      rng: random.Random) -> str:
    """Template instruction describing the path's turn sequence; landmarks
    are keyed deterministically to viewpoints so text correlates with the
    world and the task is learnable from synthetic features."""
    words = []
    bearing = heading
    for a, b in zip(path, path[1:]):
        nb = _bearing(g.pos[a], g.pos[b])
        kind = _turn_kind(bearing, nb)
        lm = _LANDMARKS[zlib.crc32(g.ids[b].encode()) % len(_LANDMARKS)]
        words.append("%s to the %s" % (rng.choice(_TURN_WORDS[kind]), lm))
        bearing = nb
    words.append(rng.choice(_STOP_WORDS))
    return ", ".join(words) + "."


def generate_synthetic_dataset(
    scans: Sequence[str],
    n_paths_per_scan: int = 30,
    connectivity_dir: str = "connectivity",
    seed: int = 0,
    min_hops: int = 3,
    max_hops: int = 6,
    path_id_base: int = 0,
) -> List[dict]:
    """R2R-format items: {scan, path_id, path, heading, distance,
    instructions[3]} with shortest paths of min_hops..max_hops hops."""
    rng = random.Random(seed)
    data: List[dict] = []
    path_id = path_id_base
    for scan in scans:
        g = load_scan_graph(scan, connectivity_dir)
        g.compute_shortest_paths()
        inc = np.nonzero(g.included)[0]
        # hop counts from a BFS over the unweighted adjacency
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import shortest_path as sp_unweighted

        adj = g.nav_adjacency()
        hop_d = sp_unweighted(csr_matrix(adj.astype(np.float64)),
                              method="D", unweighted=True, directed=False)
        for _ in range(n_paths_per_scan):
            for _try in range(50):
                src = int(rng.choice(inc))
                nh = hop_d[src]
                ok = np.nonzero(
                    (nh >= min_hops) & (nh <= max_hops) & g.included)[0]
                if len(ok) == 0:
                    continue
                dst = int(rng.choice(ok))
                path = g.shortest_path(src, dst)
                heading = rng.uniform(0, 2 * math.pi)
                item = {
                    "scan": scan,
                    "path_id": path_id,
                    "path": [g.ids[i] for i in path],
                    "heading": heading,
                    "distance": float(g.dist[src, dst]),
                    "instructions": [
                        _path_instruction(g, path, heading, rng)
                        for _ in range(3)
                    ],
                }
                data.append(item)
                path_id += 1
                break
    return data


def write_splits(data_by_split: Dict[str, List[dict]], data_dir: str) -> None:
    os.makedirs(data_dir, exist_ok=True)
    for split, data in data_by_split.items():
        with open(os.path.join(data_dir, f"R2R_{split}.json"), "w") as f:
            json.dump(data, f)


def make_synthetic_task(
    data_dir: str,
    train_scans: Sequence[str],
    unseen_scans: Sequence[str],
    n_train: int = 40,
    n_val: int = 10,
    connectivity_dir: str = "connectivity",
    seed: int = 0,
) -> None:
    """Write a 4-split synthetic task (train/val_seen/val_unseen/aug)."""
    train = generate_synthetic_dataset(
        train_scans, n_train, connectivity_dir, seed=seed)
    val_seen = generate_synthetic_dataset(
        train_scans, n_val, connectivity_dir, seed=seed + 1,
        path_id_base=100000)
    val_unseen = generate_synthetic_dataset(
        unseen_scans, n_val, connectivity_dir, seed=seed + 2,
        path_id_base=200000)
    aug = generate_synthetic_dataset(
        train_scans, n_train, connectivity_dir, seed=seed + 3,
        path_id_base=300000)
    write_splits(
        {"train": train, "val_seen": val_seen, "val_unseen": val_unseen,
         "aug": aug},
        data_dir,
    )
