"""Panorama feature stores.

A :class:`FeatureDB` maps ``scan_viewpoint`` long-ids to rows of a dense
``(rows, 36, dim)`` table.  On TPU the table lives device-resident and the
hot loop sends only int32 row indices — the reference instead re-builds
(B, 36, 2176) float arrays on host every step and ships them over PCIe
(r2r_src/agent_dg.py:286-323).

Supported sources:
- ``.npz``       — our native format: {ids, values}
- ``.npy`` pair  — reference mini/depth format: viewpointIds.npy keys +
                   values.npy (r2r_src/env.py:22-31, utils.py:289-295)
- ``.tsv``       — reference base64 TSV (utils.py:272-312)
- bottom-up dir  — reference h5 bottom-up store: one ``<scan>/<vp>.h5``
                   per viewpoint, 36 view groups of (boxes, dim) region
                   features mean-pooled per view
                   (tasks/R2R/feature.py:89-116)
- ``a+b``        — per-viewpoint feature concatenation of two stores
                   (tasks/R2R/feature.py:27-46, ResNet+bottom-up)
- synthetic      — deterministic per-viewpoint random features so the
                   full stack runs without the 4 GB feature downloads
"""

from __future__ import annotations

import base64
import csv
import sys
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np


class FeatureDB:
    def __init__(self, ids: Sequence[str], values: np.ndarray):
        assert len(ids) == values.shape[0]
        self.ids = list(ids)
        self.values = values                      # (rows, views, dim)
        self.id2row: Dict[str, int] = {v: i for i, v in enumerate(self.ids)}

    @property
    def num_rows(self) -> int:
        return self.values.shape[0]

    @property
    def views(self) -> int:
        return self.values.shape[1]

    @property
    def dim(self) -> int:
        return self.values.shape[2]

    def row(self, scan: str, viewpoint: str) -> int:
        return self.id2row[f"{scan}_{viewpoint}"]

    def get(self, scan: str, viewpoint: str) -> np.ndarray:
        return self.values[self.row(scan, viewpoint)]

    @property
    def scans(self) -> set:
        return {k.split("_")[0] for k in self.ids}

    def save(self, path: str) -> None:
        np.savez(path, ids=np.asarray(self.ids), values=self.values)

    # -- constructors --
    @staticmethod
    def from_npz(path: str) -> "FeatureDB":
        z = np.load(path, allow_pickle=False)
        return FeatureDB([str(s) for s in z["ids"]], z["values"])

    @staticmethod
    def from_npy_pair(index_path: str, value_path: str) -> "FeatureDB":
        ids = [str(s) for s in np.load(index_path)]
        values = np.load(value_path)
        return FeatureDB(ids, values)

    @staticmethod
    def from_tsv(path: str, views: int = 36) -> "FeatureDB":
        csv.field_size_limit(sys.maxsize)
        fieldnames = ["scanId", "viewpointId", "image_w", "image_h", "vfov",
                      "features"]
        ids: List[str] = []
        rows: List[np.ndarray] = []
        with open(path) as f:
            for item in csv.DictReader(f, delimiter="\t",
                                       fieldnames=fieldnames):
                ids.append(item["scanId"] + "_" + item["viewpointId"])
                rows.append(
                    np.frombuffer(
                        base64.b64decode(item["features"].encode("ascii")),
                        dtype=np.float32,
                    ).reshape((views, -1))
                )
        return FeatureDB(ids, np.stack(rows))

    @staticmethod
    def from_zip(path: str, views: int = 36) -> "FeatureDB":
        """Zip-backed feature store (reference tasks/R2R/zipdata.py:1-89
        serves pretraining images from a zip to dodge small-file IO; here
        the members are one .npy per viewpoint named
        ``<scan>_<viewpoint>.npy``, or a single ids.npy/values.npy
        pair)."""
        import io
        import zipfile

        with zipfile.ZipFile(path) as zf:
            names = sorted(n for n in zf.namelist()
                           if n.endswith(".npy"))
            base: dict = {}
            for n in names:
                stem = n.rsplit("/", 1)[-1]
                if stem in base:
                    raise ValueError(
                        f"duplicate member basename {stem!r} in {path} "
                        f"({base[stem]} vs {n}): viewpoint ids must be "
                        f"unique across zip subdirectories")
                base[stem] = n
            if "ids.npy" in base and "values.npy" in base:
                ids = [str(s) for s in np.load(
                    io.BytesIO(zf.read(base["ids.npy"])))]
                values = np.load(io.BytesIO(zf.read(base["values.npy"])))
            else:
                ids, rows = [], []
                for name in names:
                    ids.append(name.rsplit("/", 1)[-1][: -len(".npy")])
                    rows.append(np.load(io.BytesIO(zf.read(name))))
                values = np.stack(rows)
            if values.shape[1] != views:
                raise ValueError(
                    f"{path}: expected {views} views per viewpoint, "
                    f"got {values.shape[1]}")
            return FeatureDB(ids, values)

    @staticmethod
    def from_bottom_up(root: str, views: int = 36) -> "FeatureDB":
        """Bottom-up-attention h5 store (tasks/R2R/feature.py:89-116):
        ``<root>/<scan>/<viewpoint>.h5`` with 36 groups keyed "0".."35",
        each holding (num_boxes, dim) region ``features`` that are
        mean-pooled into one vector per view."""
        import os

        import h5py

        ids: List[str] = []
        rows: List[np.ndarray] = []
        for scan in sorted(os.listdir(root)):
            folder = os.path.join(root, scan)
            if not os.path.isdir(folder):
                continue
            for fname in sorted(os.listdir(folder)):
                if not fname.endswith(".h5"):
                    continue
                with h5py.File(os.path.join(folder, fname), "r") as f:
                    if len(f.keys()) != views:
                        raise ValueError(
                            f"{folder}/{fname}: expected {views} view "
                            f"groups, got {len(f.keys())}")
                    pooled = np.stack([
                        np.asarray(f[str(v)]["features"][()],
                                   np.float32).mean(0)
                        for v in range(views)])
                ids.append(f"{scan}_{fname[:-len('.h5')]}")
                rows.append(pooled)
        if not ids:
            raise ValueError(f"no <scan>/<viewpoint>.h5 files under "
                             f"{root}")
        return FeatureDB(ids, np.stack(rows))

    @staticmethod
    def concat(a: "FeatureDB", b: "FeatureDB") -> "FeatureDB":
        """Per-viewpoint feature concatenation over the shared long-ids
        (tasks/R2R/feature.py:27-46 hstacks ResNet + bottom-up rows)."""
        if a.views != b.views:
            raise ValueError(f"view mismatch: {a.views} vs {b.views}")
        ids = [i for i in a.ids if i in b.id2row]
        if not ids:
            raise ValueError("no shared viewpoint ids between stores")
        rows_a = a.values[[a.id2row[i] for i in ids]]
        rows_b = b.values[[b.id2row[i] for i in ids]]
        return FeatureDB(ids, np.concatenate([rows_a, rows_b], axis=-1))

    @staticmethod
    def synthetic(scans: Sequence[str], connectivity_dir: str,
                  dim: int = 2048, views: int = 36, salt: int = 0,
                  scale: float = 1.0) -> "FeatureDB":
        """Deterministic pseudo-features for the included viewpoints of the
        given scans.  Each viewpoint's feature block is seeded from a CRC
        of its long-id, so values are stable across runs/processes."""
        from dasa_tpu_torch.sim.graph import load_scan_graph

        ids: List[str] = []
        blocks: List[np.ndarray] = []
        for scan in sorted(set(scans)):
            g = load_scan_graph(scan, connectivity_dir)
            for i in np.nonzero(g.included)[0]:
                long_id = f"{scan}_{g.ids[int(i)]}"
                seed = zlib.crc32(long_id.encode()) ^ salt
                rng = np.random.default_rng(seed)
                # ReLU-like nonnegative features, matching ResNet pool stats
                feat = rng.standard_normal((views, dim), dtype=np.float32)
                feat = np.maximum(feat, 0.0) * scale
                ids.append(long_id)
                blocks.append(feat)
        return FeatureDB(ids, np.stack(blocks))


def load_feature_db(path: Optional[str], scans: Sequence[str],
                    connectivity_dir: str, dim: int = 2048,
                    views: int = 36, salt: int = 0) -> FeatureDB:
    """Dispatch on path type; None => synthetic."""
    if path is None or path == "synthetic":
        return FeatureDB.synthetic(scans, connectivity_dir, dim=dim,
                                   views=views, salt=salt)
    if path.endswith(".npz"):
        return FeatureDB.from_npz(path)
    if path.endswith(".tsv"):
        return FeatureDB.from_tsv(path, views=views)
    if path.endswith(".npy"):
        base = path[: -len(".npy")]
        return FeatureDB.from_npy_pair(base + "-index.npy", path)
    if path.endswith(".zip"):
        return FeatureDB.from_zip(path, views=views)
    if "+" in path:
        # composite store "a+b" (tasks/R2R/feature.py:27-46)
        parts = path.split("+")
        db = load_feature_db(parts[0], scans, connectivity_dir,
                             dim=dim, views=views, salt=salt)
        for part in parts[1:]:
            db = FeatureDB.concat(db, load_feature_db(
                part, scans, connectivity_dir, dim=dim, views=views,
                salt=salt))
        return db
    import os

    if os.path.isdir(path):
        return FeatureDB.from_bottom_up(path, views=views)
    raise ValueError(f"unrecognized feature store: {path}")
