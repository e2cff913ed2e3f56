"""Semantic-view assets (reference `semantic_views/`).

Counterpart of ``dasa_tpu/data/semantic.py``, a copy.

The reference ships a sample of per-viewpoint semantic renderings —
36 color-coded PNGs (one per discretized view) plus matching RGB JPGs —
and a 42-class `label2color.json` palette (SURVEY.md L0).  Training
never consumes them in the reference either; this loader makes the
assets usable for raw-pixel / semantic-feature work: palette parsing,
color->label-id decoding, and the 36-view stack layout.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

VIEWS = 36


def load_label2color(path: str) -> Dict[str, Tuple[int, int, int]]:
    """`label2color.json`: {label: {R, G, B}} -> {label: (r, g, b)}."""
    with open(path) as f:
        raw = json.load(f)
    return {label: (int(c["R"]), int(c["G"]), int(c["B"]))
            for label, c in raw.items()}


class SemanticPalette:
    """Bidirectional label <-> color <-> id mapping.  Label ids follow
    the palette's insertion order (json preserves it), so id 0 is the
    reference's 'void'."""

    def __init__(self, label2color: Dict[str, Tuple[int, int, int]]):
        self.labels: List[str] = list(label2color)
        self.colors = np.array([label2color[l] for l in self.labels],
                               np.int32)
        # pack (r, g, b) -> 24-bit key for O(1) decode
        keys = (self.colors[:, 0] << 16) | (self.colors[:, 1] << 8) \
            | self.colors[:, 2]
        self._key2id = {int(k): i for i, k in enumerate(keys)}

    def __len__(self) -> int:
        return len(self.labels)

    def label_id(self, label: str) -> int:
        return self.labels.index(label)

    def decode(self, rgb: np.ndarray,
               unknown: int = -1) -> np.ndarray:
        """(H, W, 3) uint8 color render -> (H, W) int32 label ids
        (`unknown` for colors outside the palette — e.g. antialiased
        edge pixels in the committed renders)."""
        rgb = np.asarray(rgb).astype(np.int64)
        keys = (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]
        out = np.full(keys.shape, unknown, np.int32)
        for k, i in self._key2id.items():
            out[keys == k] = i
        return out


def semantic_view_paths(root: str, scan: str, viewpoint: str,
                        rgb: bool = False) -> List[str]:
    """The 36 per-view files in view-index order (0..35; PNG semantic
    renders, or the matching `<viewpoint>_rgb/` JPGs)."""
    sub = f"{viewpoint}_rgb" if rgb else viewpoint
    ext = "jpg" if rgb else "png"
    d = os.path.join(root, scan, sub)
    return [os.path.join(d, f"{i}.{ext}") for i in range(VIEWS)]


def load_semantic_views(root: str, scan: str, viewpoint: str,
                        palette: Optional[SemanticPalette] = None,
                        views: Optional[List[int]] = None) -> np.ndarray:
    """Load the viewpoint's semantic renders: (V, H, W, 3) uint8, or
    (V, H, W) int32 label ids when a palette is given."""
    from PIL import Image

    paths = semantic_view_paths(root, scan, viewpoint)
    if views is not None:
        paths = [paths[i] for i in views]
    imgs = np.stack([np.asarray(Image.open(p).convert("RGB"))
                     for p in paths])
    if palette is None:
        return imgs
    return np.stack([palette.decode(im) for im in imgs])


def list_semantic_viewpoints(root: str, scan: str) -> List[str]:
    """Viewpoints with semantic renders under `root/scan/`."""
    d = os.path.join(root, scan)
    if not os.path.isdir(d):
        return []
    return sorted(v for v in os.listdir(d)
                  if not v.endswith("_rgb")
                  and os.path.isdir(os.path.join(d, v)))
