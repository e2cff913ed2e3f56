"""Batched featurization of panorama views on the card.

Counterpart of ``dasa_tpu/pipelines/depth_features.py`` (the reference's
scripts/depth_feat_extractor.py): per viewpoint, 36 depth (or RGB) views
are min-max normalized (lines 29-31), replicated to 3 channels (line 67)
and pushed through ResNet-152 without its classifier (lines 33-40) to a
(36, 2048) block; the blocks of all viewpoints go to the
``{prefix}.npy`` + ``{prefix}-index.npy`` pair that ``data/features.py``'s
``FeatureDB`` reads (``depth_features_path``).

The network runs in bf16 on the card (f32 on the CPU), channels-last, in
batches of 36 views (one viewpoint); the 3-channel repeat of a depth view
happens on the device.  As a command::

    python -m dasa_tpu_torch.pipelines.depth_features \\
        --views_dir VIEWS --out PREFIX [--weights resnet152.pt]

featurizes every ``VIEWS/{scan}_{viewpoint}.npy`` (36 views, (36, H, W)
depth or (36, H, W, 3) RGB in [0, 1]) with ResNet-152, random from
``--seed`` unless ``--weights`` names a torchvision-named state_dict.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from dasa_tpu_torch.models.resnet import resnet152
from dasa_tpu_torch.utils.device import resolve_device


def normalize_depth(img: np.ndarray) -> np.ndarray:
    """Min-max normalization per view (depth_feat_extractor.py:29-31)."""
    rng = np.max(img) - np.min(img)
    return (img - np.min(img)) / (rng + 1e-6)


class ViewFeaturizer:
    """ResNet-152 forward producing (N, 2048) pooled features.

    Runs on CUDA unless ``device`` names another device; the convolutions
    run in ``dtype`` on the card and in f32 on the CPU.  The weights are
    ``state_dict`` (torchvision names; ``utils/jax_params.py:
    resnet_state_dict_from_jax`` makes one from the JAX module's
    variables) or random from ``seed``."""

    def __init__(self, state_dict=None, batch_size: int = 36,
                 image_size: Tuple[int, int] = (480, 640),
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        if self.device.type == "cpu":
            dtype = torch.float32
        self.batch_size = batch_size
        self.image_size = image_size
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = resnet152()
        if state_dict is not None:
            model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                                   for k, v in state_dict.items()})
        self.model = model.to(self.device).set_dtype(dtype)

    @torch.inference_mode()
    def features(self, images: torch.Tensor) -> torch.Tensor:
        """(n, H, W) or (n, H, W, 3) images on the device -> (n, 2048) f32
        on the device, in batches of ``batch_size``."""
        if images.dim() == 3:
            images = images[..., None].expand(*images.shape, 3)
        return torch.cat([self.model(images[s:s + self.batch_size])
                          for s in range(0, images.shape[0],
                                         self.batch_size)])

    def __call__(self, images: np.ndarray) -> np.ndarray:
        """images: (N, H, W) depth or (N, H, W, 3) rgb in [0, 1]; returns
        (N, 2048) f32."""
        out = np.empty((images.shape[0], 2048), np.float32)
        bs = self.batch_size
        for s in range(0, images.shape[0], bs):
            chunk = torch.from_numpy(np.ascontiguousarray(
                images[s:s + bs], np.float32))
            if self.device.type == "cuda":
                chunk = chunk.pin_memory()
            chunk = chunk.to(self.device, non_blocking=True)
            out[s:s + bs] = self.features(chunk).cpu().numpy()
        return out


def featurize_views(
    viewpoint_ids: List[Tuple[str, str]],
    load_views: Callable[[str, str], np.ndarray],
    out_prefix: str,
    featurizer: Optional[ViewFeaturizer] = None,
    views: int = 36,
) -> np.ndarray:
    """Featurize every (scan, viewpoint): ``load_views(scan, vp)`` returns
    the (36, H, W[, 3]) raw views; writes ``{out_prefix}.npy`` (N, 36,
    2048) and ``{out_prefix}-index.npy`` long ids, the npy-pair format of
    ``dasa_tpu_torch.data.features.FeatureDB``.  Returns the values."""
    featurizer = featurizer or ViewFeaturizer()
    blocks = []
    ids = []
    for scan, vp in viewpoint_ids:
        raw = load_views(scan, vp)
        assert raw.shape[0] == views
        norm = np.stack([normalize_depth(v) for v in raw])
        blocks.append(featurizer(norm).reshape(views, -1))
        ids.append(f"{scan}_{vp}")
    values = np.stack(blocks)
    os.makedirs(os.path.dirname(out_prefix) or ".", exist_ok=True)
    np.save(out_prefix + ".npy", values)
    np.save(out_prefix + "-index.npy", np.asarray(ids))
    return values


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--views_dir", required=True,
                    help="holds {scan}_{viewpoint}.npy, 36 views each")
    ap.add_argument("--out", required=True, help="output prefix")
    ap.add_argument("--weights", default=None,
                    help="a torch file of the ResNet-152 state_dict")
    ap.add_argument("--batch_size", type=int, default=36)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    names = sorted(n[:-4] for n in os.listdir(args.views_dir)
                   if n.endswith(".npy"))
    ids = [tuple(n.split("_", 1)) for n in names]
    state = (torch.load(args.weights, map_location="cpu", weights_only=True)
             if args.weights else None)
    featurizer = ViewFeaturizer(state, batch_size=args.batch_size,
                                seed=args.seed, device=args.device)
    values = featurize_views(
        ids, lambda scan, vp: np.load(os.path.join(
            args.views_dir, f"{scan}_{vp}.npy")), args.out, featurizer)
    print(f"featurized {values.shape[0]} viewpoints into {args.out}.npy",
          flush=True)


if __name__ == "__main__":
    main()
