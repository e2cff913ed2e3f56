"""ResNet (v1, bottleneck): the featurization backbone.

Counterpart of ``dasa_tpu/models/resnet.py`` (the reference featurizes
with torchvision's resnet152, scripts/depth_feat_extractor.py:33-40).
Inference only: BatchNorm reads its running statistics (eps 1e-5).  The
input is (B, H, W, 3) as in the JAX module; the network runs channels-last
inside, its convolutions in ``dtype`` (cuDNN's on the card: the JAX
package computes them outside any Pallas kernel), BatchNorm's statistics
and affine terms in f32.  The output is the (B, 2048) global average pool
in f32.  Names are torchvision's (``conv1``, ``bn1``, ``layerN.M.convK``,
``layerN.M.downsample.0/1``), so a torchvision checkpoint loads without
its ``fc``; ``utils/jax_params.py:resnet_state_dict_from_jax`` carries the
JAX module's variables over.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F


def _conv(c_in: int, c_out: int, k: int, stride: int = 1) -> nn.Conv2d:
    conv = nn.Conv2d(c_in, c_out, k, stride=stride, padding=k // 2,
                     bias=False)
    # lecun normal, flax's default kernel init
    nn.init.normal_(conv.weight, std=1.0 / math.sqrt(c_in * k * k))
    return conv


def _norm(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 (4x wide), with a projected shortcut on
    the first block of a stage."""

    def __init__(self, c_in: int, features: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(c_in, features, 1)
        self.bn1 = _norm(features)
        self.conv2 = _conv(features, features, 3, stride)
        self.bn2 = _norm(features)
        self.conv3 = _conv(features, features * 4, 1)
        self.bn3 = _norm(features * 4)
        self.downsample = (nn.Sequential(_conv(c_in, features * 4, 1, stride),
                                         _norm(features * 4))
                           if downsample else None)

    def forward(self, x):
        y = F.relu(_bn(self.bn1, self.conv1(x)))
        y = F.relu(_bn(self.bn2, self.conv2(y)))
        y = _bn(self.bn3, self.conv3(y))
        residual = x
        if self.downsample is not None:
            residual = _bn(self.downsample[1], self.downsample[0](x))
        return F.relu(y + residual)


def _bn(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """Inference BatchNorm: f32 statistics and affine terms over an input
    of the compute dtype (the card's cuDNN takes the mixed pair; the CPU
    runs f32 throughout)."""
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, training=False, eps=bn.eps)


class ResNet(nn.Module):
    """Bottleneck ResNet over ``stage_sizes``; :meth:`forward` maps (B, H,
    W, 3) images to (B, 2048) pooled features.  Parameters are f32; the
    convolutions run in ``dtype`` (:meth:`set_dtype`)."""

    def __init__(self, stage_sizes: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = _norm(64)
        c_in = 64
        for i, n_blocks in enumerate(stage_sizes):
            features = 64 * 2 ** i
            blocks = []
            for j in range(n_blocks):
                blocks.append(Bottleneck(c_in, features,
                                         2 if (i > 0 and j == 0) else 1,
                                         downsample=j == 0))
                c_in = features * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.n_stages = len(stage_sizes)
        self.dtype = torch.float32
        self.set_dtype(dtype)
        self.eval()

    def set_dtype(self, dtype: torch.dtype) -> "ResNet":
        """Hold the convolution weights in ``dtype``; BatchNorm stays f32."""
        self.dtype = dtype
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.to(dtype)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = F.relu(_bn(self.bn1, self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for i in range(self.n_stages):
            x = getattr(self, f"layer{i + 1}")(x)
        return x.float().mean(dim=(2, 3))


def resnet50(dtype: torch.dtype = torch.float32) -> ResNet:
    return ResNet((3, 4, 6, 3), dtype)


def resnet152(dtype: torch.dtype = torch.float32) -> ResNet:
    """The reference featurization backbone (ResNet-152)."""
    return ResNet((3, 8, 36, 3), dtype)
