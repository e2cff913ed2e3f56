"""Depth-guided AdaIN feature modulation.

Counterpart of ``dasa_tpu/models/adain.py`` (reference
agent_dg.py:1513-1547, model.py:1822-1841): the DASA ``channel`` module
and the parameter-free ``adaptive_instance_normalization``.  As in the JAX
package (``dasa_tpu/models/adain.py:76``) the gate's noise input stays
unused here: the env-drop noise is applied around the module
(``models/policy.py``).  The gumbel-sigmoid gate and the COCO / mean /
stat variants come with later slices (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dasa_tpu_torch.models.layers import Dense, cast_param
from dasa_tpu_torch.ops.adain import adain_gate_fn


def adaptive_instance_normalization(content, style, eps: float = 1e-5):
    """Per-sample (over the 36-token axis) renormalization of content to
    style statistics (model.py:1822-1841); population std, as jnp.std."""
    c_mean = content.mean(dim=1, keepdim=True)
    c_std = content.std(dim=1, keepdim=True, unbiased=False) + eps
    s_mean = style.mean(dim=1, keepdim=True)
    s_std = style.std(dim=1, keepdim=True, unbiased=False)
    return (content - c_mean) / c_std * s_std + s_mean


class DGAdaChannel(nn.Module):
    """Learned channel modulation a*f + b with a/b predicted from the
    style (depth) features (agent_dg.py:1513-1547).

    With ``use_kernel`` and the published config (``ab_type=a``,
    ``a_type=sigmoid``) the gate runs through
    ``ops.adain.AdainGateFn`` (the CUDA kernel on the card), as
    ``dasa_tpu/models/adain.py:65-76`` routes to its Pallas kernel."""

    def __init__(self, channel: int, ab_type: str = "ab",
                 a_type: Optional[str] = None, use_kernel: bool = False,
                 compute_dtype=torch.float32):
        super().__init__()
        if a_type not in (None, "sigmoid"):
            raise NotImplementedError(
                f"DGAdaChannel a_type={a_type!r}: the gumbel-sigmoid gate "
                "comes with the variants slice (ROADMAP.md)")
        self.ab_type = ab_type
        self.a_type = a_type
        self.use_kernel = use_kernel
        self.compute_dtype = compute_dtype
        kw = dict(compute_dtype=compute_dtype)
        if ab_type in ("ab", "a"):
            self.a_fc = Dense(channel, channel, **kw)
        if ab_type in ("ab", "b"):
            self.b_fc = Dense(channel, channel, **kw)

    def forward(self, f_t, d_t):
        dt = self.compute_dtype
        f_t = f_t.to(dt)
        d_t = d_t.to(dt)
        if self.use_kernel and self.ab_type == "a" \
                and self.a_type == "sigmoid":
            return adain_gate_fn(
                f_t, d_t, cast_param(self.a_fc.weight, dt).t(),
                cast_param(self.a_fc.bias, dt))
        a = torch.ones((), dtype=dt, device=f_t.device)
        b = torch.zeros((), dtype=dt, device=f_t.device)
        if self.ab_type in ("ab", "a"):
            a = self.a_fc(d_t)
        if self.ab_type in ("ab", "b"):
            b = self.b_fc(d_t)
        if self.a_type == "sigmoid":
            a = torch.sigmoid(a)
        return a * f_t + b


def make_adain(adain_type: str, channel: int, ab_type: str, a_type,
               compute_dtype=torch.float32, use_kernel: bool = False
               ) -> Optional[nn.Module]:
    """Module factory mirroring agent init (agent_dg.py:196-209)."""
    if adain_type in ("channel", "rgb_channel"):
        return DGAdaChannel(channel, ab_type, a_type, use_kernel,
                            compute_dtype)
    if adain_type in ("none", "default"):
        return None
    raise NotImplementedError(
        f"adain_type={adain_type!r}: the COCO/mean/stat AdaIN modules come "
        "with the variants slice (ROADMAP.md)")
