"""Depth-guided AdaIN feature modulation.

Counterpart of ``dasa_tpu/models/adain.py`` (reference
agent_dg.py:1513-1661, model.py:1822-1841, gumbel.py:18-30): the DASA
``channel`` module a * f + b with a = act(W_a d), b = W_b d; the ablation
variants over a content-style bank (COCO), mean-pooled depth and
[mean, std, max, min] depth statistics; the gumbel-sigmoid gate; and the
parameter-free ``adaptive_instance_normalization``.  As in the JAX package
(``dasa_tpu/models/adain.py:76``) the env-drop noise is applied around the
modules (``models/policy.py``).

A module's ``forward(f_t, d_t, is_test=True, noise=None)``: under the
gumbel-sigmoid gate and ``is_test=False`` the gate's uniform noise comes
from ``noise(shape)``, which the policy draws from the step's generator
(the JAX modules take a ``gumbel_rng``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from dasa_tpu_torch.models.layers import MLP, Dense, cast_param
from dasa_tpu_torch.ops.adain import adain_gate_fn


def gumbel_sigmoid(logits, u: Optional[torch.Tensor] = None,
                   tau: float = 1.0, hard: bool = True, eps: float = 1e-10,
                   test: bool = False):
    """Gumbel-sigmoid gate (gumbel.py:18-30): ``u`` holds U[0, 1) draws of
    ``logits``' shape.  ``hard`` rounds at 0.5 with the straight-through
    estimator (the soft sample's gradient); ``test`` is the deterministic
    threshold sigmoid(logits) > 0.5 and needs no noise."""
    if test:
        return (torch.sigmoid(logits) > 0.5).to(logits.dtype)
    u = u.to(logits.dtype)
    noise = torch.log(eps + u) - torch.log(1.0 - u + eps)
    y_soft = torch.sigmoid((logits + noise) / tau)
    if hard:
        y_hard = (y_soft > 0.5).to(logits.dtype)
        return y_hard + y_soft - y_soft.detach()
    return y_soft


def adaptive_instance_normalization(content, style, eps: float = 1e-5):
    """Per-sample (over the 36-token axis) renormalization of content to
    style statistics (model.py:1822-1841); population std, as jnp.std."""
    c_mean = content.mean(dim=1, keepdim=True)
    c_std = content.std(dim=1, keepdim=True, unbiased=False) + eps
    s_mean = style.mean(dim=1, keepdim=True)
    s_std = style.std(dim=1, keepdim=True, unbiased=False)
    return (content - c_mean) / c_std * s_std + s_mean


def _gate(a, a_type, is_test: bool, noise: Optional[Callable]):
    if a_type == "sigmoid":
        return torch.sigmoid(a)
    if a_type == "gumbel_sigmoid":
        if is_test:
            return gumbel_sigmoid(a, test=True)
        if noise is None:
            raise ValueError("the gumbel-sigmoid gate in training needs its "
                             "uniform noise (a generator or noise(shape))")
        return gumbel_sigmoid(a, noise(a.shape), hard=True)
    return a


class DGAdaChannel(nn.Module):
    """Learned channel modulation a*f + b with a/b predicted from the
    style (depth) features (agent_dg.py:1513-1547); ``ab_type`` selects
    which of a/b exist, ``a_type`` applies sigmoid or gumbel-sigmoid to
    the gate.

    With ``use_kernel`` and the published config (``ab_type=a``,
    ``a_type=sigmoid``) the gate runs through
    ``ops.adain.AdainGateFn`` (the CUDA kernel on the card), as
    ``dasa_tpu/models/adain.py:65-76`` routes to its Pallas kernel."""

    def __init__(self, channel: int, ab_type: str = "ab",
                 a_type: Optional[str] = None, use_kernel: bool = False,
                 compute_dtype=torch.float32):
        super().__init__()
        self.ab_type = ab_type
        self.a_type = a_type
        self.use_kernel = use_kernel
        self.compute_dtype = compute_dtype
        kw = dict(compute_dtype=compute_dtype)
        if ab_type in ("ab", "a"):
            self.a_fc = Dense(channel, channel, **kw)
        if ab_type in ("ab", "b"):
            self.b_fc = Dense(channel, channel, **kw)

    def forward(self, f_t, d_t, is_test: bool = True, noise=None):
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
        return _gate(a, self.a_type, is_test, noise) * f_t + b


class DGAdaCOCOChannel(nn.Module):
    """Content-style MLP fusion with a learned style-bank token
    (agent_dg.py:1566-1617): each of a/b is fuse(content(f) * style([d;
    csb])), three MLPs a branch and a (1, 1, channel / 4) token ``{a,b}_csb``
    broadcast to every row."""

    def __init__(self, channel: int, ab_type: str = "ab",
                 a_type: Optional[str] = None, mid_dim: int = 256,
                 compute_dtype=torch.float32):
        super().__init__()
        self.ab_type = ab_type
        self.a_type = a_type
        self.compute_dtype = compute_dtype
        csb_dim = channel // 4
        for prefix in ("a", "b"):
            if ab_type not in ("ab", prefix):
                continue
            self.add_module(f"{prefix}_fc_content",
                            MLP(channel, mid_dim, channel, compute_dtype))
            self.add_module(f"{prefix}_fc_style",
                            MLP(channel + csb_dim, mid_dim, channel,
                                compute_dtype))
            self.add_module(f"{prefix}_fc_fuse",
                            MLP(channel, mid_dim, channel, compute_dtype))
            self.register_parameter(f"{prefix}_csb", nn.Parameter(
                torch.randn(1, 1, csb_dim)))

    def _branch(self, prefix: str, f_t, d_t):
        batch, length, _ = f_t.shape
        content = getattr(self, f"{prefix}_fc_content")(f_t)
        csb = cast_param(getattr(self, f"{prefix}_csb"), self.compute_dtype)
        csb = csb.expand(batch, length, csb.shape[-1])
        style = getattr(self, f"{prefix}_fc_style")(
            torch.cat([d_t, csb], dim=-1))
        return getattr(self, f"{prefix}_fc_fuse")(content * style)

    def forward(self, f_t, d_t, is_test: bool = True, noise=None):
        dt = self.compute_dtype
        f_t = f_t.to(dt)
        d_t = d_t.to(dt)
        a = torch.ones((), dtype=dt, device=f_t.device)
        b = torch.zeros((), dtype=dt, device=f_t.device)
        if self.ab_type in ("ab", "a"):
            a = self._branch("a", f_t, d_t)
        if self.ab_type in ("ab", "b"):
            b = self._branch("b", f_t, d_t)
        return _gate(a, self.a_type, is_test, noise) * f_t + b


class DGAdaMeanChannel(nn.Module):
    """a/b from mean-pooled depth (agent_dg.py:1620-1636)."""

    def __init__(self, channel: int, compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.a_fc = Dense(channel, channel, compute_dtype=compute_dtype)
        self.b_fc = Dense(channel, channel, compute_dtype=compute_dtype)

    def forward(self, f_t, d_t, **_):
        f_t = f_t.to(self.compute_dtype)
        d_mean = d_t.to(self.compute_dtype).mean(dim=1)
        return (self.a_fc(d_mean)[:, None, :] * f_t
                + self.b_fc(d_mean)[:, None, :])


class DGAdaStatChannel(nn.Module):
    """a/b from [mean, std, max, min] depth statistics over the token axis
    (agent_dg.py:1639-1661).  The std is the unbiased one (ddof=1, as
    torch.std), unlike :func:`adaptive_instance_normalization`'s."""

    def __init__(self, channel: int, compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.a_fc = Dense(4 * channel, channel, compute_dtype=compute_dtype)
        self.b_fc = Dense(4 * channel, channel, compute_dtype=compute_dtype)

    def forward(self, f_t, d_t, **_):
        f_t = f_t.to(self.compute_dtype)
        d_t = d_t.to(self.compute_dtype)
        stats = torch.cat([d_t.mean(dim=1), d_t.std(dim=1, unbiased=True),
                           d_t.amax(dim=1), d_t.amin(dim=1)], dim=-1)
        return (self.a_fc(stats)[:, None, :] * f_t
                + self.b_fc(stats)[:, None, :])


def make_adain(adain_type: str, channel: int, ab_type: str, a_type,
               compute_dtype=torch.float32, use_kernel: bool = False
               ) -> Optional[nn.Module]:
    """Module factory mirroring agent init (agent_dg.py:196-209): None for
    ``none`` and ``default`` (the parameter-free renormalization)."""
    if adain_type in ("channel", "rgb_channel"):
        return DGAdaChannel(channel, ab_type, a_type, use_kernel,
                            compute_dtype)
    if adain_type == "coco_channel":
        return DGAdaCOCOChannel(channel, ab_type, a_type,
                                compute_dtype=compute_dtype)
    if adain_type in ("meanchannel", "rgb_meanchannel"):
        return DGAdaMeanChannel(channel, compute_dtype)
    if adain_type in ("rgb_stat_channel", "depth_stat_channel"):
        return DGAdaStatChannel(channel, compute_dtype)
    return None
