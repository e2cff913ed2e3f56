"""Optimizers and LR schedules.

Counterpart of ``dasa_tpu/train/optim.py`` (reference agent_dg.py:213-241,
1391-1393): one torch optimizer per policy component (encoder / decoder /
critic / adain, and "other" for anything else) at the same base LR, the
warmup + step-decay multiplier of ``lr_lambda`` on decoder / critic /
adain only, and global-norm clipping at 40 on the encoder's and on the
decoder's gradients, each separately.  ``torch.optim.RMSprop(alpha=0.99,
eps=1e-8)`` is the update the JAX package's ``scale_by_torch_rms`` copies;
``adam``, ``adamw`` and ``sgd`` are torch's, which the optax chains of
``_base_opt`` equal.

A parameter left without a gradient in a step is stepped with a zero
gradient, as the JAX package's ``optax.multi_transform`` feeds every leaf
of a stepped component (``dasa_tpu/train/optim.py:84``): RMSprop's and
Adam's moments decay, Adam's step count stays the component's, and
``weight_decay`` moves the parameter.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch
from torch import nn

from dasa_tpu_torch.config import Config

CLIP_NORM = 40.0
COMPONENTS = ("encoder", "decoder", "critic", "adain")
SCHEDULED = ("decoder", "critic", "adain")
CLIPPED = ("encoder", "decoder")


def lr_lambda(cfg: Config) -> Callable[[int], float]:
    """Warmup + step decay multiplier (agent_dg.py:219-229)."""

    def fn(it: int) -> float:
        if cfg.warm_steps > 0 and it < cfg.warm_steps:
            return (1.0 + it) / max(cfg.warm_steps, 1)
        if it < cfg.decay_start:
            return 1.0
        return cfg.lr_decay ** ((it - cfg.decay_start) // cfg.decay_intervals)

    return fn


def make_optimizer(cfg: Config, params: List[nn.Parameter]
                   ) -> torch.optim.Optimizer:
    """The torch optimizer of ``cfg.optim`` over ``params``."""
    wd = cfg.weight_decay
    if cfg.optim == "rms":
        return torch.optim.RMSprop(params, lr=cfg.lr, alpha=0.99, eps=1e-8,
                                   weight_decay=wd)
    if cfg.optim == "adam":
        return torch.optim.Adam(params, lr=cfg.lr, weight_decay=wd)
    if cfg.optim == "adamw":
        return torch.optim.AdamW(params, lr=cfg.lr, weight_decay=wd)
    if cfg.optim == "sgd":
        return torch.optim.SGD(params, lr=cfg.lr, weight_decay=wd)
    raise ValueError(cfg.optim)


def fill_missing_grads_(params: List[nn.Parameter]) -> None:
    """Give every parameter of ``params`` without a gradient a zero one, so
    that its optimizer steps it as the JAX chain steps a leaf whose
    gradient is zero."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def clip_grad_global_norm_(params: List[nn.Parameter],
                           max_norm: float) -> None:
    """Scale the gradients of ``params`` in place so their global norm is
    at most ``max_norm`` (optax ``clip_by_global_norm``: no epsilon;
    missing gradients count as zero)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = (max_norm / norm).clamp(max=1.0)
    for g in grads:
        g.mul_(scale)


class ComponentOptimizer:
    """The per-component optimizers of a policy, stepped together."""

    def __init__(self, cfg: Config, policy: nn.Module):
        self.cfg = cfg
        self.schedule = lr_lambda(cfg) if cfg.use_lr_scheduler else None
        self.params: Dict[str, List[nn.Parameter]] = {}
        for name, module in policy.named_children():
            key = name if name in COMPONENTS else "other"
            self.params.setdefault(key, []).extend(
                p for p in module.parameters() if p.requires_grad)
        self.optimizers = {name: make_optimizer(cfg, params)
                           for name, params in self.params.items()}
        self.iteration = 0  # updates applied: the schedule's step count

    def step(self) -> None:
        it = self.iteration
        for name, opt in self.optimizers.items():
            fill_missing_grads_(self.params[name])
            if name in CLIPPED:
                clip_grad_global_norm_(self.params[name], CLIP_NORM)
            if self.schedule is not None and name in SCHEDULED:
                for group in opt.param_groups:
                    group["lr"] = self.cfg.lr * self.schedule(it)
            opt.step()
        self.iteration += 1
