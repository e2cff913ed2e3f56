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

:func:`restore_optax_state` carries the JAX package's optax state into
these optimizers (``--load_optim`` on a JAX checkpoint):
``scale_by_torch_rms``'s ``nu`` is RMSprop's ``square_avg``,
``scale_by_adam``'s ``mu`` / ``nu`` / ``count`` are Adam's ``exp_avg`` /
``exp_avg_sq`` / ``step``, and the schedule's ``count`` is
:attr:`ComponentOptimizer.iteration`.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
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


def optax_moments(state) -> dict:
    """The moments in one optax state (as flax's ``to_state_dict`` or
    ``utils/flax_msgpack.py`` gives it: nested dicts, a chain's members
    under "0", "1", ...): ``mu`` and ``nu`` trees (None where absent),
    Adam's ``count`` and the schedule's ``schedule_count`` (None where
    absent).  ``scale_by_adam`` holds {count, mu, nu},
    ``scale_by_torch_rms`` {nu}, ``scale_by_schedule`` {count}."""
    found = {"mu": None, "nu": None, "count": None, "schedule_count": None}

    def walk(node):
        if not isinstance(node, Mapping):
            return
        if "nu" in node:
            found["nu"] = node["nu"]
            if "mu" in node:
                found["mu"] = node["mu"]
                found["count"] = int(np.asarray(node["count"]))
            return
        if set(node) == {"count"}:
            found["schedule_count"] = int(np.asarray(node["count"]))
            return
        for val in node.values():
            walk(val)

    walk(state)
    return found


def restore_optax_state(opt: torch.optim.Optimizer,
                        names: Mapping[nn.Parameter, str], state,
                        to_state_dict: Callable) -> Optional[int]:
    """Set ``opt``'s per-parameter state from one optax state
    (:func:`optax_moments`); ``to_state_dict`` maps a JAX param tree onto
    the port's parameter names, and ``names`` names ``opt``'s parameters.
    Raises ``KeyError`` when a parameter has no moment.  Returns the
    schedule's count (None when the chain has no schedule)."""
    found = optax_moments(state)
    mu = None if found["mu"] is None else to_state_dict(found["mu"])
    nu = None if found["nu"] is None else to_state_dict(found["nu"])
    step = found["count"] if found["count"] is not None \
        else found["schedule_count"] or 0
    adam = isinstance(opt, (torch.optim.Adam, torch.optim.AdamW))
    rms = isinstance(opt, torch.optim.RMSprop)
    if (adam and mu is None) or (rms and nu is None):
        raise KeyError(f"no {'Adam' if adam else 'RMSprop'} moments in the "
                       "optax state")
    for group in opt.param_groups:
        for p in group["params"]:
            st = {"step": torch.tensor(float(step))}

            def moment(tree):
                return torch.as_tensor(tree[names[p]]).to(p.device, p.dtype)

            if adam:
                st.update(exp_avg=moment(mu), exp_avg_sq=moment(nu))
            elif rms:
                st["square_avg"] = moment(nu)
            else:  # sgd: no state
                continue
            opt.state[p] = st
    return found["schedule_count"]


class ComponentOptimizer:
    """The per-component optimizers of a policy, stepped together."""

    def __init__(self, cfg: Config, policy: nn.Module):
        self.cfg = cfg
        self.schedule = lr_lambda(cfg) if cfg.use_lr_scheduler else None
        self.names = {p: name for name, p in policy.named_parameters()}
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

    def restore_optax(self, opt_state, to_state_dict: Callable) -> None:
        """Restore the JAX agent's ``build_optimizer`` state (an
        ``optax.multi_transform`` keyed by component, as a state dict):
        each component's moments into the optimizer of the same name
        (:func:`restore_optax_state`), the schedule's count into
        :attr:`iteration`."""
        inner = opt_state["inner_states"]
        for name, opt in self.optimizers.items():
            count = restore_optax_state(opt, self.names, inner[name],
                                        to_state_dict)
            if count is not None:
                self.iteration = count
