"""Core neural layers: LSTMs and the attention family.

PyTorch counterpart of ``dasa_tpu/models/layers.py`` (reference
r2r_src/model.py:16-353).  Parameters are f32 and named as the
reference's torch ``state_dict``; each layer computes in its
``compute_dtype`` (flax's ``Dense(dtype=...)`` rule: inputs, weights and
biases are cast first).  Dropout takes an explicit ``torch.Generator``: no
generator means no dropout (flax's ``deterministic=True``).
:func:`checkpointed` is the agents' ``remat`` (``jax.checkpoint``): a
block recomputed in the backward, drawing the same masks again.
"""

from __future__ import annotations

import contextlib
import math
from typing import Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from dasa_tpu_torch.ops.lstm import bilstm_scan_fn, lstm_scan_fn
from dasa_tpu_torch.ops.shift_attention import shift_attend_fn

NEG_INF = -1e9  # softmax mask value (finite to keep grads NaN-free)


def uniform(shape, gen, device) -> torch.Tensor:
    """f32 draws from U[0, 1) of ``shape``.  ``gen`` is a generator or a
    list of generators, one per equal block of the leading rows: a batch
    of several steps' rows then draws each step's block as that step alone
    would (the host replay's batched percepts)."""
    if isinstance(gen, torch.Generator):
        return torch.rand(shape, generator=gen, device=device)
    block = (shape[0] // len(gen), *shape[1:])
    return torch.cat([torch.rand(block, generator=g, device=device)
                      for g in gen])


def dropout(x: torch.Tensor, rate: float, gen) -> torch.Tensor:
    """Inverted dropout drawing its mask from ``gen`` (flax ``nn.Dropout``:
    keep with probability 1 - rate, scale kept values by 1 / (1 - rate)).
    ``gen`` None or ``rate`` 0 is the identity; a list of generators draws
    per block of rows (:func:`uniform`)."""
    if gen is None or rate == 0.0:
        return x
    u = uniform(x.shape, gen, x.device)
    return torch.where(u >= rate, x / (1.0 - rate), 0.0)


def _gen_state(gen):
    if gen is None:
        return None
    if isinstance(gen, torch.Generator):
        return gen.get_state()
    return [g.get_state() for g in gen]


def _gen_restored(gen, state):
    """A copy of ``gen`` (a generator or a list of them) at ``state``."""
    if gen is None:
        return None
    if isinstance(gen, torch.Generator):
        out = torch.Generator(device=gen.device)
        out.set_state(state)
        return out
    return [_gen_restored(g, st) for g, st in zip(gen, state)]


def checkpointed(fn, gen, recompute: bool, *args):
    """``fn(gen, *args)``, under ``torch.utils.checkpoint`` when
    ``recompute`` (every activation of ``fn`` recomputed in the backward),
    plainly otherwise.  The checkpoint is non-reentrant, so grad mode
    stays on in the forward and the kernels' autograd Functions run in
    both passes.  ``gen`` (None, a generator or a list) is what ``fn``
    draws from: its state is taken before the forward, and the recompute
    draws from a copy restored to it, so the backward sees the forward's
    dropout masks and samples while ``gen`` itself goes on
    (``checkpoint`` restores only the default generators)."""
    if not recompute:
        return fn(gen, *args)
    state = _gen_state(gen)
    calls = []

    def run(*inner):
        calls.append(None)
        return fn(gen if len(calls) == 1 else _gen_restored(gen, state),
                  *inner)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


@contextlib.contextmanager
def cast_params_once(module: nn.Module, dtype: torch.dtype):
    """Within the block, every use of a trainable f32 parameter of
    ``module`` reads ONE ``dtype`` copy made on entry (the JAX agent's
    ``_cast_params_once``, ``dasa_tpu/agents/seq2seq.py:384``): the
    forward is unchanged, and autograd sums the parameter's gradient over
    all its uses in ``dtype`` before one cast back to f32, instead of
    casting every use's gradient.  The copy sits on the parameter for the
    block's duration."""
    params = [p for p in module.parameters()
              if p.requires_grad and p.dtype == torch.float32]
    for p in params:
        p._pass_cast = p.to(dtype)
    try:
        yield
    finally:
        for p in params:
            del p._pass_cast


def cast_param(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``p`` in ``dtype``.  Inside :func:`cast_params_once` the pass's
    copy is used.  Outside autograd the cast copy is kept on the
    parameter and reused until the parameter changes (its version, device
    or storage), so inference does not re-cast every weight every step."""
    hit = getattr(p, "_pass_cast", None)
    if hit is not None and hit.dtype == dtype:
        return hit
    if p.dtype == dtype:
        return p
    if torch.is_grad_enabled() and p.requires_grad:
        return p.to(dtype)
    key = (p._version, p.data_ptr(), dtype)
    hit = getattr(p, "_compute_cast", None)
    if hit is not None and hit[0] == key:
        return hit[1]
    out = p.detach().to(dtype)
    p._compute_cast = (key, out)
    return out


def lecun_normal_(w: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's default kernel init: truncated normal, variance 1/fan_in."""
    std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


class Dense(nn.Linear):
    """``nn.Linear`` with f32 parameters that computes in
    ``compute_dtype``; flax's init (lecun-normal weight, zero bias)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, compute_dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype
        with torch.no_grad():
            lecun_normal_(self.weight, in_features)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        dt = self.compute_dtype
        return nn.functional.linear(
            x.to(dt), cast_param(self.weight, dt),
            None if self.bias is None else cast_param(self.bias, dt))


def _uniform_(p: torch.Tensor, scale: float) -> None:
    with torch.no_grad():
        p.uniform_(-scale, scale)


def _fold_bias_(bias_ih: nn.Parameter, bias_hh: nn.Parameter) -> None:
    """The JAX cell has ONE bias b, which ``bias_ih`` plays alone:
    ``bias_hh`` (the reference's second bias, kept for its names) is
    folded into it at init, then held at zero and not trained, so that an
    optimizer step, the global-norm clip and weight decay move the bias as
    the JAX chain moves b (two trained biases would each take the full
    step).  The cell's bias, their sum, keeps the reference's init."""
    with torch.no_grad():
        bias_ih += bias_hh
        bias_hh.zero_()
    bias_hh.requires_grad_(False)


class LstmCell(nn.Module):
    """torch ``nn.LSTMCell`` naming and gate order (i, f, g, o), uniform
    +-1/sqrt(H) init.  ``bias_ih + bias_hh`` plays the JAX cell's single
    bias; ``bias_hh`` is zero and frozen (:func:`_fold_bias_`)."""

    def __init__(self, features: int, in_features: int,
                 compute_dtype=torch.float32):
        super().__init__()
        self.features = features
        self.compute_dtype = compute_dtype
        self.weight_ih = nn.Parameter(torch.empty(4 * features, in_features))
        self.weight_hh = nn.Parameter(torch.empty(4 * features, features))
        self.bias_ih = nn.Parameter(torch.empty(4 * features))
        self.bias_hh = nn.Parameter(torch.empty(4 * features))
        k = 1.0 / math.sqrt(features)
        for p in self.parameters():
            _uniform_(p, k)
        _fold_bias_(self.bias_ih, self.bias_hh)

    def forward(self, carry: Tuple[torch.Tensor, torch.Tensor], x):
        dt = self.compute_dtype
        h, c = carry
        gates = (x.to(dt) @ cast_param(self.weight_ih, dt).t()
                 + h.to(dt) @ cast_param(self.weight_hh, dt).t()
                 + (self.bias_ih + self.bias_hh).to(dt))
        i, f, g, o = gates.chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return new_h, new_c


class LSTM(nn.Module):
    """Masked unidirectional LSTM over (B, T, D) with torch ``nn.LSTM``
    naming (``weight_ih_l0``, ...; ``bias_hh_l0`` zero and frozen,
    :func:`_fold_bias_`).  ``mask`` is True at valid tokens; a masked token
    passes the carry on and emits zeros, so the final carry is the state
    at each row's last valid token (run ``reverse``, at its first).

    ``kernel=True`` runs the recurrence through ``ops.lstm.LstmScanFn``
    (f32 carry; K1 forward and K2 backward on the card), as
    ``dasa_tpu/models/layers.py:108-121`` routes to its Pallas kernel;
    otherwise the plain token loop, whose carry stays in the compute
    dtype."""

    def __init__(self, features: int, in_features: int,
                 reverse: bool = False, compute_dtype=torch.float32):
        super().__init__()
        self.features = features
        self.reverse = reverse
        self.compute_dtype = compute_dtype
        k = 1.0 / math.sqrt(features)
        for name, shape in (("weight_ih", (4 * features, in_features)),
                            ("weight_hh", (4 * features, features)),
                            ("bias_ih", (4 * features,)),
                            ("bias_hh", (4 * features,))):
            p = nn.Parameter(torch.empty(*shape))
            _uniform_(p, k)
            self.register_parameter(f"{name}_l0", p)
        _fold_bias_(self.bias_ih_l0, self.bias_hh_l0)

    def forward(self, x, mask, init_carry=None, kernel: bool = False):
        dt = self.compute_dtype
        x = x.to(dt)
        batch = x.shape[0]
        if init_carry is None:
            zeros = torch.zeros(batch, self.features, dtype=dt,
                                device=x.device)
            init_carry = (zeros, zeros)
        if self.reverse:
            x, mask = x.flip(1), mask.flip(1)
        wh = cast_param(self.weight_hh_l0, dt)
        b = (self.bias_ih_l0 + self.bias_hh_l0).to(dt)
        xw = x @ cast_param(self.weight_ih_l0, dt).t()          # (B,T,4H)
        h, c = init_carry
        if kernel:
            m = mask.transpose(0, 1).to(dt)                      # (T,B)
            h_seq, c_seq = lstm_scan_fn((xw + b).transpose(0, 1), m, h, c,
                                        wh.t())
            ys = (h_seq * m[..., None]).transpose(0, 1)
            carry = (h_seq[-1], c_seq[-1])
        else:
            ys = []
            for t in range(x.shape[1]):
                gates = xw[:, t] + h.to(dt) @ wh.t() + b
                i, f, g, o = gates.chunk(4, dim=-1)
                new_c = (torch.sigmoid(f) * c
                         + torch.sigmoid(i) * torch.tanh(g))
                new_h = torch.sigmoid(o) * torch.tanh(new_c)
                m = mask[:, t, None].to(new_h.dtype)
                h = m * new_h + (1 - m) * h
                c = m * new_c + (1 - m) * c
                ys.append(new_h * m)
            ys = torch.stack(ys, 1)
            carry = (h, c)
        if self.reverse:
            ys = ys.flip(1)
        return ys, carry


class BiLSTM(nn.Module):
    """Bidirectional masked LSTM with torch ``nn.LSTM`` naming
    (``weight_ih_l0``, ``..._reverse``).  Outputs concat(fwd, bwd)
    features and final states concat(bwd, fwd) (reference
    model.py:66-68).  Masked tokens pass the carry on, as PackedSequence
    does.  Each direction's ``bias_hh`` is zero and frozen
    (:func:`_fold_bias_`).

    ``kernel=True`` runs both directions through ``ops.lstm.BiLstmScanFn``
    (f32 carry; on the card one launch of the forward kernel for both
    directions, where the JAX package makes one call per direction for
    lack of VMEM, ``dasa_tpu/models/layers.py:170-172``); otherwise both
    directions
    run as one plain token loop over stacked (2, B) states whose carry
    stays in the compute dtype (``dasa_tpu/models/layers.py:195-229``)."""

    def __init__(self, features: int, in_features: int,
                 compute_dtype=torch.float32):
        super().__init__()
        self.features = features
        self.compute_dtype = compute_dtype
        k = 1.0 / math.sqrt(features)
        for sfx in ("", "_reverse"):
            for name, shape in (("weight_ih", (4 * features, in_features)),
                                ("weight_hh", (4 * features, features)),
                                ("bias_ih", (4 * features,)),
                                ("bias_hh", (4 * features,))):
                p = nn.Parameter(torch.empty(*shape))
                _uniform_(p, k)
                self.register_parameter(f"{name}_l0{sfx}", p)
            _fold_bias_(getattr(self, f"bias_ih_l0{sfx}"),
                        getattr(self, f"bias_hh_l0{sfx}"))

    def _dir(self, sfx: str):
        dt = self.compute_dtype
        wi = cast_param(getattr(self, f"weight_ih_l0{sfx}"), dt)
        wh = cast_param(getattr(self, f"weight_hh_l0{sfx}"), dt)
        b = (getattr(self, f"bias_ih_l0{sfx}")
             + getattr(self, f"bias_hh_l0{sfx}")).to(dt)
        return wi, wh, b

    def forward(self, x, mask, kernel: bool = False):
        dt = self.compute_dtype
        x = x.to(dt)
        x_rev = x.flip(1)
        m_rev = mask.flip(1)
        batch = x.shape[0]
        feats = self.features
        if kernel:
            # both directions in one launch of the forward kernel
            (wi_f, wh_f, b_f), (wi_b, wh_b, b_b) = (self._dir(""),
                                                    self._dir("_reverse"))
            xw = torch.stack([x @ wi_f.t() + b_f, x_rev @ wi_b.t() + b_b]
                             ).transpose(1, 2)                 # (2,T,B,4H)
            m = torch.stack([mask, m_rev]).transpose(1, 2).to(dt)  # (2,T,B)
            zeros = torch.zeros(2, batch, feats, dtype=dt, device=x.device)
            h_seq, c_seq = bilstm_scan_fn(xw, m, zeros, zeros,
                                          (wh_f.t(), wh_b.t()))
            out = (h_seq * m[..., None]).transpose(1, 2)      # (2,B,T,H)
            ctx = torch.cat([out[0], out[1].flip(1)], dim=-1)
            return ctx, (torch.cat([h_seq[1, -1], h_seq[0, -1]], -1),
                         torch.cat([c_seq[1, -1], c_seq[0, -1]], -1))

        (wi_f, wh_f, b_f), (wi_b, wh_b, b_b) = self._dir(""), self._dir(
            "_reverse")
        xw = torch.stack([x @ wi_f.t(), x_rev @ wi_b.t()], 0)  # (2,B,T,4H)
        masks = torch.stack([mask, m_rev], 0).to(dt)          # (2,B,T)
        wh = torch.stack([wh_f.t(), wh_b.t()], 0)             # (2,H,4H)
        bias = torch.stack([b_f, b_b], 0)[:, None]            # (2,1,4H)
        h = torch.zeros(2, batch, feats, dtype=dt, device=x.device)
        c = torch.zeros_like(h)
        ys = []
        for t in range(x.shape[1]):
            gates = xw[:, :, t] + torch.bmm(h, wh) + bias
            i, f, g, o = gates.chunk(4, dim=-1)
            new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            new_h = torch.sigmoid(o) * torch.tanh(new_c)
            m = masks[:, :, t, None]
            h = m * new_h + (1 - m) * h
            c = m * new_c + (1 - m) * c
            ys.append(new_h * m)
        ys = torch.stack(ys, 2)                               # (2,B,T,H)
        ctx = torch.cat([ys[0], ys[1].flip(1)], dim=-1)
        return ctx, (torch.cat([h[1], h[0]], -1), torch.cat([c[1], c[0]], -1))


class SoftDotAttention(nn.Module):
    """Classic dot attention (reference model.py:253-296).  ``mask`` True
    = masked.  ``linear_out`` exists only when the layer is built
    ``with_tilde`` (the JAX module creates it only where h_tilde is
    used)."""

    def __init__(self, dim: int, ctx_dim: int, with_tilde: bool = True,
                 compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.linear_in = Dense(dim, ctx_dim, bias=False,
                               compute_dtype=compute_dtype)
        self.linear_out = (Dense(dim + ctx_dim, dim, bias=False,
                                 compute_dtype=compute_dtype)
                           if with_tilde else None)

    def forward(self, h, context, mask=None, output_tilde: bool = True,
                output_prob: bool = True):
        dt = self.compute_dtype
        h = h.to(dt)
        context = context.to(dt)
        target = self.linear_in(h)
        logit = torch.bmm(context, target[:, :, None])[..., 0]
        masked = logit if mask is None else logit.masked_fill(mask, NEG_INF)
        attn = torch.softmax(masked, dim=-1)
        weighted = torch.bmm(attn[:, None, :], context)[:, 0]
        attn_out = attn if output_prob else logit
        if output_tilde:
            h_tilde = torch.tanh(self.linear_out(
                torch.cat([weighted, h], dim=-1)))
            return h_tilde, attn_out
        return weighted, attn_out


class ShiftSoftDotAttention(nn.Module):
    """DASA shift attention over the 36-view panorama (reference
    model.py:300-353): the (B, 36) attention, as 3 elevation rows of 12
    headings, is smoothed by a per-sample kernel predicted from h with a
    circular cross-correlation along each heading ring.

    With ``use_kernel`` and no mask the whole layer runs through
    ``ops.shift_attention.ShiftAttendFn`` (the CUDA kernel on the card),
    as ``dasa_tpu/models/layers.py:283-304`` routes to its Pallas
    kernel."""

    def __init__(self, dim: int, ctx_dim: int, kernel_size: int = 3,
                 use_kernel: bool = False, with_tilde: bool = True,
                 compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.kernel_size = kernel_size
        self.use_kernel = use_kernel
        self.linear_in = Dense(dim, ctx_dim, bias=False,
                               compute_dtype=compute_dtype)
        self.linear_shift = Dense(dim, kernel_size,
                                  compute_dtype=compute_dtype)
        self.linear_out = (Dense(dim + ctx_dim, dim, bias=False,
                                 compute_dtype=compute_dtype)
                           if with_tilde else None)

    def forward(self, h, context, mask=None, output_tilde: bool = True,
                output_prob: bool = True):
        dt = self.compute_dtype
        h = h.to(dt)
        context = context.to(dt)
        batch = h.shape[0]
        if self.use_kernel and mask is None:
            weighted, logit = shift_attend_fn(
                h, context, cast_param(self.linear_in.weight, dt).t(),
                cast_param(self.linear_shift.weight, dt).t(),
                cast_param(self.linear_shift.bias, dt))
            weighted = weighted.to(dt)
            attn_out = torch.softmax(logit, -1) if output_prob else logit
        else:
            target = self.linear_in(h)
            logit = torch.bmm(context, target[:, :, None])[..., 0]
            masked = (logit if mask is None
                      else logit.masked_fill(mask, NEG_INF))
            attn = torch.softmax(masked, dim=-1)
            n_views = attn.shape[1]
            if n_views % 3:
                raise ValueError("shift attention expects 3 elevation rows")
            width = n_views // 3
            rows = attn.reshape(batch, 3, width)
            kernel = torch.softmax(self.linear_shift(h), dim=-1)  # (B, k)
            pad = self.kernel_size // 2
            ring = torch.cat([rows[:, :, width - pad:], rows,
                              rows[:, :, :pad]], dim=-1)
            smoothed = sum(ring[:, :, k:k + width] * kernel[:, k, None, None]
                           for k in range(self.kernel_size))
            weighted = torch.bmm(smoothed.reshape(batch, 1, n_views),
                                 context)[:, 0]
            attn_out = attn if output_prob else logit
        if output_tilde:
            h_tilde = torch.tanh(self.linear_out(
                torch.cat([weighted, h], dim=-1)))
            return h_tilde, attn_out
        return weighted, attn_out


def scaled_dot_attention(value, key, query, mask=None,
                         output_prob: bool = True):
    """Single-head scaled dot-product attention with a (B, D) or
    (B, Lq, D) query (reference utils.py:627-657,
    ``dasa_tpu/models/layers.py:338``); ``mask`` True = masked.  Returns
    (attended, attn-or-scores) squeezed back to the query's rank.  As in
    the reference, ``output_prob=False`` weights the values by the RAW
    scores too."""
    squeeze = query.dim() == 2
    if squeeze:
        query = query[:, None, :]
    scores = query @ key.transpose(1, 2) / math.sqrt(query.shape[-1])
    if mask is not None:
        scores = scores.masked_fill(mask, NEG_INF)
    out_map = torch.softmax(scores, dim=-1) if output_prob else scores
    result = out_map @ value
    if squeeze:
        return result[:, 0], out_map[:, 0]
    return result, out_map


class MLP(nn.Sequential):
    """Linear-ReLU-Linear (agent_dg.py:1550-1562,
    ``dasa_tpu/models/layers.py:360``); the JAX module's ``Dense_0`` and
    ``Dense_1`` are ``0`` and ``2``."""

    def __init__(self, in_dim: int, latent_dim: int, out_dim: int,
                 compute_dtype=torch.float32):
        kw = dict(compute_dtype=compute_dtype)
        super().__init__(Dense(in_dim, latent_dim, **kw), nn.ReLU(),
                         Dense(latent_dim, out_dim, **kw))
