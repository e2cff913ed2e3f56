"""Plain layers of the reference listener: dense layers, LSTMs, dropout and
the attention family, in float32 with no kernel.

A frozen copy of the port's layer arithmetic at the time the benchmark was
written (``dasa_tpu_torch/models/layers.py``), cut to the paths the
benchmark's configurations run, and importing nothing of the port.  The
parameter names are the port's, so one state dict loads into both.

Dropout masks are drawn with ``torch.rand`` from the caller's generator in
the order the port draws them, so the same generator state gives the same
masks on both sides.

:class:`MatmulRounding` is the lower-precision control: inside
``fp8_matmuls()`` both operands of every weight product (the dense layers
and the LSTMs' input and recurrent products) are rounded to float8 e4m3
with one scale per tensor before the float32 product.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch
from torch import nn

NEG_INF = -1e9
FP8_MAX = 448.0


class MatmulRounding:
    """Whether the weight products round their operands to fp8 (the
    control); off by default."""

    fp8 = False


@contextlib.contextmanager
def fp8_matmuls():
    """Round both operands of every weight product to fp8 in the block."""
    prev = MatmulRounding.fp8
    MatmulRounding.fp8 = True
    try:
        yield
    finally:
        MatmulRounding.fp8 = prev


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the whole tensor
    (its largest magnitude maps to 448), back in float32."""
    x = x.float()
    with torch.no_grad():
        scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
        q = (x / scale).to(torch.float8_e4m3fn).float().mul_(scale)
    if not x.requires_grad:
        return q
    # straight-through: the rounding's gradient is the identity
    return x + (q - x).detach()


def operand(x: torch.Tensor) -> torch.Tensor:
    return fp8_round(x) if MatmulRounding.fp8 else x.float()


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for a weight product."""
    return operand(a) @ operand(b)


def uniform(shape, gen, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device)


def dropout(x: torch.Tensor, rate: float, gen) -> torch.Tensor:
    if gen is None or rate == 0.0:
        return x
    u = uniform(x.shape, gen, x.device)
    return torch.where(u >= rate, x / (1.0 - rate), 0.0)


class Dense(nn.Linear):
    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)

    def forward(self, x):
        out = mm(x, self.weight.t())
        return out if self.bias is None else out + self.bias


def _cell(gates, c):
    i, f, g, o = gates.chunk(4, dim=-1)
    new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(new_c), new_c


class LstmCell(nn.Module):
    def __init__(self, features: int, in_features: int):
        super().__init__()
        self.features = features
        self.weight_ih = nn.Parameter(torch.zeros(4 * features, in_features))
        self.weight_hh = nn.Parameter(torch.zeros(4 * features, features))
        self.bias_ih = nn.Parameter(torch.zeros(4 * features))
        self.bias_hh = nn.Parameter(torch.zeros(4 * features))
        self.bias_hh.requires_grad_(False)

    def forward(self, carry: Tuple[torch.Tensor, torch.Tensor], x):
        h, c = carry
        gates = (mm(x, self.weight_ih.t()) + mm(h, self.weight_hh.t())
                 + self.bias_ih + self.bias_hh)
        return _cell(gates, c.float())


class BiLSTM(nn.LSTM):
    """Masked bidirectional LSTM (cuDNN's, float32 with TF32 off, over the
    packed valid prefix of each row): outputs concat(fwd, bwd) with zeros
    at padding, final states concat(bwd, fwd) at each row's last valid
    token.  Under ``fp8_matmuls()`` its weights and input are rounded to
    fp8 first."""

    def __init__(self, features: int, in_features: int):
        super().__init__(in_features, features, batch_first=True,
                         bidirectional=True)
        self.bias_hh_l0.requires_grad_(False)
        self.bias_hh_l0_reverse.requires_grad_(False)

    def forward(self, x, mask):
        pack = nn.utils.rnn.pack_padded_sequence
        lengths = mask.sum(1).clamp(min=1).cpu()
        x = x.float()
        run = super().forward
        if MatmulRounding.fp8:
            x = fp8_round(x)
            params = {name: fp8_round(p) if name.startswith("weight") else p
                      for name, p in self.named_parameters()}

            def run(inp):
                return torch.func.functional_call(nn.LSTM(
                    self.input_size, self.hidden_size, batch_first=True,
                    bidirectional=True, device=x.device), params, (inp,))
        out, (h, c) = run(pack(x, lengths, batch_first=True,
                               enforce_sorted=False))
        ctx, _ = nn.utils.rnn.pad_packed_sequence(
            out, batch_first=True, total_length=x.shape[1])
        return ctx, (torch.cat([h[1], h[0]], -1), torch.cat([c[1], c[0]], -1))


class SoftDotAttention(nn.Module):
    def __init__(self, dim: int, ctx_dim: int, with_tilde: bool = True):
        super().__init__()
        self.linear_in = Dense(dim, ctx_dim, bias=False)
        self.linear_out = (Dense(dim + ctx_dim, dim, bias=False)
                           if with_tilde else None)

    def forward(self, h, context, mask=None, output_tilde: bool = True,
                output_prob: bool = True):
        h, context = h.float(), context.float()
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
    """Attention over the 36-view panorama, smoothed along each heading
    ring by a per-sample kernel predicted from h."""

    def __init__(self, dim: int, ctx_dim: int, kernel_size: int = 3):
        super().__init__()
        self.kernel_size = kernel_size
        self.linear_in = Dense(dim, ctx_dim, bias=False)
        self.linear_shift = Dense(dim, kernel_size)

    def forward(self, h, context):
        h, context = h.float(), context.float()
        batch = h.shape[0]
        target = self.linear_in(h)
        logit = torch.bmm(context, target[:, :, None])[..., 0]
        attn = torch.softmax(logit, dim=-1)
        n_views = attn.shape[1]
        width = n_views // 3
        rows = attn.reshape(batch, 3, width)
        kernel = torch.softmax(self.linear_shift(h), dim=-1)
        pad = self.kernel_size // 2
        ring = torch.cat([rows[:, :, width - pad:], rows, rows[:, :, :pad]],
                         dim=-1)
        smoothed = sum(ring[:, :, k:k + width] * kernel[:, k, None, None]
                       for k in range(self.kernel_size))
        weighted = torch.bmm(smoothed.reshape(batch, 1, n_views),
                             context)[:, 0]
        return weighted, attn
