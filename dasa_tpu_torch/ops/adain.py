"""Fused depth-guided AdaIN channel gate: CUDA kernel and plain version.

Port of the TPU kernel ``dasa_tpu/ops/adain.py:_kernel`` (via
``_pallas_forward`` / ``adain_channel_gate``): out = sigmoid(d W + b) * f
* noise in one pass, the published DASA config (``ab_type=a``,
``a_type=sigmoid``).  The kernel (``csrc/adain_gate.cu``) is a
warp-specialised TMA + ``wgmma`` GEMM with the gate fused into its
epilogue; its source note says what bounds it and how the design
answers.  :func:`adain_plan` is its launch plan, in Python so that the
CPU tests reach it.

:class:`AdainGateFn` is what the modules call: the kernel forward and the
JAX package's plain f32 backward (``dasa_tpu/ops/adain.py:_bwd``; the TPU
package has no backward kernel for this op, so neither has the port).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dasa_tpu_torch.ops import _build

# csrc/adain_gate.cu: rows per CTA, K elements per stage (two 64-wide
# boxes), threads
ADAIN_BM = 128
ADAIN_SK = 128
ADAIN_THREADS = 288
# output tile width -> ring stages (Tile<BN>::kStages)
ADAIN_STAGES = {128: 3, 64: 4}


class AdainPlan(NamedTuple):
    bn: int          # output columns per CTA
    stages: int      # depth of the TMA ring
    grid: tuple      # (C / bn, ceil(n / 128))
    smem: int        # dynamic shared memory per CTA, bytes


def adain_plan(n: int, c: int, k: int, n_sm: int = 132) -> AdainPlan:
    """Launch plan of ``csrc/adain_gate.cu`` for n rows, C outputs and K
    inputs on a card of ``n_sm`` SMs; raises on shapes the tiling cannot
    take.  Output tiles are 128 x 128, or 128 x 64 when 128 x 128 tiles
    would fill at most half the SMs (on an H100 at C = K = 2048 that is
    the candidates' 320 rows, where 128 x 64 measured faster, and not the
    panorama's 720; PERF.md)."""
    if n < 1:
        raise ValueError(f"adain_channel_gate: n={n} rows; need at least 1")
    if c % 64:
        raise ValueError(f"adain_channel_gate: C={c} must be a multiple of "
                         "64 (the output tile's width)")
    if k % 8:
        raise ValueError(f"adain_channel_gate: K={k} must be a multiple of "
                         "8 (TMA needs 16-byte row strides)")
    tiles_128 = (c // 128) * -(-n // ADAIN_BM)
    bn = 128 if c % 128 == 0 and 2 * tiles_128 > n_sm else 64
    stages = ADAIN_STAGES[bn]
    smem = (stages * (ADAIN_BM + bn) * ADAIN_SK * 2 + ADAIN_BM * bn * 2
            + 256 + 1024)
    return AdainPlan(bn, stages, (c // bn, -(-n // ADAIN_BM)), smem)


def adain_channel_gate_ref(f, d, w, b, noise=None) -> torch.Tensor:
    """Plain PyTorch version.  f, d (..., C); w (C, C) in the JAX layout
    (in, out); b (C,); noise (C,) or None.  w and b are first cast to f's
    dtype, the product accumulates in f32, the gate and the multiplies
    run in f32, and the result is rounded to f's dtype once — the TPU
    kernel's arithmetic."""
    c = f.shape[-1]
    acc = d.reshape(-1, c).float() @ w.to(f.dtype).float()
    out = torch.sigmoid(acc + b.to(f.dtype).float()) * f.reshape(-1, c).float()
    if noise is not None:
        out = out * noise.to(f.dtype).float()
    return out.to(f.dtype).reshape(f.shape)


def adain_channel_gate(f, d, w, b, noise: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """out = sigmoid(d @ w + b) * f * noise (see
    :func:`adain_channel_gate_ref`).

    CPU tensors take the plain version; CUDA tensors launch the kernel of
    ``csrc/adain_gate.cu`` (bf16 only) or raise.  ``w`` may be a
    transposed view of a contiguous (out, in) tensor (torch's Linear
    weight), which the kernel reads without a copy."""
    _build.refuse_grad("adain_channel_gate", f, d, w, b, noise)
    if f.device.type == "cpu":
        return adain_channel_gate_ref(f, d, w, b, noise)
    shape = f.shape
    c = shape[-1]
    k = d.shape[-1]
    if d.shape[:-1] != shape[:-1] or w.shape != (k, c) or b.shape != (c,):
        raise ValueError(f"adain_channel_gate: shapes f {tuple(shape)}, d "
                         f"{tuple(d.shape)}, w {tuple(w.shape)}, b "
                         f"{tuple(b.shape)} do not match")
    plan = adain_plan(f.numel() // c, c, k, _build.sm_count(f))
    f2 = f.reshape(-1, c).contiguous()
    d2 = d.reshape(-1, k).contiguous()
    wt = w.t().contiguous()
    b = b.contiguous()
    tensors = dict(f=f2, d=d2, w=wt, b=b)
    if noise is not None:
        noise = noise.reshape(c).contiguous()
        tensors["noise"] = noise
    _build.require_cuda("adain_channel_gate", **tensors)
    lib = _build.library()
    out = torch.empty_like(f2)
    rc = lib.dasa_adain_gate(
        d2.data_ptr(), f2.data_ptr(), wt.data_ptr(), b.data_ptr(),
        None if noise is None else noise.data_ptr(), out.data_ptr(),
        f2.shape[0], c, k, plan.bn, _build.stream_of(f2))
    _build.check(rc, "adain_channel_gate")
    adain_channel_gate.launches += 1
    return out.reshape(shape)


adain_channel_gate.launches = 0


class AdainGateFn(torch.autograd.Function):
    """Differentiable :func:`adain_channel_gate`: the kernel forward, and
    backward in f32 exactly as ``dasa_tpu/ops/adain.py:_bwd``."""

    @staticmethod
    def forward(ctx, f, d, w, b, noise=None):
        ctx.save_for_backward(f, d, w, b, noise)
        return adain_channel_gate(f, d, w, b, noise)

    @staticmethod
    def backward(ctx, g):
        f, d, w, b, noise = ctx.saved_tensors
        c = f.shape[-1]
        f2 = f.reshape(-1, c).float()
        d2 = d.reshape(-1, d.shape[-1]).float()
        g2 = g.reshape(-1, c).float()
        w32 = w.float()
        s = torch.sigmoid(d2 @ w32 + b.float())
        gn = g2 if noise is None else g2 * noise.reshape(-1).float()
        df = (gn * s).to(f.dtype).reshape(f.shape)
        dz = gn * f2 * s * (1.0 - s)
        dd = (dz @ w32.t()).to(d.dtype).reshape(d.shape)
        dw = (d2.t() @ dz).to(w.dtype)
        db = dz.sum(0).to(b.dtype)
        dnoise = (None if noise is None
                  else (g2 * s * f2).sum(0).to(noise.dtype).reshape(
                      noise.shape))
        return df, dd, dw, db, dnoise


def adain_gate_fn(f, d, w, b, noise: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """``AdainGateFn.apply``: the AdaIN gate with gradients."""
    return AdainGateFn.apply(f, d, w, b, noise)
