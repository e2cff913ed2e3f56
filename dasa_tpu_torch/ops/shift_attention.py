"""Fused shift attention over the 36-view panorama: CUDA kernel and plain
version.

Port of the TPU kernel ``dasa_tpu/ops/shift_attention.py:_kernel_body``
(via ``shift_attend``): per batch row, logits against the query
projection, a softmax, the per-sample circular smoothing along the
heading ring of each of the 3 elevation rows, and the smoothed weighted
sum of the context.  The kernel (``csrc/shift_attend.cu``) is one
cooperative launch that spreads the context's C columns over the card;
its source note says what bounds it and how the design answers, and
:func:`shift_plan` is its launch plan, in Python so that the CPU tests
reach it.

:class:`ShiftAttendFn` is what the modules call: the kernel forward and,
backward, autograd through the f32 plain function, exactly as
``dasa_tpu/ops/shift_attention.py:_bwd`` (the TPU package has no backward
kernel for this op, so neither has the port).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from dasa_tpu_torch.ops import _build

WIDTH = 12  # headings per elevation row
# csrc/shift_attend.cu: threads (16 warps), row padding of h and the
# weight rows, batch rows (eight n8 tiles)
SHIFT_THREADS = 512
SHIFT_WARPS = SHIFT_THREADS // 32
SHIFT_PAD = 8
SHIFT_MAX_B = 64


class ShiftPlan(NamedTuple):
    sw: int               # columns of C per CTA (a multiple of 8)
    ctas: int             # ceil(C / sw), one per SM at most
    smem: int             # dynamic shared memory per CTA, bytes


def _align(x: int) -> int:
    return (x + 127) // 128 * 128


def _shift_smem(b: int, t: int, hd: int, ks: int, sw: int) -> int:
    """Bytes of shared memory of ``shift_attend.cu:shift_layout``."""
    mt = (sw + ks + 15) // 16                  # m16 tiles of weight rows
    kg = SHIFT_WARPS // mt                     # k groups
    ldr = (-(-b // 8) * 8 + 31) // 32 * 32 + 8
    h_bytes = b * (hd + SHIFT_PAD) * 2
    red_bytes = kg * mt * 16 * ldr * 4        # partial products, in h's place
    total = _align(max(h_bytes, red_bytes))
    total = _align(total + (sw + ks) * (hd + SHIFT_PAD) * 2)  # weight rows
    total = _align(total + b * t * sw * 2)           # ctx slice
    total = _align(total + b * mt * 16 * 4)          # target, shift logits
    return _align(total + 2 * b * t * 4)             # logits, smoothed


def shift_plan(b: int, t: int, c: int, hd: int, ks: int, n_sm: int
               ) -> ShiftPlan:
    """Launch plan of ``csrc/shift_attend.cu``: the narrowest slice of C
    (a multiple of 8 columns) that keeps one CTA per SM, since every CTA
    must be resident at once (the launch is cooperative).  Raises on
    shapes the kernel cannot take, naming the constraint."""
    if t % WIDTH or not 0 < t <= 64:
        raise ValueError(f"shift_attend: T={t} must be a multiple of {WIDTH} "
                         "up to 64 (elevation rows of 12 headings)")
    if not 1 <= ks <= 32:
        raise ValueError(f"shift_attend: k={ks} must lie in 1..32")
    if c % 8 or hd % 16:
        raise ValueError(f"shift_attend: C={c} must be a multiple of 8 and "
                         f"H={hd} of 16 (16-byte rows, k16 steps)")
    if not 1 <= b <= SHIFT_MAX_B:
        raise ValueError(f"shift_attend: B={b} must lie in "
                         f"1..{SHIFT_MAX_B} (four m16 tiles of batch rows)")
    sw = 8 * -(-c // (8 * n_sm))
    if sw + ks > 16 * SHIFT_WARPS:
        raise ValueError(f"shift_attend: C={c} over {n_sm} SMs gives slices "
                         f"of {sw} columns; with k={ks} more than the "
                         f"{16 * SHIFT_WARPS} weight rows a CTA takes")
    smem = _shift_smem(b, t, hd, ks, sw)
    if smem > _build.MAX_SMEM:
        raise ValueError(
            f"shift_attend: B={b}, T={t}, H={hd} needs {smem} bytes of "
            f"shared memory per CTA, more than the {_build.MAX_SMEM} a block "
            "may use (h 2 B H, the weight rows 2 (sw + k) H, ctx 2 B T sw)")
    return ShiftPlan(sw, -(-c // sw), smem)


def shift_smooth(attn, kernel, width: int = WIDTH):
    """(B, 3*width) attention, (B, k) per-sample kernel -> smoothed by
    circular cross-correlation along the heading ring."""
    b, n = attn.shape
    ks = kernel.shape[1]
    pad = ks // 2
    rows = attn.reshape(b, n // width, width)
    ring = torch.cat([rows[:, :, width - pad:], rows, rows[:, :, :pad]],
                     dim=-1)
    out = sum(ring[:, :, i:i + width] * kernel[:, i][:, None, None]
              for i in range(ks))
    return out.reshape(b, n)


def shift_attend_ref(h, ctx, w_in, w_shift, b_shift
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version.  h (B, H); ctx (B, T, C) with T = 3 * 12;
    w_in (H, C) and w_shift (H, k) in the JAX layout (in, out);
    b_shift (k,).  Products accumulate in f32 from the given dtypes; the
    smoothed attention is rounded to ctx's dtype before the weighted sum,
    and the output to ctx's dtype — the TPU kernel's arithmetic.
    Returns (weighted context (B, C), raw f32 logits (B, T))."""
    hf = h.float()
    target = hf @ w_in.float()
    logit = torch.einsum("btc,bc->bt", ctx.float(), target)
    attn = torch.softmax(logit, dim=-1)
    kern = torch.softmax(hf @ w_shift.float() + b_shift.float(), dim=-1)
    sm = shift_smooth(attn, kern).to(ctx.dtype).float()
    out = torch.einsum("bt,btc->bc", sm, ctx.float())
    return out.to(ctx.dtype), logit


def shift_attend(h, ctx, w_in, w_shift, b_shift
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused shift attention (see :func:`shift_attend_ref`).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    of ``csrc/shift_attend.cu`` (bf16 only) or raise.  ``w_in`` and
    ``w_shift`` may be transposed views of contiguous (out, in) tensors
    (torch's Linear weights), which the kernel reads without a copy."""
    _build.refuse_grad("shift_attend", h, ctx, w_in, w_shift, b_shift)
    if ctx.device.type == "cpu":
        return shift_attend_ref(h, ctx, w_in, w_shift, b_shift)
    b, t, c = ctx.shape
    hd = h.shape[-1]
    ks = w_shift.shape[-1]
    if (h.shape != (b, hd) or w_in.shape != (hd, c)
            or w_shift.shape != (hd, ks) or b_shift.shape != (ks,)):
        raise ValueError(f"shift_attend: shapes h {tuple(h.shape)}, ctx "
                         f"{tuple(ctx.shape)}, w_in {tuple(w_in.shape)}, "
                         f"w_shift {tuple(w_shift.shape)} do not match")
    plan = shift_plan(b, t, c, hd, ks, _build.sm_count(ctx))
    h, ctx, b_shift = h.contiguous(), ctx.contiguous(), b_shift.contiguous()
    wint = w_in.t().contiguous()
    wst = w_shift.t().contiguous()
    _build.require_cuda("shift_attend", h=h, ctx=ctx, w_in=wint,
                        w_shift=wst, b_shift=b_shift)
    lib = _build.library()
    out = torch.empty(b, c, dtype=ctx.dtype, device=ctx.device)
    logit = torch.empty(b, t, dtype=torch.float32, device=ctx.device)
    part = torch.empty(plan.ctas, b * t, dtype=torch.float32,
                       device=ctx.device)  # each slice's partial logits
    rc = lib.dasa_shift_attend(
        h.data_ptr(), ctx.data_ptr(), wint.data_ptr(), wst.data_ptr(),
        b_shift.data_ptr(), out.data_ptr(), logit.data_ptr(), part.data_ptr(),
        _build.counters(ctx, 3).data_ptr(), b, t, c, hd, ks, plan.sw,
        _build.stream_of(ctx))
    _build.check(rc, "shift_attend")
    shift_attend.launches += 1
    return out, logit


shift_attend.launches = 0


def _shift_attend_f32(h, ctx, w_in, w_shift, b_shift):
    """``shift_attention.py:_bwd``'s forward: every product in f32, the
    weighted context rounded to ctx's dtype at the end."""
    hf = h.float()
    target = hf @ w_in.float()
    logit = torch.einsum("btc,bc->bt", ctx.float(), target)
    attn = torch.softmax(logit, dim=-1)
    kern = torch.softmax(hf @ w_shift.float() + b_shift.float(), dim=-1)
    weighted = torch.einsum("bt,btc->bc", shift_smooth(attn, kern),
                            ctx.float())
    return weighted.to(ctx.dtype), logit


class ShiftAttendFn(torch.autograd.Function):
    """Differentiable :func:`shift_attend`: the kernel forward; backward
    through the f32 plain function (``shift_attention.py:_bwd``)."""

    @staticmethod
    def forward(ctx, h, context, w_in, w_shift, b_shift):
        ctx.save_for_backward(h, context, w_in, w_shift, b_shift)
        return shift_attend(h, context, w_in, w_shift, b_shift)

    @staticmethod
    def backward(ctx, g_out, g_logit):
        inputs = [x.detach().requires_grad_() for x in ctx.saved_tensors]
        with torch.enable_grad():
            outs = _shift_attend_f32(*inputs)
        return torch.autograd.grad(outs, inputs, (g_out, g_logit))


def shift_attend_fn(h, ctx, w_in, w_shift, b_shift
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ShiftAttendFn.apply``: the shift attention with gradients."""
    return ShiftAttendFn.apply(h, ctx, w_in, w_shift, b_shift)
