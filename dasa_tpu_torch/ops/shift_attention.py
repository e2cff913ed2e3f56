"""Fused shift attention over the 36-view panorama: CUDA kernel and plain
version.

Port of the TPU kernel ``dasa_tpu/ops/shift_attention.py:_kernel_body``
(via ``shift_attend``): per batch row, logits against the query
projection, a softmax, the per-sample circular smoothing along the
heading ring of each of the 3 elevation rows, and the smoothed weighted
sum of the context.  The kernel (``csrc/shift_attend.cu``) runs as two
launches inside one call; its source note says what bounds it and how the
design answers.

:class:`ShiftAttendFn` is what the modules call: the kernel forward and,
backward, autograd through the f32 plain function, exactly as
``dasa_tpu/ops/shift_attention.py:_bwd`` (the TPU package has no backward
kernel for this op, so neither has the port).
"""

from __future__ import annotations

from typing import Tuple

import torch

from dasa_tpu_torch.ops import _build

WIDTH = 12  # headings per elevation row


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

    CPU tensors take the plain version; CUDA tensors launch the kernels
    of ``csrc/shift_attend.cu`` (bf16 only) or raise.  ``w_in`` and
    ``w_shift`` may be transposed views of contiguous (out, in) tensors
    (torch's Linear weights), which the kernels read without a copy."""
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
    if t % WIDTH or t > 64 or ks > 32 or c % 8 or hd % 8:
        raise ValueError(f"shift_attend: needs T a multiple of {WIDTH} up "
                         f"to 64, k <= 32 and C, H multiples of 8 (T={t}, "
                         f"k={ks}, C={c}, H={hd})")
    h, ctx, b_shift = h.contiguous(), ctx.contiguous(), b_shift.contiguous()
    wint = w_in.t().contiguous()
    wst = w_shift.t().contiguous()
    _build.require_cuda("shift_attend", h=h, ctx=ctx, w_in=wint,
                        w_shift=wst, b_shift=b_shift)
    lib = _build.library()
    ldt = (c + ks + 3) // 4 * 4
    tk = torch.empty(b, ldt, dtype=torch.float32, device=ctx.device)
    out = torch.empty(b, c, dtype=ctx.dtype, device=ctx.device)
    logit = torch.empty(b, t, dtype=torch.float32, device=ctx.device)
    rc = lib.dasa_shift_attend(
        h.data_ptr(), ctx.data_ptr(), wint.data_ptr(), wst.data_ptr(),
        b_shift.data_ptr(), tk.data_ptr(), out.data_ptr(), logit.data_ptr(),
        b, t, c, hd, ks, ldt, _build.sm_count(ctx), _build.stream_of(ctx))
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
    """Differentiable :func:`shift_attend`: the kernels forward; backward
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
