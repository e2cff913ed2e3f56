"""Masked multi-token LSTM recurrence: CUDA kernels, plain versions and
the autograd Function around them.

Ports of the TPU kernels ``dasa_tpu/ops/lstm.py:_fwd_kernel`` (K1, via
``_fwd_call``) and ``_bwd_kernel`` (K2, via ``_bwd_call``).  The
DicEncoder re-runs its top BiLSTM every policy step, two directions of 80
dependent tokens each.  The forward kernel (``csrc/lstm_fwd.cu``) keeps
each CTA's slice of the recurrence weights in shared memory for the whole
token loop, with a grid barrier per token, and can emit the gate
activations; the backward kernel (``csrc/lstm_bwd.cu``) consumes them,
walking the tokens in reverse with its slice of the weights resident
too, but exchanging each token's dgates through an exchange copy and
per-chunk readiness counters instead of a grid barrier.  The source
notes say what bounds each and how the design answers;
:func:`bwd_plan` is the backward's launch plan, in Python so that the
CPU tests reach it.

:class:`LstmScanFn` is what the modules call: K1 forward, K2 plus one
``torch.matmul`` for dWh backward, exactly as the JAX package's custom
VJP (``_lstm_fwd`` / ``_lstm_bwd``).  The raw entry points
:func:`lstm_scan` and :func:`lstm_scan_bwd` return tensors without a
``grad_fn``, so they refuse inputs that require grad while grad mode is
on.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from dasa_tpu_torch.ops import _build

# csrc/lstm_bwd.cu: units per CTA, threads (8 consumer warps + a producer
# warp), row padding of the resident Wh rows, batch rows (4 m16 tiles)
BWD_UNITS = 8
BWD_THREADS = 288
BWD_PAD = 8
BWD_MAX_B = 64
BWD_STAGES = 8  # the most ring stages a plan takes


class BwdPlan(NamedTuple):
    ctas: int             # H / 8: one CTA per 8 hidden units
    kc: int               # gate columns per chunk of the dxw row
    nchunks: int          # 4H / kc
    stages: int           # chunks in the shared-memory ring
    smem: int             # dynamic shared memory per CTA, bytes


def _align(x: int) -> int:
    return (x + 127) // 128 * 128


def _bwd_smem(t_len: int, b: int, hd: int, kc: int, stages: int) -> int:
    """Bytes of shared memory of ``lstm_bwd.cu:bwd_layout``."""
    mt = (b + 15) // 16
    total = _align(BWD_UNITS * (4 * hd + BWD_PAD) * 2)    # Wh rows
    total = _align(total + stages * b * kc * 2)           # ring
    total = _align(total + 2 * 7 * b * 16)                 # prefetch
    total = _align(total + t_len * b * 2)                  # mask
    for _ in range(3):                                     # dh, dc, dhm
        total = _align(total + b * BWD_UNITS * 4)
    total = _align(total + 8 * mt * 16 * BWD_UNITS * 4)    # partial sums
    return _align(total + 2 * stages * 8)                  # mbarriers


def bwd_plan(t_len: int, b: int, hd: int, n_sm: int) -> BwdPlan:
    """Launch plan of ``csrc/lstm_bwd.cu``; raises on shapes it cannot
    take, naming the constraint.  Every CTA must be resident at once (the
    launch is cooperative), so the plan takes at most one per SM."""
    if hd % 16:
        raise ValueError(f"lstm_scan_bwd: H={hd} must be a multiple of 16 "
                         "(8 units per CTA, 4H in chunks of 64 columns or "
                         "more)")
    if not 1 <= b <= BWD_MAX_B:
        raise ValueError(f"lstm_scan_bwd: B={b} must lie in 1..{BWD_MAX_B} "
                         "(four m16 tiles of batch rows)")
    ctas = hd // BWD_UNITS
    if ctas > n_sm:
        raise ValueError(f"lstm_scan_bwd: H={hd} needs {ctas} CTAs resident "
                         f"at once (8 units each), more than the {n_sm} SMs")
    kc = next(k for k in (512, 256, 128, 64) if (4 * hd) % k == 0)
    nchunks = 4 * hd // kc
    if nchunks > 32:
        raise ValueError(f"lstm_scan_bwd: H={hd} splits 4H into {nchunks} "
                         f"chunks of {kc} columns; at most 32 (one lane of "
                         "the producer warp each): take H a multiple of 128")
    stages = min(BWD_STAGES, nchunks)
    while (stages > 1
           and _bwd_smem(t_len, b, hd, kc, stages) > _build.MAX_SMEM):
        stages -= 1
    smem = _bwd_smem(t_len, b, hd, kc, stages)
    if smem > _build.MAX_SMEM:
        raise ValueError(
            f"lstm_scan_bwd: T={t_len}, B={b}, H={hd} needs {smem} bytes of "
            f"shared memory per CTA, more than the {_build.MAX_SMEM} a block "
            "may use (Wh rows 16 H, a chunk 2 B kc, the mask 2 T B)")
    return BwdPlan(ctas, kc, nchunks, stages, smem)


def _fwd_ref(xw, mask, h0, c0, wh):
    """The plain recurrence; returns (h_seq, c_seq, acts)."""
    hd = h0.shape[-1]
    h = h0.float()
    c = c0.float()
    w = wh.float()
    hs, cs, acts = [], [], []
    for t in range(xw.shape[0]):
        gates = xw[t].float() + h.to(wh.dtype).float() @ w
        i = torch.sigmoid(gates[:, :hd])
        f = torch.sigmoid(gates[:, hd:2 * hd])
        g = torch.tanh(gates[:, 2 * hd:3 * hd])
        o = torch.sigmoid(gates[:, 3 * hd:])
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        m = mask[t].float()[:, None]
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        hs.append(h.to(xw.dtype))
        cs.append(c.to(xw.dtype))
        acts.append(torch.cat([i, f, g, o], dim=-1).to(xw.dtype))
    return torch.stack(hs), torch.stack(cs), torch.stack(acts)


def lstm_scan_ref(xw, mask, h0, c0, wh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the same recurrence, token by token.

    xw (T, B, 4H) input projection + bias, gate order i, f, g, o;
    mask (T, B), 1.0 = valid token (a masked token passes the carry on);
    h0, c0 (B, H); wh (H, 4H).  The carry is f32; h enters the product in
    wh's dtype, accumulated in f32.  Returns the post-mask carry
    sequences (h_seq, c_seq), (T, B, H), in xw's dtype."""
    h_seq, c_seq, _acts = _fwd_ref(xw, mask, h0, c0, wh)
    return h_seq, c_seq


def lstm_scan_bwd_ref(acts, c_prev, g_h, g_c, mask, wh):
    """Plain version of the backward kernel, token by token in reverse,
    line for line ``dasa_tpu/ops/lstm.py:_bwd_kernel``.

    acts (T, B, 4H) gate activations; c_prev (T, B, H) the cell carry
    entering each token; g_h, g_c (T, B, H) cotangents of h_seq, c_seq;
    mask (T, B); wh (H, 4H).  f32 inside; the dgates enter the dh product
    in wh's dtype.  Returns (dxw (T, B, 4H) in acts' dtype, dh0, dc0
    (B, H) f32)."""
    hd = wh.shape[0]
    w = wh.float()
    dh = torch.zeros(acts.shape[1], hd, dtype=torch.float32,
                     device=acts.device)
    dc = torch.zeros_like(dh)
    dxw = []
    for t in reversed(range(acts.shape[0])):
        a = acts[t].float()
        i, f, g, o = (a[:, k * hd:(k + 1) * hd] for k in range(4))
        cp = c_prev[t].float()
        m = mask[t].float()[:, None]
        dh_tot = dh + g_h[t].float()
        dc_tot = dc + g_c[t].float()
        dh_new = m * dh_tot
        dc_new = m * dc_tot
        tc = torch.tanh(f * cp + i * g)
        dcn = dc_new + dh_new * o * (1.0 - tc * tc)
        dgates = torch.cat([(dcn * g) * i * (1.0 - i),
                            (dcn * cp) * f * (1.0 - f),
                            (dcn * i) * (1.0 - g * g),
                            dh_new * tc * o * (1.0 - o)], dim=-1)
        dxw.append(dgates.to(acts.dtype))
        dh = (1.0 - m) * dh_tot + dgates.to(wh.dtype).float() @ w.t()
        dc = (1.0 - m) * dc_tot + dcn * f
    return torch.stack(dxw[::-1]), dh, dc


def _units_per_cta(hidden: int, n_sm: int, least: int) -> int:
    """Hidden units per CTA: the fewest (at least ``least``) that put the
    whole grid on the SMs at once."""
    units = least
    while hidden % units or hidden // units > n_sm:
        units *= 2
        if units > hidden:
            raise ValueError(f"lstm_scan: no CTA split of H={hidden} fits "
                             f"{n_sm} SMs")
    return units


def _fwd_smem(b: int, hd: int, units: int, ksplit: int) -> int:
    """Bytes of shared memory of ``lstm_fwd.cu:lstm_layout``."""
    ld, mp, n = hd + 8, (b + 15) // 16 * 16, 4 * units
    total = _align(n * ld * 2)
    total = _align(total + mp * ld * 2)
    total = _align(total + ksplit * mp * n * 4)
    return _align(_align(total + b * units * 4) + b * units * 4)


def _check_shapes(name, t_len, b, hd, **shapes):
    for key, (got, want) in shapes.items():
        if tuple(got) != want:
            raise ValueError(f"{name}: {key} has shape {tuple(got)}, "
                             f"expected {want} (T={t_len}, B={b}, H={hd})")


def lstm_scan(xw, mask, h0, c0, wh, with_acts: bool = False):
    """Masked LSTM recurrence (see :func:`lstm_scan_ref` for the contract).

    Returns (h_seq, c_seq), plus the gate activations (T, B, 4H) in xw's
    dtype when ``with_acts`` (the TPU kernel's ``act_out``, which the
    backward consumes).  CPU tensors take the plain version; CUDA tensors
    launch the kernel of ``csrc/lstm_fwd.cu`` (bf16 only) or raise.
    ``wh`` may be a transposed view of a contiguous (4H, H) tensor
    (torch's ``weight_hh``), which the kernel reads without a copy."""
    _build.refuse_grad("lstm_scan", xw, mask, h0, c0, wh)
    if xw.device.type == "cpu":
        out = _fwd_ref(xw, mask, h0, c0, wh)
        return out if with_acts else out[:2]
    t_len, b, _g4 = xw.shape
    hd = h0.shape[-1]
    _check_shapes("lstm_scan", t_len, b, hd, xw=(xw.shape, (t_len, b, 4 * hd)),
                  mask=(mask.shape, (t_len, b)), h0=(h0.shape, (b, hd)),
                  c0=(c0.shape, (b, hd)), wh=(wh.shape, (hd, 4 * hd)))
    if hd % 16:
        raise ValueError(f"lstm_scan: H={hd} must be a multiple of 16")
    xw, mask, h0, c0 = (x.contiguous() for x in (xw, mask, h0, c0))
    wt = wh.t().contiguous()
    _build.require_cuda("lstm_scan", xw=xw, mask=mask, h0=h0, c0=c0, wh=wt)
    units = _units_per_cta(hd, _build.sm_count(xw), 4)
    tiles = ((b + 15) // 16) * (4 * units // 16)
    ksplit = max(1, min(8 // tiles, hd // 16))
    smem = _fwd_smem(b, hd, units, ksplit)
    if smem > _build.MAX_SMEM:
        raise ValueError(
            f"lstm_scan: B={b}, H={hd} needs {smem} bytes of shared memory "
            f"per CTA, more than the {_build.MAX_SMEM} a block may use (the "
            "h block grows with B)")
    lib = _build.library()
    h_seq = torch.empty(t_len, b, hd, dtype=xw.dtype, device=xw.device)
    c_seq = torch.empty_like(h_seq)
    acts = torch.empty_like(xw) if with_acts else None
    barrier = torch.empty(1, dtype=torch.int32, device=xw.device)
    rc = lib.dasa_lstm_fwd(
        xw.data_ptr(), mask.data_ptr(), h0.data_ptr(), c0.data_ptr(),
        wt.data_ptr(), h_seq.data_ptr(), c_seq.data_ptr(),
        None if acts is None else acts.data_ptr(), barrier.data_ptr(),
        t_len, b, hd, units, ksplit, _build.stream_of(xw))
    _build.check(rc, "lstm_scan")
    lstm_scan.launches += 1
    return (h_seq, c_seq, acts) if with_acts else (h_seq, c_seq)


lstm_scan.launches = 0


def lstm_scan_bwd(acts, c_prev, g_h, g_c, mask, wh):
    """Reverse-time LSTM backward (see :func:`lstm_scan_bwd_ref` for the
    contract).  CPU tensors take the plain version; CUDA tensors launch
    the kernel of ``csrc/lstm_bwd.cu`` (bf16 only) or raise.  ``wh`` may
    be a transposed view of a contiguous (4H, H) tensor."""
    _build.refuse_grad("lstm_scan_bwd", acts, c_prev, g_h, g_c, mask, wh)
    if acts.device.type == "cpu":
        return lstm_scan_bwd_ref(acts, c_prev, g_h, g_c, mask, wh)
    t_len, b, _g4 = acts.shape
    hd = wh.shape[0]
    seq = (t_len, b, hd)
    _check_shapes("lstm_scan_bwd", t_len, b, hd,
                  acts=(acts.shape, (t_len, b, 4 * hd)),
                  c_prev=(c_prev.shape, seq), g_h=(g_h.shape, seq),
                  g_c=(g_c.shape, seq), mask=(mask.shape, (t_len, b)),
                  wh=(wh.shape, (hd, 4 * hd)))
    acts, c_prev, g_h, g_c, mask = (
        x.contiguous() for x in (acts, c_prev, g_h, g_c, mask))
    wt = wh.t().contiguous()
    _build.require_cuda("lstm_scan_bwd", acts=acts, c_prev=c_prev, g_h=g_h,
                        g_c=g_c, mask=mask, wh=wt)
    plan = bwd_plan(t_len, b, hd, _build.sm_count(acts))
    lib = _build.library()
    dxw = torch.empty_like(acts)
    xr = torch.empty_like(acts)  # the kernel's exchange copy of dxw
    dh0 = torch.empty(b, hd, dtype=torch.float32, device=acts.device)
    dc0 = torch.empty_like(dh0)
    ready = torch.empty(plan.nchunks * 32, dtype=torch.int32,  # 128 B each
                        device=acts.device)
    rc = lib.dasa_lstm_bwd(
        acts.data_ptr(), c_prev.data_ptr(), g_h.data_ptr(), g_c.data_ptr(),
        mask.data_ptr(), wt.data_ptr(), dxw.data_ptr(), xr.data_ptr(),
        dh0.data_ptr(), dc0.data_ptr(), ready.data_ptr(), t_len, b, hd,
        plan.kc, plan.stages, _build.stream_of(acts))
    _build.check(rc, "lstm_scan_bwd")
    lstm_scan_bwd.launches += 1
    return dxw, dh0, dc0


lstm_scan_bwd.launches = 0


class LstmScanFn(torch.autograd.Function):
    """Differentiable :func:`lstm_scan`: the forward kernel (with its gate
    activations) forward; the backward kernel plus one ``torch.matmul``
    for dWh backward, as ``dasa_tpu/ops/lstm.py:_lstm_bwd``.  The
    backward takes c_prev / h_prev from the emitted (rounded) c_seq /
    h_seq, as the TPU package does, and gives ``mask`` a zero gradient."""

    @staticmethod
    def forward(ctx, xw, mask, h0, c0, wh):
        h_seq, c_seq, acts = lstm_scan(xw, mask, h0, c0, wh, with_acts=True)
        ctx.save_for_backward(mask, h0, c0, wh, h_seq, c_seq, acts)
        return h_seq, c_seq

    @staticmethod
    def backward(ctx, g_h, g_c):
        mask, h0, c0, wh, h_seq, c_seq, acts = ctx.saved_tensors
        dt = acts.dtype
        c_prev = torch.cat([c0[None].to(dt), c_seq[:-1]])
        dxw, dh0, dc0 = lstm_scan_bwd(acts, c_prev, g_h.to(dt), g_c.to(dt),
                                      mask, wh)
        # dWh as ONE product over all T*B rows (lstm.py:224-230)
        h_prev = torch.cat([h0[None].to(dt), h_seq[:-1]])
        rows = h_prev.shape[0] * h_prev.shape[1]
        dwh = torch.matmul(h_prev.reshape(rows, -1).t(),
                           dxw.reshape(rows, -1))
        return (dxw, torch.zeros_like(mask), dh0.to(h0.dtype),
                dc0.to(c0.dtype), dwh.to(wh.dtype))


def lstm_scan_fn(xw, mask, h0, c0, wh) -> Tuple[torch.Tensor, torch.Tensor]:
    """``LstmScanFn.apply``: the masked recurrence with gradients."""
    return LstmScanFn.apply(xw, mask, h0, c0, wh)
