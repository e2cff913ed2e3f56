"""Masked multi-token LSTM recurrence: CUDA kernels, plain versions and
the autograd Functions around them.

Ports of the TPU kernels ``dasa_tpu/ops/lstm.py:_fwd_kernel`` (K1, via
``_fwd_call``) and ``_bwd_kernel`` (K2, via ``_bwd_call``).  The
DicEncoder re-runs its top BiLSTM every policy step, two directions of 80
dependent tokens each.  Both kernels keep each CTA's slice of the
recurrence weights in shared memory for the whole token loop and pass
each token's row (h forward, dgates backward) between CTAs through an
exchange copy and readiness counters; the forward
(``csrc/lstm_fwd.cu``) can emit the gate activations, which the backward
(``csrc/lstm_bwd.cu``) consumes, and runs one or both directions of a
BiLSTM in one launch.  The source notes say what bounds each and how the
design answers; :func:`fwd_plan` and :func:`bwd_plan` are their launch
plans, in Python so that the CPU tests reach them.

:class:`BiLstmScanFn` is what the BiLSTM calls: K1 forward for both
directions at once, K2 per direction plus one batched product for dWh
backward, as the JAX package's custom VJP (``_lstm_fwd`` / ``_lstm_bwd``)
does per direction; :class:`LstmScanFn` is the same for one direction.
The raw entry points :func:`lstm_scan`, :func:`bilstm_scan` and
:func:`lstm_scan_bwd` return tensors without a ``grad_fn``, so they
refuse inputs that require grad while grad mode is on.
"""

from __future__ import annotations

import functools
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


# csrc/lstm_fwd.cu: threads (8 consumer warps + a producer warp), row
# padding of the resident Wh rows, batch rows (four m16 tiles), the most
# batch rows both directions take in one launch, and the units a CTA may
# own (the fewest that fit the SMs)
FWD_THREADS = 288
FWD_PAD = 8
FWD_MAX_B = 64
FWD_PAIR_MAX_B = 32
FWD_UNITS = (8, 16)


class FwdPlan(NamedTuple):
    units: int            # hidden units per CTA
    ctas: int             # CTAs per launch: directions per launch * H / units
    smem: int             # dynamic shared memory per CTA, bytes
    launches: int         # 1, or one launch per direction (B > 32)


def _fwd_rows(b: int) -> int:
    """Batch rows of the kernel's h row: 32, or the batch's m16 tiles."""
    return FWD_PAIR_MAX_B if b <= FWD_PAIR_MAX_B else (b + 15) // 16 * 16


def _fwd_smem(t_len: int, b: int, hd: int, units: int) -> int:
    """Bytes of shared memory of ``lstm_fwd.cu:fwd_layout``: when the k
    groups' partial sums do not fit beside the h row, they go inside it."""
    row = _fwd_rows(b) * hd * 2
    sums = (32 // units) * b * (4 * units + 4) * 4
    total = _align(4 * units * (hd + FWD_PAD) * 2)        # Wh rows
    total = _align(total + row)                            # the h row
    total = _align(total + 2 * b * 4 * units * 2)          # xw prefetch
    total = _align(total + t_len * b * 2)                  # mask
    if _align(_align(total + sums) + 2 * 8) > _build.MAX_SMEM and sums <= row:
        return _align(total + 2 * 8)                       # sums in the row
    return _align(_align(total + sums) + 2 * 8)            # sums, mbarriers


def fwd_plan(t_len: int, b: int, hd: int, n_sm: int, dirs: int = 1
             ) -> FwdPlan:
    """Launch plan of ``csrc/lstm_fwd.cu`` for ``dirs`` independent
    recurrences; raises on shapes it cannot take, naming the constraint.
    Every CTA must be resident at once (the launch is cooperative), so the
    plan takes the fewest units per CTA (8, else 16) that keep the grid
    within one CTA per SM.  Up to 32 batch rows, both directions share one
    launch; above, the h row outgrows the room beside both directions'
    weights, and each direction takes its own launch of 8 units a CTA."""
    if hd % 64:
        raise ValueError(f"lstm_scan: H={hd} must be a multiple of 64 "
                         "(k ranges of the 8 warps, swizzle groups of h)")
    if not 1 <= b <= FWD_MAX_B:
        raise ValueError(f"lstm_scan: B={b} must lie in 1..{FWD_MAX_B} "
                         "(four m16 tiles of batch rows)")
    if dirs not in (1, 2):
        raise ValueError(f"lstm_scan: {dirs} directions; one or two")
    pair = b <= FWD_PAIR_MAX_B
    per_launch = dirs if pair else 1
    choices = FWD_UNITS if pair else FWD_UNITS[:1]
    units = next((u for u in choices if per_launch * hd // u <= n_sm), None)
    if units is None:
        raise ValueError(
            f"lstm_scan: {per_launch} direction(s) of H={hd} in a launch "
            f"need {per_launch * hd // choices[-1]} CTAs resident at once "
            f"({choices[-1]} units each), more than the {n_sm} SMs")
    smem = _fwd_smem(t_len, b, hd, units)
    if smem > _build.MAX_SMEM:
        raise ValueError(
            f"lstm_scan: T={t_len}, B={b}, H={hd} needs {smem} bytes of "
            f"shared memory per CTA, more than the {_build.MAX_SMEM} a block "
            f"may use (Wh rows {8 * units} H, the h row "
            f"{2 * _fwd_rows(b)} H, the mask 2 T B)")
    return FwdPlan(units, per_launch * hd // units, smem,
                   dirs // per_launch)


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


def _check_shapes(name, t_len, b, hd, **shapes):
    for key, (got, want) in shapes.items():
        if tuple(got) != want:
            raise ValueError(f"{name}: {key} has shape {tuple(got)}, "
                             f"expected {want} (T={t_len}, B={b}, H={hd})")


def _fwd_launch(xw, mask, h0, c0, wts, with_acts):
    """Launch ``csrc/lstm_fwd.cu`` for ``len(wts)`` directions stacked on
    the leading axis of xw (dirs, T, B, 4H), mask (dirs, T, B) and h0, c0
    (dirs, B, H); ``wts`` holds each direction's contiguous (4H, H) Wh^T."""
    dirs, t_len, b, _g4 = xw.shape
    hd = h0.shape[-1]
    _build.require_cuda("lstm_scan", xw=xw, mask=mask, h0=h0, c0=c0,
                        **{f"wh[{d}]": w for d, w in enumerate(wts)})
    plan = fwd_plan(t_len, b, hd, _build.sm_count(xw), dirs)
    lib = _build.library()  # dasa_lstm_fwd makes the plan's launches
    h_seq = torch.empty(dirs, t_len, b, hd, dtype=xw.dtype, device=xw.device)
    c_seq = torch.empty_like(h_seq)
    acts = torch.empty_like(xw) if with_acts else None
    xr = torch.empty(dirs, t_len + 1, b, hd, dtype=xw.dtype,
                     device=xw.device)  # the kernel's exchange copy of h
    ready = torch.empty(dirs * 32, dtype=torch.int32,
                        device=xw.device)  # a counter per direction
    rc = lib.dasa_lstm_fwd(
        xw.data_ptr(), mask.data_ptr(), h0.data_ptr(), c0.data_ptr(),
        wts[0].data_ptr(), wts[-1].data_ptr(), h_seq.data_ptr(),
        c_seq.data_ptr(), None if acts is None else acts.data_ptr(),
        xr.data_ptr(), ready.data_ptr(), t_len, b, hd, plan.units, dirs,
        _build.stream_of(xw))
    _build.check(rc, "lstm_scan")
    return h_seq, c_seq, acts, plan.launches


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
    h_seq, c_seq, acts, launches = _fwd_launch(
        *(_build.aligned(x)[None] for x in (xw, mask, h0, c0)),
        [_build.aligned(wh.t())], with_acts)
    lstm_scan.launches += launches
    if with_acts:
        return h_seq[0], c_seq[0], acts[0]
    return h_seq[0], c_seq[0]


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
        _build.aligned(x) for x in (acts, c_prev, g_h, g_c, mask))
    wt = _build.aligned(wh.t())
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


@functools.lru_cache(maxsize=None)
def max_chunk_rows(t_len: int, hd: int, dirs: int, n_sm: int) -> int:
    """The most batch rows one launch takes at this T, H and direction
    count on a card of ``n_sm`` SMs: the largest b <= FWD_MAX_B such that
    :func:`fwd_plan` and :func:`bwd_plan` take every b' <= b (the kernels
    hold the (T, B) mask in shared memory, so a long T leaves room for
    fewer rows: 48 at T 300, H 1024 on an H100).  Raises the plan's error
    when not even one row fits."""
    best = 0
    for b in range(1, FWD_MAX_B + 1):
        try:
            fwd_plan(t_len, b, hd, n_sm, dirs)
            bwd_plan(t_len, b, hd, n_sm)
        except ValueError:
            if best == 0:
                raise
            break
        best = b
    return best


def row_chunks(b: int, t_len: int, hd: int, dirs: int, n_sm: int) -> int:
    """How many near-equal chunks ``b`` batch rows run in
    (:func:`max_chunk_rows` rows at most each)."""
    return -(-b // max_chunk_rows(t_len, hd, dirs, n_sm))


def _chunks_of(xw, axis, hd, dirs) -> int:
    """Chunks of :func:`_in_row_chunks` for this call: by the plans on the
    card, by FWD_MAX_B rows on the CPU (the plain version has no plan)."""
    b = xw.shape[axis]
    if xw.device.type != "cuda":
        return -(-b // FWD_MAX_B)
    return row_chunks(b, xw.shape[axis - 1], hd, dirs, _build.sm_count(xw))


def _in_row_chunks(fn, n, axis, xw, mask, h0, c0, wh):
    """``fn`` over ``n`` near-equal chunks of the batch rows, each through
    the same kernels and its own autograd node (the rows are independent
    recurrences); ``axis`` is the batch axis of xw and mask, h0 and c0
    have theirs one before it."""
    parts = zip(*(x.tensor_split(n, dim) for x, dim in
                  ((xw, axis), (mask, axis), (h0, axis - 1), (c0, axis - 1))))
    outs = [fn(*p, wh) for p in parts]
    return tuple(torch.cat(o, axis) for o in zip(*outs))


def lstm_scan_fn(xw, mask, h0, c0, wh) -> Tuple[torch.Tensor, torch.Tensor]:
    """``LstmScanFn.apply``: the masked recurrence with gradients.  A pure
    forward (grad mode off, or no input requiring grad) calls
    :func:`lstm_scan` directly, as :func:`bilstm_scan_fn` does.  More batch
    rows than one launch takes at this T (:func:`max_chunk_rows`) run in
    chunks (:func:`_in_row_chunks`)."""
    n = _chunks_of(xw, 1, h0.shape[-1], 1)
    if n > 1:
        return _in_row_chunks(lstm_scan_fn, n, 1, xw, mask, h0, c0, wh)
    if not (torch.is_grad_enabled()
            and any(x.requires_grad for x in (xw, h0, c0, wh))):
        return lstm_scan(xw, mask, h0, c0, wh)
    return LstmScanFn.apply(xw, mask, h0, c0, wh)


def bilstm_scan_ref(xw, mask, h0, c0, wh):
    """Plain version of :func:`bilstm_scan` (``wh`` stacked or a pair):
    :func:`_fwd_ref` for each direction; returns stacked (h_seq, c_seq,
    acts)."""
    outs = [_fwd_ref(xw[d], mask[d], h0[d], c0[d], wh[d]) for d in range(2)]
    return tuple(torch.stack(o) for o in zip(*outs))


def bilstm_scan(xw, mask, h0, c0, wh, with_acts: bool = False):
    """Both directions of a BiLSTM in one launch: two independent masked
    recurrences (each :func:`lstm_scan`'s contract) stacked on a leading
    axis of 2 -- xw (2, T, B, 4H), mask (2, T, B), h0 and c0 (2, B, H),
    and wh (2, H, 4H), or a pair of (H, 4H) tensors (the two directions'
    weights without a stacked copy).  Returns stacked (h_seq, c_seq)
    (2, T, B, H), plus the gate activations (2, T, B, 4H) when
    ``with_acts``.  CPU tensors take the plain version; CUDA tensors launch
    ``csrc/lstm_fwd.cu`` with each direction on its own CTAs (one launch up
    to 32 batch rows, one per direction above), or raise.
    Each direction's wh may be the transposed view of a contiguous
    (4H, H) tensor, read without a copy."""
    _build.refuse_grad("bilstm_scan", xw, mask, h0, c0, *wh)
    if xw.device.type == "cpu":
        out = bilstm_scan_ref(xw, mask, h0, c0, wh)
        return out if with_acts else out[:2]
    _dirs, t_len, b, _g4 = xw.shape
    hd = h0.shape[-1]
    _check_shapes("bilstm_scan", t_len, b, hd,
                  xw=(xw.shape, (2, t_len, b, 4 * hd)),
                  mask=(mask.shape, (2, t_len, b)),
                  h0=(h0.shape, (2, b, hd)), c0=(c0.shape, (2, b, hd)),
                  wh=((len(wh), *wh[0].shape, *wh[-1].shape),
                      (2, hd, 4 * hd, hd, 4 * hd)))
    *out, launches = _fwd_launch(
        *(_build.aligned(x) for x in (xw, mask, h0, c0)),
        [_build.aligned(wh[d].t()) for d in range(2)], with_acts)
    bilstm_scan.launches += launches
    return tuple(out) if with_acts else tuple(out[:2])


bilstm_scan.launches = 0


class BiLstmScanFn(torch.autograd.Function):
    """Differentiable :func:`bilstm_scan`, the directions' weights wh_f and
    wh_b (H, 4H) passed apart: both directions forward in one launch (with
    the gate activations); backward, the backward kernel once per
    direction plus one batched product for both dWh, as
    :class:`LstmScanFn` does for one."""

    @staticmethod
    def forward(ctx, xw, mask, h0, c0, wh_f, wh_b):
        h_seq, c_seq, acts = bilstm_scan(xw, mask, h0, c0, (wh_f, wh_b),
                                         with_acts=True)
        ctx.save_for_backward(mask, h0, c0, wh_f, wh_b, h_seq, c_seq, acts)
        return h_seq, c_seq

    @staticmethod
    def backward(ctx, g_h, g_c):
        mask, h0, c0, wh_f, wh_b, h_seq, c_seq, acts = ctx.saved_tensors
        dt = acts.dtype
        c_prev = torch.cat([c0[:, None].to(dt), c_seq[:, :-1]], 1)
        g_h, g_c = g_h.to(dt), g_c.to(dt)
        dxw, dh0, dc0 = (torch.stack(x) for x in zip(*(
            lstm_scan_bwd(acts[d], c_prev[d], g_h[d], g_c[d], mask[d], w)
            for d, w in enumerate((wh_f, wh_b)))))
        h_prev = torch.cat([h0[:, None].to(dt), h_seq[:, :-1]], 1)
        rows = h_prev.shape[1] * h_prev.shape[2]
        dwh = torch.bmm(h_prev.reshape(2, rows, -1).transpose(1, 2),
                        dxw.reshape(2, rows, -1))
        return (dxw, torch.zeros_like(mask), dh0.to(h0.dtype),
                dc0.to(c0.dtype), dwh[0].to(wh_f.dtype),
                dwh[1].to(wh_b.dtype))


def bilstm_scan_fn(xw, mask, h0, c0, wh) -> Tuple[torch.Tensor, torch.Tensor]:
    """``BiLstmScanFn.apply``: both directions with gradients; ``wh`` is a
    (2, H, 4H) tensor or a pair of (H, 4H) tensors.  A pure forward (grad
    mode off, or no input requiring grad) calls :func:`bilstm_scan`
    directly: no gate activations are written and no autograd node
    holds the outputs.  More batch rows than one launch takes at this T
    (:func:`max_chunk_rows`) run in chunks (:func:`_in_row_chunks`)."""
    n = _chunks_of(xw, 2, h0.shape[-1], 2)
    if n > 1:
        return _in_row_chunks(bilstm_scan_fn, n, 2, xw, mask, h0, c0, wh)
    if not (torch.is_grad_enabled()
            and any(x.requires_grad for x in (xw, h0, c0, wh[0], wh[1]))):
        return bilstm_scan(xw, mask, h0, c0, wh)
    return BiLstmScanFn.apply(xw, mask, h0, c0, wh[0], wh[1])
