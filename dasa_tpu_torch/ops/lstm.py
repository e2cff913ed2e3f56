"""Masked multi-token LSTM recurrence: CUDA kernel and plain version.

Port of the TPU kernel ``dasa_tpu/ops/lstm.py:_fwd_kernel`` (via
``_fwd_call`` / ``lstm_scan``).  The DicEncoder re-runs its top BiLSTM
every policy step, two directions of 80 dependent tokens each; the kernel
(``csrc/lstm_fwd.cu``) keeps each CTA's slice of the recurrence weights in
shared memory for the whole token loop, with a grid barrier per token.
The source note there says what bounds it and how the design answers.

Forward only: the backward kernel (``_bwd_kernel``) belongs to the
training slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Tuple

import torch

from dasa_tpu_torch.ops import _build


def lstm_scan_ref(xw, mask, h0, c0, wh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the same recurrence, token by token.

    xw (T, B, 4H) input projection + bias, gate order i, f, g, o;
    mask (T, B), 1.0 = valid token (a masked token passes the carry on);
    h0, c0 (B, H); wh (H, 4H).  The carry is f32; h enters the product in
    wh's dtype, accumulated in f32.  Returns the post-mask carry
    sequences (h_seq, c_seq), (T, B, H), in xw's dtype."""
    hd = h0.shape[-1]
    h = h0.float()
    c = c0.float()
    w = wh.float()
    hs, cs = [], []
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
    return torch.stack(hs), torch.stack(cs)


def _units_per_cta(hidden: int, n_sm: int) -> int:
    """Hidden units per CTA: the fewest (at least 4, for 16 gate columns)
    that put the whole grid on the SMs at once."""
    units = 4
    while hidden % units or hidden // units > n_sm:
        units *= 2
        if units > hidden:
            raise ValueError(f"lstm_scan: no CTA split of H={hidden} fits "
                             f"{n_sm} SMs")
    return units


def lstm_scan(xw, mask, h0, c0, wh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked LSTM recurrence (see :func:`lstm_scan_ref` for the contract).

    CPU tensors take the plain version; CUDA tensors launch the kernel of
    ``csrc/lstm_fwd.cu`` (bf16 only) or raise.  ``wh`` may be a transposed
    view of a contiguous (4H, H) tensor (torch's ``weight_hh``), which the
    kernel reads without a copy."""
    if xw.device.type == "cpu":
        return lstm_scan_ref(xw, mask, h0, c0, wh)
    t_len, b, g4 = xw.shape
    hd = h0.shape[-1]
    if g4 != 4 * hd or wh.shape != (hd, 4 * hd) or mask.shape != (t_len, b):
        raise ValueError(f"lstm_scan: shapes xw {tuple(xw.shape)}, mask "
                         f"{tuple(mask.shape)}, h0 {tuple(h0.shape)}, wh "
                         f"{tuple(wh.shape)} do not match")
    if hd % 16:
        raise ValueError(f"lstm_scan: H={hd} must be a multiple of 16")
    xw, mask, h0, c0 = (x.contiguous() for x in (xw, mask, h0, c0))
    wt = wh.t().contiguous()
    _build.require_cuda("lstm_scan", xw=xw, mask=mask, h0=h0, c0=c0, wh=wt)
    lib = _build.library()
    units = _units_per_cta(hd, _build.sm_count(xw))
    tiles = ((b + 15) // 16) * (4 * units // 16)
    ksplit = max(1, min(8 // tiles, hd // 16))
    h_seq = torch.empty(t_len, b, hd, dtype=xw.dtype, device=xw.device)
    c_seq = torch.empty_like(h_seq)
    barrier = torch.empty(1, dtype=torch.int32, device=xw.device)
    rc = lib.dasa_lstm_fwd(
        xw.data_ptr(), mask.data_ptr(), h0.data_ptr(), c0.data_ptr(),
        wt.data_ptr(), h_seq.data_ptr(), c_seq.data_ptr(),
        barrier.data_ptr(), t_len, b, hd, units, ksplit,
        _build.stream_of(xw))
    _build.check(rc, "lstm_scan")
    lstm_scan.launches += 1
    return h_seq, c_seq


lstm_scan.launches = 0
