"""The PyTorch port's kernels: plain versions against the JAX functions.

Each CUDA kernel of ``dasa_tpu_torch/ops`` has a plain PyTorch version
that CPU tensors take.  Here the same numpy inputs go through the JAX
function (its Pallas kernel in interpret mode, as tests/test_ops.py runs
it) and through the port, in f32, with tests/test_ops.py's tolerances;
the autograd Functions' gradients go against ``jax.vjp`` of the JAX
functions' custom VJPs.  The kernels themselves are held against their
plain versions on the card in tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasa_tpu.ops.adain import adain_channel_gate as jax_adain
from dasa_tpu.ops.lstm import _bwd_call, _fwd_call
from dasa_tpu.ops.lstm import lstm_scan as jax_lstm_scan
from dasa_tpu.ops.shift_attention import shift_attend as jax_shift_attend
from dasa_tpu_torch.ops.adain import AdainGateFn, adain_channel_gate
from dasa_tpu_torch.ops.lstm import (
    LstmScanFn,
    bilstm_scan,
    bilstm_scan_fn,
    lstm_scan,
    lstm_scan_bwd,
    lstm_scan_bwd_ref,
)
from dasa_tpu_torch.ops.shift_attention import ShiftAttendFn, shift_attend


def _lstm_inputs(seed, t, b, h):
    rng = np.random.default_rng(seed)
    xw = (rng.standard_normal((t, b, 4 * h)) * 0.5).astype(np.float32)
    mask = np.ones((t, b), np.float32)
    for j in range(b):  # ragged: rows end at different tokens
        mask[t - 1 - j % 3:, j] = 0.0
    mask[:2, b - 1] = 0.0  # and a row whose first tokens are masked
    h0 = (rng.standard_normal((b, h)) * 0.3).astype(np.float32)
    c0 = (rng.standard_normal((b, h)) * 0.3).astype(np.float32)
    wh = (rng.standard_normal((h, 4 * h)) * 0.2).astype(np.float32)
    return xw, mask, h0, c0, wh


@pytest.mark.parametrize("seed,t,b,h", [(4, 7, 3, 8), (5, 12, 5, 16)])
def test_lstm_scan_matches_jax(seed, t, b, h):
    args = _lstm_inputs(seed, t, b, h)
    jh, jc = jax_lstm_scan(*(jnp.asarray(a) for a in args), True)
    th, tc = lstm_scan(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-6)
    # masked tokens pass the carry through
    hs, mask, h0 = th.numpy(), args[1], args[2]
    for j in range(b):
        for t_i in np.nonzero(mask[:, j] == 0)[0]:
            prev = hs[t_i - 1, j] if t_i > 0 else h0[j]
            np.testing.assert_array_equal(hs[t_i, j], prev)


@pytest.mark.parametrize("with_noise", [False, True])
def test_adain_gate_matches_jax(with_noise):
    rng = np.random.default_rng(0)
    b, l, c = 3, 36, 128
    f = rng.standard_normal((b, l, c)).astype(np.float32)
    d = rng.standard_normal((b, l, c)).astype(np.float32)
    w = (rng.standard_normal((c, c)) * 0.02).astype(np.float32)
    bb = (rng.standard_normal(c) * 0.1).astype(np.float32)
    noise = ((rng.random(c) > 0.3) / 0.7).astype(np.float32)
    nz = noise if with_noise else None
    ref = jax_adain(jnp.asarray(f), jnp.asarray(d), jnp.asarray(w),
                    jnp.asarray(bb), None if nz is None else jnp.asarray(nz),
                    True)
    out = adain_channel_gate(
        torch.from_numpy(f), torch.from_numpy(d), torch.from_numpy(w),
        torch.from_numpy(bb), None if nz is None else torch.from_numpy(nz))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("ks", [3, 5])
def test_shift_attend_matches_jax(ks):
    rng = np.random.default_rng(2)
    b, t, c, hdim = 4, 36, 64, 48
    h = rng.standard_normal((b, hdim)).astype(np.float32)
    ctx = rng.standard_normal((b, t, c)).astype(np.float32)
    w_in = (rng.standard_normal((hdim, c)) * 0.1).astype(np.float32)
    w_s = (rng.standard_normal((hdim, ks)) * 0.1).astype(np.float32)
    b_s = (rng.standard_normal(ks) * 0.1).astype(np.float32)
    j_out, j_logit = jax_shift_attend(
        *(jnp.asarray(a) for a in (h, ctx, w_in, w_s, b_s)), True)
    out, logit = shift_attend(
        *(torch.from_numpy(a) for a in (h, ctx, w_in, w_s, b_s)))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(logit.numpy(), np.asarray(j_logit),
                               rtol=2e-4, atol=2e-5)


def test_wrappers_take_transposed_weight_views():
    """The modules pass torch (out, in) weights as transposed views; the
    wrappers read them like the JAX (in, out) layout."""
    rng = np.random.default_rng(3)
    w_t = torch.from_numpy(rng.standard_normal((16, 16)).astype(np.float32))
    f, d = (torch.from_numpy(rng.standard_normal((5, 16)).astype(np.float32))
            for _ in range(2))
    b = torch.zeros(16)
    torch.testing.assert_close(adain_channel_gate(f, d, w_t.t(), b),
                               adain_channel_gate(f, d, w_t.t().clone(), b))


def _vjp_pair(jax_fn, torch_fn, inputs, cots):
    """Outputs and input cotangents of ``jax.vjp(jax_fn)`` and of autograd
    through ``torch_fn``, for the same numpy inputs and cotangents."""
    j_out, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in inputs))
    j_grads = vjp(tuple(jnp.asarray(c) for c in cots)
                  if isinstance(j_out, tuple) else jnp.asarray(cots[0]))
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    t_out = torch_fn(*leaves)
    t_grads = torch.autograd.grad(
        t_out, leaves, tuple(torch.from_numpy(c) for c in cots))
    return j_out, j_grads, t_out, t_grads


def _close_all(got, ref, **tol):
    got = got if isinstance(got, (tuple, list)) else (got,)
    ref = ref if isinstance(ref, (tuple, list)) else (ref,)
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   err_msg=f"output {i}", **tol)


@pytest.mark.parametrize("seed,t,b,h", [(4, 7, 3, 8), (5, 12, 5, 16)])
def test_lstm_scan_fn_grads_match_jax_vjp(seed, t, b, h):
    """LstmScanFn (forward with the gate activations, backward through the
    reverse-time kernel's plain version and one dWh product) against
    jax.vjp of the Pallas lstm_scan in interpret mode; ragged mask."""
    xw, mask, h0, c0, wh = _lstm_inputs(seed, t, b, h)
    rng = np.random.default_rng(seed + 10)
    cots = (rng.standard_normal((t, b, h)).astype(np.float32),
            rng.standard_normal((t, b, h)).astype(np.float32))
    j_out, j_grads, t_out, t_grads = _vjp_pair(
        lambda x, h_, c_, w: jax_lstm_scan(x, jnp.asarray(mask), h_, c_, w,
                                           True),
        lambda x, h_, c_, w: LstmScanFn.apply(x, torch.from_numpy(mask),
                                              h_, c_, w),
        (xw, h0, c0, wh), cots)
    _close_all(t_out, j_out, rtol=1e-5, atol=1e-6)
    _close_all(t_grads, j_grads, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seed,t,b,h", [(11, 7, 3, 8), (12, 12, 5, 16)])
def test_bilstm_scan_fn_matches_two_jax_lstm_scans(seed, t, b, h):
    """The two-direction entry and BiLstmScanFn (through their plain
    versions on the CPU) against two calls of the Pallas lstm_scan in
    interpret mode, one per direction: values, and gradients against
    jax.vjp.  The second direction's mask is the first's flipped in time
    (its masked tokens come first, as the BiLSTM's reverse direction)."""
    fwd, bwd = _lstm_inputs(seed, t, b, h), _lstm_inputs(seed + 1, t, b, h)
    xw, mask, h0, c0, wh = (np.stack(pair) for pair in zip(fwd, bwd))
    mask[1] = mask[1, ::-1].copy()
    rng = np.random.default_rng(seed + 20)
    cots = (rng.standard_normal((2, t, b, h)).astype(np.float32),
            rng.standard_normal((2, t, b, h)).astype(np.float32))

    def jax_pair(x, h_, c_, w):
        outs = [jax_lstm_scan(x[d], jnp.asarray(mask[d]), h_[d], c_[d], w[d],
                              True) for d in range(2)]
        return tuple(jnp.stack(o) for o in zip(*outs))

    j_out, j_grads, t_out, t_grads = _vjp_pair(
        jax_pair,
        lambda x, h_, c_, w: bilstm_scan_fn(x, torch.from_numpy(mask),
                                            h_, c_, w),
        (xw, h0, c0, wh), cots)
    _close_all(t_out, j_out, rtol=1e-5, atol=1e-6)
    _close_all(t_grads, j_grads, rtol=1e-4, atol=1e-5)
    args = [torch.from_numpy(a) for a in (xw, mask, h0, c0, wh)]
    _close_all(bilstm_scan(*args), j_out, rtol=1e-5, atol=1e-6)
    # the two directions' weights as a pair instead of a stacked tensor
    args[-1] = tuple(args[-1])
    _close_all(bilstm_scan(*args), j_out, rtol=1e-5, atol=1e-6)


def test_lstm_scan_bwd_ref_matches_bwd_call():
    """The plain version of the backward kernel against the Pallas
    ``_bwd_call`` in interpret mode, on the forward's own activations."""
    xw, mask, h0, c0, wh = _lstm_inputs(6, 9, 4, 16)
    _h, c_seq, acts = _fwd_call(*(jnp.asarray(a) for a in
                                  (xw, mask, h0, c0, wh)), True)
    c_prev = np.concatenate([c0[None], np.array(c_seq)[:-1]])
    rng = np.random.default_rng(7)
    g_h = rng.standard_normal(c_prev.shape).astype(np.float32)
    g_c = np.zeros_like(g_h)
    g_c[-1] = rng.standard_normal(g_h.shape[1:])
    args = (np.array(acts), c_prev, g_h, g_c, mask, wh)
    ref = _bwd_call(*(jnp.asarray(a) for a in args), True)
    got = lstm_scan_bwd(*(torch.from_numpy(a) for a in args))
    _close_all(got, ref, rtol=1e-5, atol=1e-6)
    _close_all(lstm_scan_bwd_ref(*(torch.from_numpy(a) for a in args)),
               ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("with_noise", [False, True])
def test_adain_gate_fn_grads_match_jax_vjp(with_noise):
    rng = np.random.default_rng(1)
    b, l, c = 2, 36, 64
    inputs = [rng.standard_normal((b, l, c)).astype(np.float32),
              rng.standard_normal((b, l, c)).astype(np.float32),
              (rng.standard_normal((c, c)) * 0.05).astype(np.float32),
              (rng.standard_normal(c) * 0.1).astype(np.float32)]
    if with_noise:
        inputs.append(((rng.random(c) > 0.3) / 0.7).astype(np.float32))
    cot = rng.standard_normal((b, l, c)).astype(np.float32)
    j_out, j_grads, t_out, t_grads = _vjp_pair(
        lambda *a: jax_adain(*a, *([None] * (5 - len(a))), True),
        AdainGateFn.apply, inputs, (cot,))
    _close_all(t_out, j_out, rtol=2e-5, atol=2e-5)
    _close_all(t_grads, j_grads, rtol=1e-4, atol=1e-5)


def test_shift_attend_fn_grads_match_jax_vjp():
    rng = np.random.default_rng(2)
    b, t, c, hdim, ks = 3, 36, 32, 24, 5
    inputs = (rng.standard_normal((b, hdim)).astype(np.float32),
              rng.standard_normal((b, t, c)).astype(np.float32),
              (rng.standard_normal((hdim, c)) * 0.1).astype(np.float32),
              (rng.standard_normal((hdim, ks)) * 0.1).astype(np.float32),
              (rng.standard_normal(ks) * 0.1).astype(np.float32))
    cots = (rng.standard_normal((b, c)).astype(np.float32),
            rng.standard_normal((b, t)).astype(np.float32))
    j_out, j_grads, t_out, t_grads = _vjp_pair(
        lambda *a: jax_shift_attend(*a, True), ShiftAttendFn.apply, inputs,
        cots)
    _close_all(t_out, j_out, rtol=2e-4, atol=2e-5)
    _close_all(t_grads, j_grads, rtol=2e-4, atol=2e-5)


def test_raw_entry_points_refuse_inputs_that_require_grad():
    """The raw kernel entry points return tensors without a grad_fn: with
    grad on they raise for an input that requires grad (the modules call
    the autograd Functions); without grad, or for plain inputs, they run."""
    xw, mask, h0, c0, wh = (torch.from_numpy(a)
                            for a in _lstm_inputs(8, 4, 2, 8))
    w_grad = wh.clone().requires_grad_()
    f = torch.ones(3, 16)
    w16 = torch.zeros(16, 16, requires_grad=True)
    h, ctx = torch.ones(2, 8), torch.ones(2, 36, 8)
    w_in = torch.zeros(8, 8, requires_grad=True)
    calls = (
        lambda w: lstm_scan(xw, mask, h0, c0, w),
        lambda w: bilstm_scan(xw[None].expand(2, -1, -1, -1), mask.expand(
            2, -1, -1), h0.expand(2, -1, -1), c0.expand(2, -1, -1),
            w[None].expand(2, -1, -1)),
        lambda w: lstm_scan_bwd(torch.zeros(4, 2, 32), torch.zeros(4, 2, 8),
                                torch.zeros(4, 2, 8), torch.zeros(4, 2, 8),
                                mask, w),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="autograd Function"):
            call(w_grad)
        call(wh)
        with torch.no_grad():
            call(w_grad)
    with pytest.raises(RuntimeError, match="autograd Function"):
        adain_channel_gate(f, f, w16, torch.zeros(16))
    with pytest.raises(RuntimeError, match="autograd Function"):
        shift_attend(h, ctx, w_in, torch.zeros(8, 3), torch.zeros(3))
