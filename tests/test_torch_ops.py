"""The PyTorch port's kernels: plain versions against the JAX functions.

Each CUDA kernel of ``dasa_tpu_torch/ops`` has a plain PyTorch version
that CPU tensors take.  Here the same numpy inputs go through the JAX
function (its Pallas kernel in interpret mode, as tests/test_ops.py runs
it) and through the port, in f32, with tests/test_ops.py's tolerances.
The kernels themselves are held against their plain versions on the card
in tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasa_tpu.ops.adain import adain_channel_gate as jax_adain
from dasa_tpu.ops.lstm import lstm_scan as jax_lstm_scan
from dasa_tpu.ops.shift_attention import shift_attend as jax_shift_attend
from dasa_tpu_torch.ops.adain import adain_channel_gate
from dasa_tpu_torch.ops.lstm import lstm_scan
from dasa_tpu_torch.ops.shift_attention import shift_attend


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
