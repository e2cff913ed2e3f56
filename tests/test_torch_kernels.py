"""The port's CUDA kernels against their plain versions, on the card.

These cases need an NVIDIA GPU with the CUDA toolkit: each builds the
kernels (``dasa_tpu_torch/ops/_build.py``) and compares a kernel with its
plain PyTorch version on the same bf16 inputs.  Without a card they skip.
The file imports no JAX, so on a machine without it run it past the
JAX-forcing tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from dasa_tpu_torch.ops import _build
from dasa_tpu_torch.ops.adain import (
    adain_channel_gate,
    adain_channel_gate_ref,
    adain_plan,
)
from dasa_tpu_torch.ops.lstm import (
    LstmScanFn,
    _bwd_smem,
    _fwd_ref,
    _fwd_smem,
    bilstm_scan,
    bilstm_scan_fn,
    bilstm_scan_ref,
    bwd_plan,
    fwd_plan,
    lstm_scan,
    lstm_scan_bwd,
    lstm_scan_bwd_ref,
    lstm_scan_ref,
)
from dasa_tpu_torch.ops.shift_attention import (
    _shift_smem,
    shift_attend,
    shift_attend_ref,
    shift_plan,
)


@pytest.fixture
def cuda():
    """Decided per test, never at import: the kernels run only on a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


def _lstm_inputs(seed, t, b, h):
    rng = np.random.default_rng(seed)
    xw = (rng.standard_normal((t, b, 4 * h)) * 0.5).astype(np.float32)
    mask = np.ones((t, b), np.float32)
    for j in range(b):  # ragged: rows end at different tokens
        mask[t - 1 - j % 3:, j] = 0.0
    h0 = (rng.standard_normal((b, h)) * 0.3).astype(np.float32)
    c0 = (rng.standard_normal((b, h)) * 0.3).astype(np.float32)
    wh = (rng.standard_normal((h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    return xw, mask, h0, c0, wh


@pytest.mark.cuda
@pytest.mark.parametrize("b,h", [(3, 64), (20, 256)])
def test_lstm_kernel_matches_plain_on_card(cuda, b, h):
    xw, mask, h0, c0, wh = (torch.from_numpy(a).cuda().bfloat16()
                            for a in _lstm_inputs(7, 16, b, h))
    got = lstm_scan(xw, mask, h0, c0, wh)
    ref = lstm_scan_ref(xw, mask, h0, c0, wh)
    for g, r in zip(got, ref):  # bf16 outputs: a few ulps after 16 steps
        torch.testing.assert_close(g.float(), r.float(), atol=2e-2,
                                   rtol=2e-2)


def _rel_close(got, ref, rtol):
    """max |got - ref| within rtol of max |ref| (f32)."""
    got, ref = got.float(), ref.float()
    assert bool(got.isfinite().all())
    err = float((got - ref).abs().max())
    assert err <= rtol * float(ref.abs().max()) + 1e-6, err


def _bwd_args(b, h, t=16):
    """Inputs of the backward from the plain forward (ragged mask)."""
    xw, mask, h0, c0, wh = (torch.from_numpy(a).cuda().bfloat16()
                            for a in _lstm_inputs(7, t, b, h))
    _h, c_seq, acts = _fwd_ref(xw, mask, h0, c0, wh)
    g = torch.Generator().manual_seed(b)
    g_h = (torch.randn(t, b, h, generator=g) * 0.1).cuda().bfloat16()
    g_c = torch.zeros_like(g_h)
    g_c[-1] = g_h[0]
    return acts, torch.cat([c0[None], c_seq[:-1]]), g_h, g_c, mask, wh


@pytest.mark.cuda
@pytest.mark.parametrize("b,h", [(3, 64), (20, 256), (20, 1024), (32, 1024)])
def test_lstm_bwd_kernel_matches_plain_on_card(cuda, b, h):
    args = _bwd_args(b, h)
    # the same f32 arithmetic; a bf16 dgate may round one ulp apart
    for got, ref in zip(lstm_scan_bwd(*args), lstm_scan_bwd_ref(*args)):
        _rel_close(got, ref, 2e-2)


def _fwd_inputs(seed, t, b, h, dirs):
    """Stacked inputs of ``dirs`` directions: ragged masks, the second
    direction's flipped (its masked tokens first), and with B >= 2 a row
    masked at every token."""
    xw, mask, h0, c0, wh = (np.stack(a) for a in zip(
        *(_lstm_inputs(seed + d, t, b, h) for d in range(dirs))))
    if dirs == 2:
        mask[1] = mask[1, ::-1]
    if b >= 2:
        mask[:, :, 1] = 0.0
    wt = np.ascontiguousarray(np.swapaxes(wh, 1, 2))  # torch weight_hh
    to = (lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
          .bfloat16())
    return to(xw), to(mask), to(h0), to(c0), to(wt).transpose(1, 2)


def _check_fwd(got, ref):
    """bf16 outputs after a chain of T tokens: a few ulps (phase 2's
    tolerances of chip_smoke.py)."""
    for name, g, r, rtol in zip(("h_seq", "c_seq", "acts"), got, ref,
                                (0.0, 1e-2, 0.0)):
        g, r = g.float(), r.float()
        assert bool(g.isfinite().all()), name
        err = float((g - r).abs().max())
        assert err <= 2e-2 + rtol * float(r.abs().max()), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 16])
@pytest.mark.parametrize("b,h", [(3, 64), (20, 256), (20, 1024), (32, 1024)])
def test_lstm_fwd_one_direction_matches_plain_on_card(cuda, b, h, t):
    xw, mask, h0, c0, wh = (x[0] for x in _fwd_inputs(3, t, b, h, 1))
    ref = _fwd_ref(xw, mask, h0, c0, wh)
    _check_fwd(lstm_scan(xw, mask, h0, c0, wh, with_acts=True), ref)
    _check_fwd(lstm_scan(xw, mask, h0, c0, wh), ref[:2])


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 16])
@pytest.mark.parametrize("b,h", [(3, 64), (20, 256), (20, 1024), (32, 1024)])
def test_lstm_fwd_two_directions_match_plain_on_card(cuda, b, h, t):
    args = _fwd_inputs(4, t, b, h, 2)
    ref = bilstm_scan_ref(*args)
    _check_fwd(bilstm_scan(*args, with_acts=True), ref)
    _check_fwd(bilstm_scan(*args), ref[:2])
    # each direction as its own one-direction launch gives the same
    for d in range(2):
        _check_fwd(lstm_scan(*(x[d].clone() for x in args), with_acts=True),
                   tuple(r[d] for r in ref))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 16, 80])
@pytest.mark.parametrize("b", [33, 40, 64])
def test_lstm_fwd_stream_width_matches_plain_on_card(cuda, b, t):
    """More than 32 batch rows (the stream window's 40 slots): one launch
    per direction, the h row sized to the batch, at 64 rows the partial
    sums inside it."""
    args = _fwd_inputs(6, t, b, 1024, 2)
    ref = bilstm_scan_ref(*args)
    _check_fwd(bilstm_scan(*args, with_acts=True), ref)
    _check_fwd(bilstm_scan(*args), ref[:2])
    _check_fwd(lstm_scan(*(x[1].clone() for x in args), with_acts=True),
               tuple(r[1] for r in ref))


@pytest.mark.cuda
def test_bilstm_scan_fn_grads_at_the_stream_width_on_card(cuda):
    """BiLstmScanFn at the stream window's 40 rows and H = 1024: K1 one
    launch per direction forward, K2 backward."""
    xw, mask, h0, c0, wh = _fwd_inputs(8, 16, 40, 1024, 2)
    g = torch.Generator().manual_seed(2)
    cots = tuple((torch.randn(2, 16, 40, 1024, generator=g) * 0.1).cuda()
                 .bfloat16() for _ in range(2))

    def grads(fn):
        leaves = [x.clone().requires_grad_() for x in (xw, h0, c0, wh)]
        out = fn(leaves[0], mask, *leaves[1:])
        return torch.autograd.grad(out[:2], leaves, cots)

    for got, ref in zip(grads(bilstm_scan_fn), grads(bilstm_scan_ref)):
        _rel_close(got, ref, 5e-2)
    lib = _build.library()
    for b in (33, 40, 64):
        p = fwd_plan(80, b, 1024, 132, 2)
        assert lib.dasa_lstm_fwd_smem(80, b, 1024, p.units) == p.smem


@pytest.mark.cuda
def test_bilstm_scan_fn_grads_track_plain_autograd_on_card(cuda):
    xw, mask, h0, c0, wh = _fwd_inputs(5, 16, 20, 256, 2)
    g = torch.Generator().manual_seed(1)
    cots = tuple((torch.randn(2, 16, 20, 256, generator=g) * 0.1).cuda()
                 .bfloat16() for _ in range(2))

    def grads(fn):
        leaves = [x.clone().requires_grad_() for x in (xw, h0, c0, wh)]
        out = fn(leaves[0], mask, *leaves[1:])
        return torch.autograd.grad(out[:2], leaves, cots)

    for got, ref in zip(grads(bilstm_scan_fn), grads(bilstm_scan_ref)):
        _rel_close(got, ref, 5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [20, 64])
def test_speaker_width_lstm_kernels_match_plain_on_card(cuda, b):
    """The speaker's BiLSTMs: H = 256 a direction over T = 35 (the teacher
    paths' bound), B = 20 (selfTrain's relabel) and 64 (speaker training):
    K1 for both directions (one launch at 20 rows, one a direction at 64),
    K2, and BiLstmScanFn's gradients; the plans' shared memory against the
    kernels' layouts."""
    t, h = 35, 256
    args = _fwd_inputs(9, t, b, h, 2)
    ref = bilstm_scan_ref(*args)
    _check_fwd(bilstm_scan(*args, with_acts=True), ref)
    _check_fwd(bilstm_scan(*args), ref[:2])
    bwd = _bwd_args(b, h, t)
    for got, want in zip(lstm_scan_bwd(*bwd), lstm_scan_bwd_ref(*bwd)):
        _rel_close(got, want, 2e-2)
    xw, mask, h0, c0, wh = args
    g = torch.Generator().manual_seed(3)
    cots = tuple((torch.randn(2, t, b, h, generator=g) * 0.1).cuda()
                 .bfloat16() for _ in range(2))

    def grads(fn):
        leaves = [x.clone().requires_grad_() for x in (xw, h0, c0, wh)]
        out = fn(leaves[0], mask, *leaves[1:])
        return torch.autograd.grad(out[:2], leaves, cots)

    for got, want in zip(grads(bilstm_scan_fn), grads(bilstm_scan_ref)):
        _rel_close(got, want, 5e-2)
    lib = _build.library()
    fp = fwd_plan(t, b, h, _build.sm_count(xw), 2)
    assert lib.dasa_lstm_fwd_smem(t, b, h, fp.units) == fp.smem
    bp = bwd_plan(t, b, h, _build.sm_count(xw))
    assert lib.dasa_lstm_bwd_smem(t, b, h, bp.kc, bp.stages) == bp.smem


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 2, 8])
def test_rescoring_width_lstm_fwd_matches_plain_on_card(cuda, t):
    """The speaker's rescoring of one search path: both directions of a
    BiLSTM at B = 1, H = 256, T the path's moves, every token valid, with
    and without the gate activations and under no_grad through
    bilstm_scan_fn; the second direction alone from its view of the
    stacked mask, 2 T bytes in (misaligned unless T is a multiple of 8:
    the wrapper copies it)."""
    xw, mask, h0, c0, wh = _fwd_inputs(10, t, 1, 256, 2)
    mask = torch.ones_like(mask)
    ref = bilstm_scan_ref(xw, mask, h0, c0, wh)
    _check_fwd(bilstm_scan(xw, mask, h0, c0, wh, with_acts=True), ref)
    _check_fwd(bilstm_scan(xw, mask, h0, c0, wh), ref[:2])
    with torch.no_grad():
        _check_fwd(bilstm_scan_fn(xw, mask, h0, c0, wh), ref[:2])
    _check_fwd(lstm_scan(xw[1], mask[1], h0[1], c0[1], wh[1],
                         with_acts=True), tuple(r[1] for r in ref))


@pytest.mark.cuda
def test_launch_plans_match_the_kernels_layouts_on_card(cuda):
    lib = _build.library()
    for t, b, h in ((16, 3, 64), (80, 20, 1024), (80, 32, 1024)):
        plan = bwd_plan(t, b, h, 132)
        assert lib.dasa_lstm_bwd_smem(t, b, h, plan.kc, plan.stages) == \
            _bwd_smem(t, b, h, plan.kc, plan.stages) == plan.smem
    for n, bn in ((320, 64), (720, 128)):  # the headline rows' widths
        plan = adain_plan(n, 2048, 2048, 132)
        assert plan.bn == bn
        assert lib.dasa_adain_gate_smem(bn) == plan.smem
    for t, b, h, dirs in ((1, 3, 64, 1), (80, 20, 1024, 1),
                          (80, 20, 1024, 2), (80, 32, 1024, 2),
                          (16, 20, 256, 2)):
        p = fwd_plan(t, b, h, 132, dirs)
        assert lib.dasa_lstm_fwd_smem(t, b, h, p.units) == \
            _fwd_smem(t, b, h, p.units) == p.smem
    for b, ks in ((1, 3), (20, 5), (33, 7)):
        p = shift_plan(b, 36, 2176, 1024, ks, 132)
        assert lib.dasa_shift_attend_smem(b, 36, 1024, ks, p.sw) == \
            _shift_smem(b, 36, 1024, ks, p.sw) == p.smem


@pytest.mark.cuda
def test_lstm_scan_fn_grads_track_plain_autograd_on_card(cuda):
    xw, mask, h0, c0, wh = (torch.from_numpy(a).cuda().bfloat16()
                            for a in _lstm_inputs(9, 16, 20, 256))
    g = torch.Generator().manual_seed(0)
    cots = tuple((torch.randn(16, 20, 256, generator=g) * 0.1).cuda()
                 .bfloat16() for _ in range(2))

    def grads(fn):
        leaves = [x.clone().requires_grad_() for x in (xw, h0, c0, wh)]
        out = fn(leaves[0], mask, *leaves[1:])
        return torch.autograd.grad(out, leaves, cots)

    # the kernels round the gates, c_prev and dgates to bf16 where the
    # plain autograd keeps f32 (the TPU package's design)
    for got, ref in zip(grads(LstmScanFn.apply), grads(lstm_scan_ref)):
        _rel_close(got, ref, 5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("with_noise", [False, True])
@pytest.mark.parametrize("c", [128, 2048])
@pytest.mark.parametrize("n", [1, 64, 100, 320, 720])
def test_adain_kernel_matches_plain_on_card(cuda, n, c, with_noise):
    g = torch.Generator().manual_seed(n)
    f, d = (torch.randn(n, c, generator=g).cuda().bfloat16()
            for _ in range(2))
    w = (torch.randn(c, c, generator=g) / c ** 0.5).cuda().bfloat16()
    b = (torch.randn(c, generator=g) * 0.1).cuda().bfloat16()
    noise = (((torch.rand(c, generator=g) > 0.4) / 0.6).cuda().bfloat16()
             if with_noise else None)
    # f32 accumulation in both; the output rounds to bf16 once
    torch.testing.assert_close(
        adain_channel_gate(f, d, w, b, noise).float(),
        adain_channel_gate_ref(f, d, w, b, noise).float(),
        atol=1e-2, rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,ks", [(20, 3), (20, 5), (20, 7), (1, 5),
                                  (33, 5)])
def test_shift_kernel_matches_plain_at_headline_width_on_card(cuda, b, ks):
    g = torch.Generator().manual_seed(b * 10 + ks)
    h = (torch.randn(b, 1024, generator=g) * 0.5).cuda().bfloat16()
    ctx = torch.randn(b, 36, 2176, generator=g).relu().cuda().bfloat16()
    w_in = (torch.randn(2176, 1024, generator=g) / 32).cuda().bfloat16().t()
    w_s = (torch.randn(ks, 1024, generator=g) / 32).cuda().bfloat16().t()
    b_s = (torch.randn(ks, generator=g) * 0.1).cuda().bfloat16()
    out, logit = shift_attend(h, ctx, w_in, w_s, b_s)
    r_out, r_logit = shift_attend_ref(h, ctx, w_in, w_s, b_s)
    # logits: f32 sums of 2176 products in another order; out: bf16
    torch.testing.assert_close(logit, r_logit, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(out.float(), r_out.float(), atol=1e-2,
                               rtol=1e-2)


@pytest.mark.cuda
def test_shift_kernel_matches_plain_on_card(cuda):
    g = torch.Generator().manual_seed(0)
    h = torch.randn(5, 64, generator=g).cuda().bfloat16()
    ctx = torch.randn(5, 36, 136, generator=g).cuda().bfloat16()
    w_in = (torch.randn(64, 136, generator=g) * 0.1).cuda().bfloat16()
    w_s = (torch.randn(64, 5, generator=g) * 0.1).cuda().bfloat16()
    b_s = torch.zeros(5).cuda().bfloat16()
    out, logit = shift_attend(h, ctx, w_in, w_s, b_s)
    r_out, r_logit = shift_attend_ref(h, ctx, w_in, w_s, b_s)
    torch.testing.assert_close(logit, r_logit, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(out.float(), r_out.float(), atol=1e-2,
                               rtol=1e-2)


@pytest.mark.cuda
def test_resnet_bf16_matches_f32_on_card(cuda):
    """The featurizer's ResNet-152 in bf16 (cuDNN convolutions,
    channels-last) against the same weights in f32: each image's 2048
    pooled features at cosine >= 0.99 (phase 21's limit)."""
    from dasa_tpu_torch.models.resnet import resnet152

    torch.manual_seed(0)
    model = resnet152().cuda()
    x = torch.rand(4, 96, 128, 3, device="cuda")
    with torch.inference_mode(), torch.backends.cudnn.flags(
            enabled=True, allow_tf32=False):
        want = model(x)
        got = model.set_dtype(torch.bfloat16)(x)
    assert got.dtype == torch.float32 and got.shape == (4, 2048)
    cos = torch.nn.functional.cosine_similarity(got, want, dim=1)
    assert bool(got.isfinite().all()) and float(cos.min()) >= 0.99


@pytest.mark.cuda
def test_one_rank_nccl_job_on_card(cuda, monkeypatch):
    """``initialize`` from the launcher's variables picks NCCL for one
    rank on one card; the mesh's collectives run on it."""
    import socket

    from dasa_tpu_torch.parallel import distributed, make_mesh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("COORDINATOR_ADDRESS", f"localhost:{port}")
    monkeypatch.setenv("NUM_PROCESSES", "1")
    monkeypatch.setenv("PROCESS_ID", "0")
    try:
        assert distributed.initialize() == "nccl"
        mesh = make_mesh()
        x = torch.arange(6.0, device="cuda")
        assert torch.equal(mesh.allsum(x), x)
        assert torch.equal(mesh.all_gather(x[None]), x[None])
        p = torch.nn.Parameter(torch.ones(3, device="cuda"))
        p.grad = torch.full_like(p, 2.0)
        mesh.all_reduce_grads([p])
        assert torch.equal(p.grad, torch.full_like(p, 2.0))
        mesh.barrier()
    finally:
        distributed.shutdown()
