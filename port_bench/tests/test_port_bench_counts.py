"""The benchmark's operation and byte counts: the model FLOPs of a policy
step and of the text stack against torch's FLOP counter on the reference
at small widths, and the kernels' bytes and operations against hand
counts at one shape each."""

from __future__ import annotations

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import data, flops
from port_bench.reference.policy import (
    DecoderState,
    ReferencePolicy,
    StepInputs,
)
from port_bench.tests.conftest import PB, TINY


def sizes_of(config):
    with open(os.path.join(PB, "configs", f"{config}.json")) as f:
        s = json.load(f)["settings"]
    s.update(TINY)
    return s


@pytest.mark.parametrize("config,tokens", [("dasa-ndh", 12),
                                            ("dasa-ndh", 30)])
def test_step_and_text_flops_match_the_counter(config, tokens):
    s = sizes_of(config)
    torch.manual_seed(0)
    policy = ReferencePolicy(s)
    shapes = {k: tuple(v.shape) for k, v in policy.state_dict().items()}
    policy.load_state_dict(data.weights(shapes, 3, "cpu"))
    rows, k = 3, s["max_candidates"]
    fa = s["feature_size"] + s["angle_feat_size"]
    instr = torch.randint(5, 60, (rows, tokens))
    valid = torch.ones(rows, tokens, dtype=torch.bool)
    with FlopCounterMode(display=False) as counter:
        text = policy.encode_text(instr, valid)
    assert counter.get_total_flops() == flops.text_flops(rows, tokens, s)
    inputs = StepInputs(torch.rand(rows, s["angle_feat_size"]),
                        torch.rand(rows, 36, fa), torch.rand(rows, 36, fa),
                        torch.rand(rows, k, fa), torch.rand(rows, k, fa))
    noise = torch.ones(rows, 1, s["feature_size"])
    seq_len = torch.full((rows,), tokens)
    with FlopCounterMode(display=False) as counter:
        percept = policy.percept_step(text, valid, seq_len, inputs, noise)
        h0 = percept["h0"]
        policy.decode_from_percept(percept, valid,
                                   DecoderState(h0, h0, h0),
                                   torch.ones(rows, dtype=torch.bool))
    # the counter does not see inside torch's fused LSTM: its products by
    # hand, both directions, the input and the recurrent weights
    hd = s["d_enc_hidden_size"]
    lstm = 2 * 2 * tokens * (768 + hd) * 4 * hd
    step = flops.step_flops(tokens, s)
    assert counter.get_total_flops() + rows * lstm == rows * (
        step["frozen"] + step["trained"])


def test_lstm_kernel_counts_by_hand():
    t, b, h = 80, 128, 1024
    # K1, both directions, with the gate activations: per direction
    # xw 80*128*4096, mask 80*128, h0 and c0 2*128*1024, wh 1024*4096,
    # h and c 2*80*128*1024, acts 80*128*4096 bf16 elements
    elems = (41943040 + 10240 + 262144 + 4194304 + 20971520 + 41943040)
    flops_k1 = 2 * 2.0 * 80 * 128 * 1024 * 4096
    assert flops.lstm_fwd_bound_s(t, b, h, acts=True) == pytest.approx(
        max(2 * 2 * elems / 3.35e12, flops_k1 / 989e12))
    # K2, one direction: acts twice, c / g_h / g_c, mask, wh; dh0, dc0 f32
    n_bytes = 2 * (2 * 41943040 + 3 * 10485760 + 10240 + 4194304) \
        + 4 * 2 * 128 * 1024
    assert flops.lstm_bwd_bound_s(t, b, h) == pytest.approx(
        max(n_bytes / 3.35e12, 2.0 * 80 * 128 * 1024 * 4096 / 989e12))


def test_adain_and_shift_kernel_counts_by_hand():
    # K3 at the panorama rows of batch 20: 720 x 2048 @ 2048 x 2048
    n, c = 720, 2048
    n_bytes = 2 * (3 * 720 * 2048 + 2048 * 2048 + 2 * 2048)
    assert flops.adain_gate_bound_s(n, c) == pytest.approx(
        max(n_bytes / 3.35e12, 2.0 * 720 * 2048 * 2048 / 989e12))
    # K4 at batch 20: h 20x1024, ctx 20x36x2176, w_in 2176x1024,
    # w_shift 1024x5, b 5, out 20x2176 bf16; logits 20x36 f32
    n_bytes = 2 * (20480 + 1566720 + 2228224 + 5120 + 5 + 43520) + 4 * 720
    ops = 2.0 * 20 * 1024 * 2181 + 4.0 * 20 * 36 * 2176
    assert flops.shift_attend_bound_s(20, 1024, 2176, 5) == pytest.approx(
        max(n_bytes / 3.35e12, ops / 989e12))
