"""Operation and byte counts from the shapes: the model FLOPs of a stream
training window (for ``mfu``) and the least bytes and operations of each
launch of the hand-written LSTM kernels (for their roofline shares).

Peaks are one NVIDIA H100 SXM's published dense rates: 989 TFLOP/s in
bf16 and 3.35 TB/s of HBM3, at the full 700 W power limit.

A product of an (m, k) and a (k, n) matrix counts 2 m n k operations.
The model FLOPs count every product the listener's forward computes over
the shapes it runs (padded tokens included: the model computes them), and
twice the forward's for the backward of the trained layers (the top
BiLSTM, the projections to the decoder, the decoder, the critic and the
AdaIN gate; the BERT stacks are frozen and have none).  Elementwise work
is not counted, nor the text stack over pool rows that no slot takes:
the program encodes its whole pool each window, and that work serves no
episode.
"""

from __future__ import annotations

PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
VIEWS = 36


def attention_flops(nq: int, nkv: int, h: int) -> int:
    """Q on nq tokens, K and V on nkv, the output dense on nq, the scores
    and the weighted sum."""
    return 2 * h * h * (2 * nq + 2 * nkv) + 4 * nq * nkv * h


def bert_layer_flops(n: int, h: int, inter: int) -> int:
    return attention_flops(n, n, h) + 4 * n * h * inter


def text_flops(rows: int, tokens: int, s: dict) -> int:
    """The text stack (la_layers) over ``rows`` instructions."""
    return rows * s["d_la_layers"] * bert_layer_flops(tokens, 768, 3072)


def step_flops(tokens: int, s: dict) -> dict:
    """One row's policy step forward: ``frozen`` (the vision encoder and
    the cross-modal layers) and ``trained`` (the rest)."""
    h, inter = 768, 3072
    fa = s["feature_size"] + s["angle_feat_size"]
    f = s["feature_size"]
    hd, hdec = s["d_enc_hidden_size"], s["d_hidden_size"]
    k = s["max_candidates"]
    frozen = 2 * VIEWS * fa * h
    for _ in range(s["d_vl_layers"]):
        frozen += attention_flops(tokens, VIEWS, h)          # lang <- visn
        frozen += attention_flops(VIEWS, tokens, h)          # visn <- lang
        frozen += attention_flops(tokens, tokens, h)
        frozen += attention_flops(VIEWS, VIEWS, h)
        frozen += 4 * (tokens + VIEWS) * h * inter
    frozen += 2 * h * h                                      # pooler
    trained = 2 * (VIEWS + k) * f * f                        # AdaIN gate
    trained += 2 * 2 * tokens * h * 4 * hd                   # LSTM input
    trained += 2 * 2 * tokens * hd * 4 * hd                  # recurrence
    trained += (2 if 2 * hd != hdec else 1) * 2 * (2 * hd) * hdec  # ht, ct
    ctx = 2 * hd
    trained += 2 * s["angle_feat_size"] * s["aemb"]
    trained += 2 * hdec * fa + 4 * VIEWS * fa + 2 * hdec * s[
        "shift_kernel_size"]
    trained += 2 * (s["aemb"] + fa) * 4 * hdec + 2 * hdec * 4 * hdec
    trained += 2 * hdec * ctx + 4 * tokens * ctx + 2 * (hdec + ctx) * hdec
    trained += 2 * hdec * fa + 4 * k * fa   # candidates: scores, weighted
    trained += 2 * hdec * s["critic_dim"] + 2 * s["critic_dim"]
    return {"frozen": frozen, "trained": trained}


def stream_window_flops(s: dict, episodes: int, windows: int) -> int:
    """Model FLOPs of the work ``windows`` stream training windows
    consumed: the text stack once for each of the ``episodes`` that ran in
    them (carried in alive or refilled; the pool rows the program encodes
    and no slot takes are left out), and in each window S steps forward
    and backward over 2B slots and the edge's forward."""
    w, steps, tokens = 2 * s["batch_size"], s["stream_steps"], s[
        "max_input"]
    step = step_flops(tokens, s)
    fwd = step["frozen"] + step["trained"]
    return (text_flops(episodes, tokens, s)
            + windows * ((steps + 1) * w * fwd
                         + steps * w * 2 * step["trained"]))


def bound_s(n_bytes: float, flops: float) -> float:
    return max(n_bytes / PEAK_BYTES, flops / PEAK_BF16)


def lstm_fwd_bound_s(t: int, b: int, h: int, dirs: int = 2,
                     acts: bool = False) -> float:
    """K1 (csrc/lstm_fwd.cu) over ``dirs`` directions of b rows: bf16
    reads of the input projection, mask, initial state and recurrent
    weight, writes of h and c (and the gate activations in training)."""
    per_dir = 2 * (t * b * 4 * h + t * b + 2 * b * h + h * 4 * h
                   + 2 * t * b * h + (t * b * 4 * h if acts else 0))
    return bound_s(dirs * per_dir, dirs * 2.0 * t * b * h * 4 * h)


def lstm_bwd_bound_s(t: int, b: int, h: int) -> float:
    """K2 (csrc/lstm_bwd.cu), one direction: bf16 reads of the gate
    activations, c, the incoming gradients, mask and weight, the gate
    gradients written, f32 dh0 and dc0."""
    n_bytes = (2 * (t * b * 4 * h + 3 * t * b * h + t * b + h * 4 * h
                    + t * b * 4 * h) + 4 * 2 * b * h)
    return bound_s(n_bytes, 2.0 * t * b * h * 4 * h)


def adain_gate_bound_s(n: int, c: int) -> float:
    """K3 (csrc/adain_gate.cu) over n rows of c channels: bf16 reads of the
    content and style rows, the (c, c) weight and the bias and noise, the
    gated rows written; one (n, c) @ (c, c) product."""
    n_bytes = 2 * (n * c + n * c + c * c + 2 * c + n * c)
    return bound_s(n_bytes, 2.0 * n * c * c)


def shift_attend_bound_s(b: int, h: int, cf: int, ks: int,
                         views: int = VIEWS) -> float:
    """K4 (csrc/shift_attention.cu) at b rows: bf16 reads of h, the
    panorama context, the input and shift weights and bias, the attended
    context written, the f32 logits written; the two projections of h,
    the scores and the weighted sum."""
    n_bytes = (2 * (b * h + b * views * cf + cf * h + h * ks + ks + b * cf)
               + 4 * b * views)
    flops = 2.0 * b * h * (cf + ks) + 2 * 2.0 * b * views * cf
    return bound_s(n_bytes, flops)


def stream_window_kernel_bound_s(s: dict) -> float:
    """K1 and K2's least time over one stream training window: S forward
    calls with the activations and the edge's without, over 2B rows, and
    each direction's backward at every step."""
    w, steps, t = 2 * s["batch_size"], s["stream_steps"], s["max_input"]
    h = s["d_enc_hidden_size"]
    return (steps * lstm_fwd_bound_s(t, w, h, acts=True)
            + lstm_fwd_bound_s(t, w, h)
            + steps * 2 * lstm_bwd_bound_s(t, w, h))


KERNEL_NAMES = ("lstm_fwd", "lstm_bwd")
