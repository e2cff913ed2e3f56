"""Ablation-variant building blocks and decoders.

Counterpart of ``dasa_tpu/models/variants.py`` (reference r2r_src/dyrelu.py,
fusion.py, model.py:578-968, 1505-1707): the language-conditioned DyReLU,
the MLB and Mutan fusions, the Advanced / KVMem / New / Mutan / Mcatt
decoders on one skeleton, the MT decoder and the double (RGB + depth)
decoder.  Each
decoder step has ``BAttnDecoderLSTM``'s signature and returns (h_1, c_1,
logit, h_tilde, aux); dropout draws from ``gen`` (None = none).  As in the
JAX package, these decoders never take the shift attention, so K4 is not
on their path; a layer's parameters exist only where the JAX module calls
it (flax creates no others).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from dasa_tpu_torch.models.decoder import BAttnDecoderLSTM, drop_visual
from dasa_tpu_torch.models.layers import (
    Dense,
    LstmCell,
    SoftDotAttention,
    cast_param,
    dropout,
    scaled_dot_attention,
)


class LangDyReLU(nn.Module):
    """Piecewise-linear activation out = max_j (x * a_j + b_j), whose 2k
    coefficients (a, b) = lambdas * theta + init come from the query
    (dyrelu.py:4-30); ``per_channel`` predicts them per channel (the B and
    C variants)."""

    def __init__(self, channels: int, query_dim: int, reduction: int = 4,
                 k: int = 2, per_channel: bool = False,
                 compute_dtype=torch.float32):
        super().__init__()
        self.channels = channels
        self.k = k
        self.per_channel = per_channel
        self.compute_dtype = compute_dtype
        out_dim = 2 * k * (channels if per_channel else 1)
        kw = dict(compute_dtype=compute_dtype)
        self.fc1 = Dense(query_dim, channels // reduction, **kw)
        self.fc2 = Dense(channels // reduction, out_dim, **kw)
        self.register_buffer("lambdas", torch.tensor([1.0] * k + [0.5] * k),
                             persistent=False)
        self.register_buffer("init_v",
                             torch.tensor([1.0] + [0.0] * (2 * k - 1)),
                             persistent=False)

    def forward(self, x, q):
        """x (..., C) along its last axis, B leading; q (B, Q)."""
        dt = self.compute_dtype
        theta = 2 * torch.sigmoid(self.fc2(torch.relu(self.fc1(q)))) - 1
        coefs = theta.reshape(-1, self.channels if self.per_channel else 1,
                              2 * self.k)
        coefs = coefs * self.lambdas.to(dt) + self.init_v.to(dt)
        x2 = x.reshape(coefs.shape[0], -1, x.shape[-1])        # (B, L, C)
        out = (x2[..., None] * coefs[:, None, :, :self.k]
               + coefs[:, None, :, self.k:])                     # (B,L,C,k)
        return out.amax(dim=-1).reshape(x.shape)


def lang_dyrelu_a(channels, query_dim, reduction=4, k=2,
                  compute_dtype=torch.float32):
    """Shared coefficients across channels (dyrelu.py:33-49)."""
    return LangDyReLU(channels, query_dim, reduction, k, per_channel=False,
                      compute_dtype=compute_dtype)


def lang_dyrelu_c(channels, query_dim, reduction=4, k=2,
                  compute_dtype=torch.float32):
    """Per-channel coefficients on (B, L, C) inputs (dyrelu.py:82-105)."""
    return LangDyReLU(channels, query_dim, reduction, k, per_channel=True,
                      compute_dtype=compute_dtype)


class MLBFusion(nn.Module):
    """Multimodal low-rank bilinear: the hadamard product of the two
    tanh-projected streams (fusion.py:17-51)."""

    def __init__(self, dim_v: int, dim_q: int, dim_h: int,
                 dropout_v: float = 0.5, dropout_q: float = 0.5,
                 compute_dtype=torch.float32):
        super().__init__()
        self.dropout_v, self.dropout_q = dropout_v, dropout_q
        self.compute_dtype = compute_dtype
        self.linear_v = Dense(dim_v, dim_h, compute_dtype=compute_dtype)
        self.linear_q = Dense(dim_q, dim_h, compute_dtype=compute_dtype)

    def forward(self, v, q, gen=None):
        dt = self.compute_dtype
        v = torch.tanh(self.linear_v(dropout(v.to(dt), self.dropout_v, gen)))
        q = torch.tanh(self.linear_q(dropout(q.to(dt), self.dropout_q, gen)))
        return v * q


class MutanFusion(nn.Module):
    """Tucker-decomposed bilinear fusion: tanh of the sum of R rank-1
    hadamard interactions (fusion.py:54-120)."""

    def __init__(self, dim_v: int, dim_q: int, dim_hv: int, dim_hq: int,
                 dim_mm: int, rank: int = 5, dropout_v: float = 0.5,
                 dropout_q: float = 0.5, compute_dtype=torch.float32):
        super().__init__()
        self.dropout_v, self.dropout_q = dropout_v, dropout_q
        self.compute_dtype = compute_dtype
        kw = dict(compute_dtype=compute_dtype)
        self.linear_v = Dense(dim_v, dim_hv, **kw)
        self.linear_q = Dense(dim_q, dim_hq, **kw)
        self.list_linear_hv = nn.ModuleList(
            Dense(dim_hv, dim_mm, **kw) for _ in range(rank))
        self.list_linear_hq = nn.ModuleList(
            Dense(dim_hq, dim_mm, **kw) for _ in range(rank))

    def forward(self, v, q, gen=None):
        dt = self.compute_dtype
        v = torch.tanh(self.linear_v(dropout(v.to(dt), self.dropout_v, gen)))
        q = torch.tanh(self.linear_q(dropout(q.to(dt), self.dropout_q, gen)))
        total = sum(hv(v) * hq(q) for hv, hq in zip(self.list_linear_hv,
                                                    self.list_linear_hq))
        return torch.tanh(total)


class _VariantDecoderBase(nn.Module):
    """Shared skeleton of the ablation decoders (model.py:578-931): angle
    embed -> panorama attention -> LSTMCell -> instruction attention ->
    candidate logits, as ``BAttnDecoderLSTM`` without the shift
    attention, with hooks where each variant deviates; ``pred_back`` adds
    the back-logit head on the candidates the logits saw."""

    def __init__(self, embedding_size: int, hidden_size: int,
                 feature_size: int, angle_feat_size: int, ctx_dim: int,
                 pred_back: bool = False, max_input: int = 80,
                 compute_dtype=torch.float32, dropout_ratio: float = 0.0,
                 featdropout: float = 0.0):
        super().__init__()
        self.hidden_size = hidden_size
        self.feature_size = feature_size
        self.angle_feat_size = angle_feat_size
        self.ctx_dim = ctx_dim
        self.pred_back = pred_back
        self.max_input = max_input
        self.compute_dtype = compute_dtype
        self.dropout_ratio = dropout_ratio
        self.featdropout = featdropout
        kw = dict(compute_dtype=compute_dtype)
        self.embedding = nn.Sequential(
            Dense(angle_feat_size, embedding_size, **kw), nn.Tanh())
        self.lstm = LstmCell(hidden_size,
                             embedding_size + self._lstm_feat_dim(),
                             compute_dtype)
        self._build(kw)
        if pred_back:
            self.back_candidate_att_layer = SoftDotAttention(
                hidden_size, self._back_ctx_dim(), with_tilde=False, **kw)

    # hooks -------------------------------------------------------------
    def _lstm_feat_dim(self) -> int:
        return self.feature_size

    def _back_ctx_dim(self) -> int:
        return self.feature_size

    def _build(self, kw):
        hid, feat = self.hidden_size, self.feature_size
        self.feat_att_layer = SoftDotAttention(hid, feat, with_tilde=False,
                                               **kw)
        self.attention_layer = SoftDotAttention(hid, self.ctx_dim, **kw)
        self.candidate_att_layer = SoftDotAttention(hid, feat,
                                                    with_tilde=False, **kw)

    def _pano_attend(self, prev_h1_drop, feature):
        attn_feat, _ = self.feat_att_layer(prev_h1_drop, feature,
                                           output_tilde=False)
        return attn_feat

    def _instr_attend(self, h_1, h_1_drop, ctx, ctx_mask, aux, gen):
        h_tilde, _ = self.attention_layer(h_1_drop, ctx, ctx_mask)
        return h_tilde

    def _cand_logit(self, h_tilde_drop, cand_feat):
        """Returns (logit, candidate features for the back head)."""
        _, logit = self.candidate_att_layer(h_tilde_drop, cand_feat,
                                            output_tilde=False,
                                            output_prob=False)
        return logit, cand_feat

    def forward(self, action, feature, cand_feat, prev_h1, c_0, ctx,
                ctx_mask=None, gen=None, already_dropfeat: bool = False,
                **_):
        dt = self.compute_dtype
        rate = self.dropout_ratio
        aux: Dict[str, torch.Tensor] = {}
        action_embeds = dropout(self.embedding(action.to(dt)), rate, gen)
        if not already_dropfeat:
            feature = drop_visual(feature, self.angle_feat_size,
                                  self.featdropout, gen)
        attn_feat = self._pano_attend(dropout(prev_h1, rate, gen), feature)
        concat_input = torch.cat([action_embeds, attn_feat.to(dt)], dim=-1)
        h_1, c_1 = self.lstm((prev_h1.to(dt), c_0.to(dt)), concat_input)
        h_tilde = self._instr_attend(h_1, dropout(h_1, rate, gen), ctx,
                                     ctx_mask, aux, gen)
        h_tilde_drop = dropout(h_tilde, rate, gen)
        if not already_dropfeat:
            cand_feat = drop_visual(cand_feat, self.angle_feat_size,
                                    self.featdropout, gen)
        logit, back_feat = self._cand_logit(h_tilde_drop, cand_feat)
        if self.pred_back:
            _, aux["back_logit"] = self.back_candidate_att_layer(
                prev_h1, back_feat, output_tilde=False, output_prob=False)
        return h_1, c_1, logit, h_tilde, aux


class AdvancedDecoderLSTM(_VariantDecoderBase):
    """agent_advanced's decoder (model.py:578-656): the skeleton plus an
    unconditional linear progress predictor on the zero-padded
    instruction attention (``aux["pred_progress"]``), whose MSE the agent
    adds with a fixed weight of 10 (agent_advanced.py:563-565)."""

    def _build(self, kw):
        super()._build(kw)
        self.pm_predictor = Dense(self.max_input, 1, **kw)

    def _instr_attend(self, h_1, h_1_drop, ctx, ctx_mask, aux, gen):
        h_tilde, alpha = self.attention_layer(h_1_drop, ctx, ctx_mask)
        attw = alpha.to(self.compute_dtype)
        if attw.shape[1] < self.max_input:
            attw = nn.functional.pad(attw, (0, self.max_input
                                            - attw.shape[1]))
        aux["pred_progress"] = self.pm_predictor(attw)[:, 0]
        return h_tilde


class KVMemAttnDecoderLSTM(_VariantDecoderBase):
    """agent_kvmem's decoder (model.py:661-735): a learned 100-slot memory
    ``kv`` refines h_tilde by a residual soft attention."""

    kv_slots = 100

    def _build(self, kw):
        super()._build(kw)
        self.kv = nn.Parameter(torch.randn(self.kv_slots, self.hidden_size))
        self.kv_att_layer = SoftDotAttention(self.hidden_size,
                                             self.hidden_size, **kw)

    def _instr_attend(self, h_1, h_1_drop, ctx, ctx_mask, aux, gen):
        h_tilde, _ = self.attention_layer(h_1_drop, ctx, ctx_mask)
        kv = cast_param(self.kv, self.compute_dtype)
        mem = kv[None].expand(h_tilde.shape[0], *kv.shape)
        refined, _ = self.kv_att_layer(h_tilde, mem)
        return h_tilde + refined


class NewAttnDecoderLSTM(_VariantDecoderBase):
    """agent_new's decoder (model.py:738-823): panorama and candidate
    features projected to the hidden width, scaled dot attention
    everywhere (the instruction's unmasked, as in the reference), and a
    residual language update h_tilde = h_1 + attn_ctx.  Its back head
    attends over the projected candidates, so it is built at the hidden
    width (the JAX module builds it at the feature width, which only runs
    where the two widths are equal)."""

    def _lstm_feat_dim(self) -> int:
        return self.hidden_size

    def _back_ctx_dim(self) -> int:
        return self.hidden_size

    def _build(self, kw):
        self.visionpose_to_hidden = Dense(self.feature_size,
                                          self.hidden_size, **kw)
        self.language_to_hidden = Dense(self.ctx_dim, self.hidden_size, **kw)

    def _pano_attend(self, prev_h1_drop, feature):
        feature = self.visionpose_to_hidden(feature)
        attn_feat, _ = scaled_dot_attention(feature, feature,
                                            prev_h1_drop.to(feature.dtype))
        return attn_feat

    def _instr_attend(self, h_1, h_1_drop, ctx, ctx_mask, aux, gen):
        ctx = self.language_to_hidden(ctx)
        attn_ctx, _ = scaled_dot_attention(ctx, ctx, h_1_drop)
        return h_1 + attn_ctx

    def _cand_logit(self, h_tilde_drop, cand_feat):
        cand = self.visionpose_to_hidden(cand_feat)
        _, logit = scaled_dot_attention(cand, cand, h_tilde_drop,
                                        output_prob=False)
        return logit, cand


class MutanAttnDecoderLSTM(_VariantDecoderBase):
    """agent_mutan's decoder (model.py:826-931): h_tilde is a linear map
    of the Mutan fusion (R 32, mm 256) of the hidden state with the
    attended instruction."""

    mutan_mm = 256
    mutan_rank = 32

    def _build(self, kw):
        hid, feat = self.hidden_size, self.feature_size
        self.feat_att_layer = SoftDotAttention(hid, feat, with_tilde=False,
                                               **kw)
        self.attention_layer = SoftDotAttention(hid, self.ctx_dim,
                                                with_tilde=False, **kw)
        self.candidate_att_layer = SoftDotAttention(hid, feat,
                                                    with_tilde=False, **kw)
        self.mutan = MutanFusion(hid, self.ctx_dim, hid, self.ctx_dim,
                                 self.mutan_mm, self.mutan_rank,
                                 dropout_v=0.2, dropout_q=0.2, **kw)
        self.linear_mutan = Dense(self.mutan_mm, hid, **kw)

    def _instr_attend(self, h_1, h_1_drop, ctx, ctx_mask, aux, gen):
        attended, _ = self.attention_layer(h_1_drop, ctx, ctx_mask,
                                           output_tilde=False)
        return self.linear_mutan(self.mutan(h_1_drop, attended, gen))


class McattDecoder(_VariantDecoderBase):
    """agent_mcatt's decoder (model.py:1505-1591,
    ``dasa_tpu/models/variants.py:335``): the plain skeleton, its
    instruction attention over the McattEncoder's co-attended token
    stream at the MCAN hidden width."""


class MTDecoder(nn.Module):
    """The MT decoder (model.py:1609-1707): a gated hidden update from the
    mean panorama token (the panorama plus the encoder's vision tokens
    ``v_emb`` mapped to the feature width), then an MLP scores every view
    token and a learned STOP token ``v_stop_feat`` against the attended
    instruction and the heading embedding; the candidates' logits are
    gathered by their view index ``cand_idx``.  It has no LSTM: the new
    hidden state is h, c and h_tilde alike."""

    def __init__(self, embedding_size: int, hidden_size: int,
                 feature_size: int, angle_feat_size: int, ctx_dim: int,
                 vemb_dim: int = 768, compute_dtype=torch.float32,
                 dropout_ratio: float = 0.0, featdropout: float = 0.0):
        super().__init__()
        self.angle_feat_size = angle_feat_size
        self.compute_dtype = compute_dtype
        self.dropout_ratio = dropout_ratio
        self.featdropout = featdropout
        kw = dict(compute_dtype=compute_dtype)
        self.embedding = nn.Sequential(
            Dense(angle_feat_size, embedding_size, **kw), nn.Tanh())
        self.v_stop_feat = nn.Parameter(torch.randn(feature_size))
        self.vemb_to_v = Dense(vemb_dim, feature_size, **kw)
        self.hv_to_upd = Dense(hidden_size + feature_size - angle_feat_size,
                               hidden_size, **kw)
        self.h_to_ctx = Dense(hidden_size, ctx_dim, **kw)
        # the reference's MLP(use_relu=False, dropout_r=0): two linears
        self.mlp_hidden = Dense(feature_size + ctx_dim + embedding_size,
                                hidden_size, **kw)
        self.mlp_out = Dense(hidden_size, 1, **kw)

    def forward(self, action, feature, cand_feat, prev_h1, c_0, ctx,
                ctx_mask=None, gen=None, already_dropfeat: bool = False,
                v_emb=None, cand_idx=None, **_):
        dt = self.compute_dtype
        action_embeds = dropout(self.embedding(action.to(dt)),
                                self.dropout_ratio, gen)
        if not already_dropfeat:
            feature = drop_visual(feature, self.angle_feat_size,
                                  self.featdropout, gen)
        feature = self.vemb_to_v(v_emb) + feature.to(dt)
        mean_v = feature[..., :-self.angle_feat_size].mean(dim=1)
        prev = prev_h1.to(dt)
        update_v = self.hv_to_upd(torch.cat([prev, mean_v], dim=-1))
        gate = torch.sigmoid(update_v)
        h = prev * (1 - gate) + gate * update_v
        ctx = ctx.to(dt)
        instr, _ = scaled_dot_attention(
            ctx, ctx, self.h_to_ctx(h)[:, None, :],
            mask=None if ctx_mask is None else ctx_mask[:, None, :])
        instr = instr[:, 0]
        b, n_views, fdim = feature.shape
        stop = cast_param(self.v_stop_feat, dt).expand(b, 1, fdim)
        instr_angle = torch.cat([instr, action_embeds], dim=-1)
        tokens = torch.cat([
            torch.cat([feature, stop], dim=1),
            instr_angle[:, None, :].expand(b, n_views + 1,
                                           instr_angle.shape[-1])], dim=-1)
        score = self.mlp_out(self.mlp_hidden(tokens))[..., 0]
        logit = score.gather(1, cand_idx)
        return h, h, logit, h, {}


class DoubleBAttnDecoderLSTM(nn.Module):
    """Two BAttn decoders without the shift attention, one over the RGB
    stream and one over the depth stream, whose candidate logits are
    summed (model.py:934-968, agent_double)."""

    def __init__(self, embedding_size: int, hidden_size: int,
                 feature_size: int, angle_feat_size: int, ctx_dim: int,
                 compute_dtype=torch.float32, dropout_ratio: float = 0.0,
                 featdropout: float = 0.0):
        super().__init__()
        args = (embedding_size, hidden_size, feature_size, angle_feat_size,
                ctx_dim)
        kw = dict(compute_dtype=compute_dtype, dropout_ratio=dropout_ratio,
                  featdropout=featdropout)
        self.rgb_decoder = BAttnDecoderLSTM(*args, **kw)
        self.depth_decoder = BAttnDecoderLSTM(*args, **kw)

    def forward(self, action, feature, dfeature, cand_feat, cand_dfeat,
                prev_h1, c_0, prev_h1_d, c_0_d, ctx, ctx_mask=None,
                gen=None, already_dropfeat: bool = False):
        h, c, logit, h1, aux = self.rgb_decoder(
            action, feature, cand_feat, prev_h1, c_0, ctx, ctx_mask, gen=gen,
            already_dropfeat=already_dropfeat)
        hd, cd, logit_d, h1d, _ = self.depth_decoder(
            action, dfeature, cand_dfeat, prev_h1_d, c_0_d, ctx, ctx_mask,
            gen=gen, already_dropfeat=already_dropfeat)
        return (h, c, h1), (hd, cd, h1d), logit + logit_d, aux
