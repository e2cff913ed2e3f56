"""The reference DASA listener step: env-drop, the channel AdaIN, the
cross-modal encoder with its top BiLSTM, the BAttn decoder with shift
attention, the candidate logits and the critic, in float32.

A frozen copy of the port's policy arithmetic (``models/policy.py``,
``encoder.py``, ``decoder.py``, ``adain.py``) for the benchmark's
configuration family (``encoder_type=Dic`` with vision, ``adain_type=
channel``, ``ab_type=a``, ``a_type=sigmoid``, ``use_shift``, consistent
env-drop after AdaIN with depth drop, no auxiliary heads).  Module and
parameter names are the port's.  Every dropout draws from the caller's
generator in the port's order.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
from torch import nn

from port_bench.reference.bert import BertConfig, DicModel
from port_bench.reference.layers import (
    NEG_INF,
    BiLSTM,
    Dense,
    LstmCell,
    ShiftSoftDotAttention,
    SoftDotAttention,
    dropout,
)


class StepInputs(NamedTuple):
    action_feat: torch.Tensor   # (B, A)
    f_t: torch.Tensor           # (B, 36, F + A) rgb pano
    d_t: torch.Tensor           # (B, 36, F + A) depth pano
    cand_feat: torch.Tensor     # (B, K, F + A)
    cand_dfeat: torch.Tensor    # (B, K, F + A)


class DecoderState(NamedTuple):
    h: torch.Tensor
    c: torch.Tensor
    h1: torch.Tensor


def reverse_valid_tokens(embeds, valid_mask, seq_len):
    length = embeds.shape[1]
    j = torch.arange(length, device=embeds.device)[None, :]
    src = (seq_len[:, None].long() - 1 - j).clamp(0, length - 1)
    rev = torch.gather(embeds, 1,
                       src[:, :, None].expand(-1, -1, embeds.shape[-1]))
    return torch.where(valid_mask[:, :, None], rev, torch.zeros_like(rev))


class DicEncoder(nn.Module):
    def __init__(self, bert_cfg: BertConfig, hidden_size: int,
                 dec_hidden_size: int, dropout_ratio: float):
        super().__init__()
        self.dropout_ratio = dropout_ratio
        self.bert = DicModel(bert_cfg)
        self.lstm = BiLSTM(hidden_size, bert_cfg.hidden_size)
        self.encoder_lstm2decoder_ht = Dense(2 * hidden_size,
                                             dec_hidden_size)
        if 2 * hidden_size != dec_hidden_size:
            self.encoder_lstm2decoder_ct = Dense(2 * hidden_size,
                                                 dec_hidden_size)

    def forward(self, text_embeds, valid_mask, seq_len, f_t_all, gen=None):
        embeds, _pooled, _visn = self.bert.cross_forward(
            text_embeds, valid_mask.int(), f_t_all, gen)
        embeds = reverse_valid_tokens(embeds, valid_mask, seq_len)
        ctx, (h_t, c_t) = self.lstm(embeds, valid_mask)
        decoder_init = torch.tanh(self.encoder_lstm2decoder_ht(h_t))
        if hasattr(self, "encoder_lstm2decoder_ct"):
            c_t = self.encoder_lstm2decoder_ct(c_t)
        ctx = dropout(ctx, self.dropout_ratio, gen)
        return ctx, decoder_init, c_t


class Critic(nn.Module):
    def __init__(self, in_dim: int, dim: int, dropout_ratio: float):
        super().__init__()
        self.state2value = nn.Sequential(Dense(in_dim, dim), nn.ReLU(),
                                         nn.Dropout(dropout_ratio),
                                         Dense(dim, 1))
        self.rate = dropout_ratio

    def forward(self, state, gen=None):
        layers = self.state2value
        x = dropout(layers[1](layers[0](state)), self.rate, gen)
        return layers[3](x)[..., 0]


class BAttnDecoderLSTM(nn.Module):
    def __init__(self, embedding_size: int, hidden_size: int,
                 feature_size: int, angle_feat_size: int, ctx_dim: int,
                 shift_kernel_size: int, dropout_ratio: float):
        super().__init__()
        self.dropout_ratio = dropout_ratio
        self.embedding = nn.Sequential(Dense(angle_feat_size,
                                             embedding_size), nn.Tanh())
        self.lstm = LstmCell(hidden_size, embedding_size + feature_size)
        self.feat_att_layer = ShiftSoftDotAttention(
            hidden_size, feature_size, shift_kernel_size)
        self.attention_layer = SoftDotAttention(hidden_size, ctx_dim)
        self.candidate_att_layer = SoftDotAttention(
            hidden_size, feature_size, with_tilde=False)

    def forward(self, action, feature, cand_feat, prev_h1, c_0, ctx,
                ctx_mask, gen=None):
        """The env-drop noise has already dropped the visual features, so
        the decoder's own feature dropout is skipped."""
        rate = self.dropout_ratio
        action_embeds = dropout(self.embedding(action.float()), rate, gen)
        attn_feat, _ = self.feat_att_layer(dropout(prev_h1, rate, gen),
                                           feature)
        concat_input = torch.cat([action_embeds, attn_feat], dim=-1)
        h_1, c_1 = self.lstm((prev_h1.float(), c_0.float()), concat_input)
        h_tilde, _alpha = self.attention_layer(dropout(h_1, rate, gen), ctx,
                                               ctx_mask)
        h_tilde_drop = dropout(h_tilde, rate, gen)
        _, logit = self.candidate_att_layer(h_tilde_drop, cand_feat,
                                            output_tilde=False,
                                            output_prob=False)
        return h_1, c_1, logit, h_tilde


class DGAdaChannel(nn.Module):
    """a * f with a = sigmoid(W_a d + b_a)."""

    def __init__(self, channel: int):
        super().__init__()
        self.a_fc = Dense(channel, channel)

    def forward(self, f_t, d_t):
        return torch.sigmoid(self.a_fc(d_t.float())) * f_t.float()


class ReferencePolicy(nn.Module):
    """The listener's encoder, decoder, critic and AdaIN, as the port
    names them."""

    def __init__(self, sizes: Dict):
        super().__init__()
        s = sizes
        feat_all = s["feature_size"] + s["angle_feat_size"]
        bert_cfg = BertConfig(
            img_feature_dim=feat_all, la_layers=s["d_la_layers"],
            vl_layers=s["d_vl_layers"],
            hidden_dropout_prob=s["d_hidden_dropout_prob"],
            attention_probs_dropout_prob=s["d_attn_dropout_prob"])
        self.angle_feat_size = s["angle_feat_size"]
        self.encoder = DicEncoder(bert_cfg, s["d_enc_hidden_size"],
                                  s["d_hidden_size"], s["d_dropout_ratio"])
        self.decoder = BAttnDecoderLSTM(
            s["aemb"], s["d_hidden_size"], feat_all, s["angle_feat_size"],
            2 * s["d_enc_hidden_size"], s["shift_kernel_size"],
            s["dropout"])
        self.critic = Critic(s["d_hidden_size"], s["critic_dim"],
                             s["dropout"])
        self.adain = DGAdaChannel(s["feature_size"])

    def encode_text(self, instr, valid_mask, gen=None):
        return self.encoder.bert.text_forward(instr, valid_mask.int(), gen)

    def percept_step(self, text_embeds, valid_mask, seq_len,
                     inputs: StepInputs, env_noise, gen=None):
        a = self.angle_feat_size
        f_vis, f_ang = inputs.f_t[..., :-a], inputs.f_t[..., -a:]
        d_vis = inputs.d_t[..., :-a]
        c_vis, c_ang = inputs.cand_feat[..., :-a], inputs.cand_feat[..., -a:]
        cd_vis = inputs.cand_dfeat[..., :-a]
        df_t = torch.cat([self.adain(f_vis, d_vis), f_ang.float()], -1)
        cand = torch.cat([self.adain(c_vis, cd_vis), c_ang.float()], -1)

        def noised(x):
            x = x.float()
            return torch.cat([x[..., :-a] * env_noise.float(), x[..., -a:]],
                             dim=-1)

        f_t, df_t, cand = noised(inputs.f_t), noised(df_t), noised(cand)
        ctx, h0, c0 = self.encoder(text_embeds, valid_mask, seq_len, f_t,
                                   gen)
        return {"ctx": ctx, "h0": h0, "c0": c0,
                "inputs": inputs._replace(f_t=f_t, d_t=df_t,
                                          cand_feat=cand)}

    def decode_from_percept(self, percept, valid_mask, state: DecoderState,
                            is_first, gen=None):
        h0, c0 = percept["h0"], percept["c0"]
        first = is_first.float()[:, None]
        state = DecoderState(
            h=first * h0 + (1 - first) * state.h.float(),
            c=first * c0 + (1 - first) * state.c.float(),
            h1=first * h0 + (1 - first) * state.h1.float())
        inputs = percept["inputs"]
        h, c, logit, h1 = self.decoder(
            inputs.action_feat, inputs.d_t, inputs.cand_feat, state.h1,
            state.c, percept["ctx"], ~valid_mask, gen=gen)
        state = DecoderState(h, c, h1)
        return state, logit, self.critic(state.h, gen)


def masked_logits(logit, logit_mask):
    return logit.float().masked_fill(logit_mask, NEG_INF)
