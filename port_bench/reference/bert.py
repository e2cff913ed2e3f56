"""The reference's cross-modal BERT (DicModel): the text stack that runs
once an episode and the vision encoder with the cross-modal layers that
run every step, in float32.  A frozen copy of the port's
``models/bert.py`` arithmetic; both stacks are frozen in the benchmark's
configurations, so they record no graph."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from port_bench.reference.layers import Dense, dropout, uniform

# attention scores a block of rows may hold (float32 elements): a pool of
# 300-token dialogs would otherwise hold several 11-GiB tensors at once
ATTN_BLOCK = 1 << 28


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    img_feature_dim: int = 2176
    la_layers: int = 9
    vl_layers: int = 3


def extended_attention_mask(mask: torch.Tensor) -> torch.Tensor:
    m = mask.float()[:, None, None, :]
    return (1.0 - m) * -10000.0


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return nn.functional.layer_norm(x.float(), self.normalized_shape,
                                        self.weight, self.bias, self.eps)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.LayerNorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.rate = cfg.hidden_dropout_prob

    def forward(self, input_ids, gen=None):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(pos)[None]
             + self.token_type_embeddings.weight[0])
        return dropout(self.LayerNorm(x), self.rate, gen)


class BertAttentionCore(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        hid = cfg.hidden_size
        self.n_head = cfg.num_attention_heads
        self.query = Dense(hid, hid)
        self.key = Dense(hid, hid)
        self.value = Dense(hid, hid)
        self.rate = cfg.attention_probs_dropout_prob

    def forward(self, query_input, kv_input, att_bias, gen=None):
        def split(x):
            b, l, w = x.shape
            return x.reshape(b, l, self.n_head, w // self.n_head).transpose(
                1, 2)

        q = split(self.query(query_input))
        k = split(self.key(kv_input))
        v = split(self.value(kv_input))
        b, h, lq, d = q.shape
        keep = None
        if gen is not None and self.rate != 0.0:
            # the probabilities' mask, drawn whole in the port's order and
            # kept as booleans, so the products run in blocks of rows
            keep = uniform((b, h, lq, k.shape[2]), gen, q.device) >= self.rate
        rows = max(1, ATTN_BLOCK // (h * lq * k.shape[2]))
        ctx = []
        for i in range(0, b, rows):
            scores = (q[i:i + rows] @ k[i:i + rows].transpose(-1, -2)
                      / math.sqrt(d))
            if att_bias is not None:
                scores = scores + (att_bias if att_bias.shape[0] == 1
                                   else att_bias[i:i + rows])
            probs = torch.softmax(scores, dim=-1)
            if keep is not None:
                probs = torch.where(keep[i:i + rows],
                                    probs / (1.0 - self.rate), 0.0)
            ctx.append(probs @ v[i:i + rows])
        ctx = torch.cat(ctx)
        return ctx.transpose(1, 2).reshape(b, lq, h * d)


class BertSelfOutput(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = Dense(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.rate = cfg.hidden_dropout_prob

    def forward(self, hidden, residual, gen=None):
        hidden = dropout(self.dense(hidden), self.rate, gen)
        return self.LayerNorm(hidden + residual.float())


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.self = BertAttentionCore(cfg)
        self.output = BertSelfOutput(cfg)

    def forward(self, x, att_bias, gen=None):
        return self.output(self.self(x, x, att_bias, gen), x, gen)


class BertXAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.att = BertAttentionCore(cfg)
        self.output = BertSelfOutput(cfg)

    def forward(self, x, ctx, ctx_att_bias, gen=None):
        return self.output(self.att(x, ctx, ctx_att_bias, gen), x, gen)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = Dense(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x):
        return nn.functional.gelu(self.dense(x))


class BertOutput(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = Dense(cfg.intermediate_size, cfg.hidden_size)
        self.LayerNorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.rate = cfg.hidden_dropout_prob

    def forward(self, hidden, residual, gen=None):
        hidden = dropout(self.dense(hidden), self.rate, gen)
        return self.LayerNorm(hidden + residual)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertOutput(cfg)

    def forward(self, x, att_bias, gen=None):
        attn_out = self.attention(x, att_bias, gen)
        return self.output(self.intermediate(attn_out), attn_out, gen)


class BertPooler(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = Dense(cfg.hidden_size, cfg.hidden_size)

    def forward(self, seq):
        return torch.tanh(self.dense(seq[:, 0]))


class LXRTXLayer(nn.Module):
    """One cross-attention shared by both directions, then per-stream
    self-attention and feed-forward."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.visual_attention = BertXAttention(cfg)
        self.lang_self_att = BertAttention(cfg)
        self.visn_self_att = BertAttention(cfg)
        self.lang_inter = BertIntermediate(cfg)
        self.visn_inter = BertIntermediate(cfg)
        self.lang_output = BertOutput(cfg)
        self.visn_output = BertOutput(cfg)

    def forward(self, lang, lang_bias, visn, visn_bias, gen=None):
        lang_x = self.visual_attention(lang, visn, visn_bias, gen)
        visn_x = self.visual_attention(visn, lang, lang_bias, gen)
        lang_s = self.lang_self_att(lang_x, lang_bias, gen)
        visn_s = self.visn_self_att(visn_x, visn_bias, gen)
        lang_o = self.lang_output(self.lang_inter(lang_s), lang_s, gen)
        visn_o = self.visn_output(self.visn_inter(visn_s), visn_s, gen)
        return lang_o, visn_o


class VisionEncoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.visn_fc = Dense(cfg.img_feature_dim, cfg.hidden_size)
        self.visn_layer_norm = LayerNorm(cfg.hidden_size, eps=1e-12)
        self.rate = cfg.hidden_dropout_prob

    def forward(self, feats, gen=None):
        return dropout(self.visn_layer_norm(self.visn_fc(feats)), self.rate,
                       gen)


class DicModel(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.lalayer = nn.ModuleList(
            [BertLayer(cfg) for _ in range(cfg.la_layers)])
        self.addlayer = nn.ModuleList(
            [LXRTXLayer(cfg) for _ in range(cfg.vl_layers)])
        self.vlayer = nn.ModuleList()
        self.vision_encoder = VisionEncoder(cfg)
        self.pooler = BertPooler(cfg)

    def text_forward(self, input_ids, att_mask, gen=None):
        bias = extended_attention_mask(att_mask)
        with torch.no_grad():
            x = self.embeddings(input_ids, gen)
            for layer in self.lalayer:
                x = layer(x, bias, gen)
        return x

    def cross_forward(self, text_embeds, att_mask,
                      img_feats: Optional[torch.Tensor], gen=None):
        lang_bias = extended_attention_mask(att_mask)
        lang = text_embeds.float()
        with torch.no_grad():
            visn = self.vision_encoder(img_feats, gen)
            for layer in self.addlayer:
                lang, visn = layer(lang, lang_bias, visn, None, gen)
        return lang, self.pooler(lang), visn
