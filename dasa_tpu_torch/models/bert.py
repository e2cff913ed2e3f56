"""Cross-modal BERT (DicModel) in PyTorch.

Counterpart of ``dasa_tpu/models/bert.py`` (reference r2r_src/vilmodel.py):
BERT embeddings, self-attention layers, the LXMERT-style cross layer with
ONE shared cross-attention used in both directions, the vision encoder,
and ``DicModel`` split into ``text_forward`` (cached once per episode) and
``cross_forward`` (every step).  Parameter names follow the reference's
torch ``state_dict``.  The additive attention mask is -10000, GELU is
exact, and LayerNorm eps is 1e-12, as in the reference.  Hidden and
attention-probability dropout sit where the JAX modules put them
(``dasa_tpu/models/bert.py:89,142,160,214,294``); every ``forward`` takes
the dropout generator ``gen`` (None = no dropout).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from dasa_tpu_torch.models.layers import Dense, cast_param, dropout


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
    # DASA-injected fields (r2rmodel.py:2218-2235)
    img_feature_dim: int = 2176
    la_layers: int = 9
    vl_layers: int = 3
    v_layers: int = 0
    update_lang_bert: bool = False
    update_add_layer: bool = False
    action_space: int = 36

    @staticmethod
    def base(**kw) -> "BertConfig":
        return BertConfig(**kw)

    @staticmethod
    def large(**kw) -> "BertConfig":
        kw.setdefault("hidden_size", 1024)
        kw.setdefault("num_attention_heads", 16)
        kw.setdefault("intermediate_size", 4096)
        return BertConfig(**kw)


def extended_attention_mask(mask: torch.Tensor, dtype) -> torch.Tensor:
    """(B, L) 1/0 valid mask -> additive (B, 1, 1, L) bias of 0 / -10000
    (vilmodel.py:1345-1355)."""
    m = mask.to(dtype)[:, None, None, :]
    return (1.0 - m) * -10000.0


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` (weight/bias, f32) computing in ``compute_dtype``."""

    def __init__(self, width: int, eps: float, compute_dtype=torch.float32):
        super().__init__(width, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return nn.functional.layer_norm(
            x.to(dt), self.normalized_shape, cast_param(self.weight, dt),
            cast_param(self.bias, dt), self.eps)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        for emb in (self.word_embeddings, self.position_embeddings,
                    self.token_type_embeddings):
            nn.init.normal_(emb.weight, std=1.0 / math.sqrt(cfg.hidden_size))
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                   compute_dtype)
        self.rate = cfg.hidden_dropout_prob

    def forward(self, input_ids, gen=None):
        dt = self.compute_dtype
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = (self.word_embeddings(input_ids).to(dt)
             + self.position_embeddings(pos)[None].to(dt)
             + self.token_type_embeddings.weight[0].to(dt))
        return dropout(self.LayerNorm(x), self.rate, gen)


class BertAttentionCore(nn.Module):
    """Multi-head attention of query_input over kv_input with an additive
    mask (BertSelfAttention / BertOutAttention, vilmodel.py:200-250,
    443-509)."""

    def __init__(self, cfg: BertConfig, compute_dtype=torch.float32):
        super().__init__()
        hid = cfg.hidden_size
        self.n_head = cfg.num_attention_heads
        self.query = Dense(hid, hid, compute_dtype=compute_dtype)
        self.key = Dense(hid, hid, compute_dtype=compute_dtype)
        self.value = Dense(hid, hid, compute_dtype=compute_dtype)
        self.rate = cfg.attention_probs_dropout_prob

    def forward(self, query_input, kv_input, att_bias, gen=None):
        def split(x):
            b, l, w = x.shape
            return x.reshape(b, l, self.n_head, w // self.n_head).transpose(
                1, 2)

        q = split(self.query(query_input))
        k = split(self.key(kv_input))
        v = split(self.value(kv_input))
        scores = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
        if att_bias is not None:
            scores = scores + att_bias
        probs = dropout(torch.softmax(scores, dim=-1), self.rate, gen)
        ctx = probs @ v
        b, h, l, d = ctx.shape
        return ctx.transpose(1, 2).reshape(b, l, h * d)


class BertSelfOutput(nn.Module):
    """Dense + dropout + residual LayerNorm (vilmodel.py:253-266)."""

    def __init__(self, cfg: BertConfig, compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.dense = Dense(cfg.hidden_size, cfg.hidden_size,
                           compute_dtype=compute_dtype)
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                   compute_dtype)
        self.rate = cfg.hidden_dropout_prob

    def forward(self, hidden, residual, gen=None):
        hidden = dropout(self.dense(hidden), self.rate, gen)
        return self.LayerNorm(hidden + residual.to(self.compute_dtype))


class BertAttention(nn.Module):
    """Self-attention block (vilmodel.py:269-300)."""

    def __init__(self, cfg: BertConfig, compute_dtype=torch.float32):
        super().__init__()
        self.self = BertAttentionCore(cfg, compute_dtype)
        self.output = BertSelfOutput(cfg, compute_dtype)

    def forward(self, x, att_bias, gen=None):
        return self.output(self.self(x, x, att_bias, gen), x, gen)


class BertXAttention(nn.Module):
    """Cross-attention block (vilmodel.py:443-453)."""

    def __init__(self, cfg: BertConfig, compute_dtype=torch.float32):
        super().__init__()
        self.att = BertAttentionCore(cfg, compute_dtype)
        self.output = BertSelfOutput(cfg, compute_dtype)

    def forward(self, x, ctx, ctx_att_bias, gen=None):
        return self.output(self.att(x, ctx, ctx_att_bias, gen), x, gen)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig, compute_dtype=torch.float32):
        super().__init__()
        self.dense = Dense(cfg.hidden_size, cfg.intermediate_size,
                           compute_dtype=compute_dtype)

    def forward(self, x):
        return nn.functional.gelu(self.dense(x))  # exact (erf) GELU


class BertOutput(nn.Module):
    def __init__(self, cfg: BertConfig, compute_dtype=torch.float32):
        super().__init__()
        self.dense = Dense(cfg.intermediate_size, cfg.hidden_size,
                           compute_dtype=compute_dtype)
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                   compute_dtype)
        self.rate = cfg.hidden_dropout_prob

    def forward(self, hidden, residual, gen=None):
        hidden = dropout(self.dense(hidden), self.rate, gen)
        return self.LayerNorm(hidden + residual)


class BertLayer(nn.Module):
    """Transformer encoder layer (vilmodel.py:335-353)."""

    def __init__(self, cfg: BertConfig, compute_dtype=torch.float32):
        super().__init__()
        self.attention = BertAttention(cfg, compute_dtype)
        self.intermediate = BertIntermediate(cfg, compute_dtype)
        self.output = BertOutput(cfg, compute_dtype)

    def forward(self, x, att_bias, gen=None):
        attn_out = self.attention(x, att_bias, gen)
        return self.output(self.intermediate(attn_out), attn_out, gen)


class BertPooler(nn.Module):
    """tanh Dense on the CLS token (vilmodel.py:426-441)."""

    def __init__(self, cfg: BertConfig, compute_dtype=torch.float32):
        super().__init__()
        self.dense = Dense(cfg.hidden_size, cfg.hidden_size,
                           compute_dtype=compute_dtype)

    def forward(self, seq):
        return torch.tanh(self.dense(seq[:, 0]))


class LXRTXLayer(nn.Module):
    """Cross-modal layer: one shared cross-attention applied in both
    directions, then per-stream self-attention and FFN
    (vilmodel.py:1014-1064)."""

    def __init__(self, cfg: BertConfig, compute_dtype=torch.float32):
        super().__init__()
        self.visual_attention = BertXAttention(cfg, compute_dtype)
        self.lang_self_att = BertAttention(cfg, compute_dtype)
        self.visn_self_att = BertAttention(cfg, compute_dtype)
        self.lang_inter = BertIntermediate(cfg, compute_dtype)
        self.visn_inter = BertIntermediate(cfg, compute_dtype)
        self.lang_output = BertOutput(cfg, compute_dtype)
        self.visn_output = BertOutput(cfg, compute_dtype)

    def forward(self, lang, lang_bias, visn, visn_bias, gen=None):
        lang_x = self.visual_attention(lang, visn, visn_bias, gen)
        visn_x = self.visual_attention(visn, lang, lang_bias, gen)
        lang_s = self.lang_self_att(lang_x, lang_bias, gen)
        visn_s = self.visn_self_att(visn_x, visn_bias, gen)
        lang_o = self.lang_output(self.lang_inter(lang_s), lang_s, gen)
        visn_o = self.visn_output(self.visn_inter(visn_s), visn_s, gen)
        return lang_o, visn_o


class VisionEncoder(nn.Module):
    """Linear + LN + dropout on panorama features
    (vilmodel.py:1067-1095)."""

    def __init__(self, cfg: BertConfig, compute_dtype=torch.float32):
        super().__init__()
        self.visn_fc = Dense(cfg.img_feature_dim, cfg.hidden_size,
                             compute_dtype=compute_dtype)
        self.visn_layer_norm = LayerNorm(cfg.hidden_size, 1e-12,
                                         compute_dtype)
        self.rate = cfg.hidden_dropout_prob

    def forward(self, feats, gen=None):
        return dropout(self.visn_layer_norm(self.visn_fc(feats)), self.rate,
                       gen)


class DicModel(nn.Module):
    """The DASA cross-modal encoder (vilmodel.py:1245-1423), split so the
    text-only stack runs once per episode (exact when
    ``update_lang_bert`` is False: only the vision input changes per
    step).  ``text_only`` builds the text stack alone, for the encoders
    that call only :meth:`text_forward` (flax creates no other
    parameters there)."""

    def __init__(self, cfg: BertConfig, compute_dtype=torch.float32,
                 text_only: bool = False):
        super().__init__()
        self.config = cfg
        self.compute_dtype = compute_dtype
        self.embeddings = BertEmbeddings(cfg, compute_dtype)
        self.lalayer = nn.ModuleList(
            [BertLayer(cfg, compute_dtype) for _ in range(cfg.la_layers)])
        if text_only:
            return
        self.addlayer = nn.ModuleList(
            [LXRTXLayer(cfg, compute_dtype) for _ in range(cfg.vl_layers)])
        self.vlayer = nn.ModuleList(
            [BertLayer(cfg, compute_dtype) for _ in range(cfg.v_layers)])
        self.vision_encoder = VisionEncoder(cfg, compute_dtype)
        self.pooler = BertPooler(cfg, compute_dtype)

    def text_forward(self, input_ids, att_mask, gen=None,
                     collect_last_n: int = 1):
        """Embeddings + la_layers text-only self-attention.  att_mask is
        (B, L) with 1 = attend.  ``collect_last_n`` > 1 returns the channel
        concat of the last n layers' outputs (the legacy encoders'
        ``bert_n_layers``, r2rmodel.py:772-773,
        ``dasa_tpu/models/bert.py:321``).  Frozen (``update_lang_bert``
        off), the stack records no graph: its output is detached, as the
        reference detaches it."""
        if collect_last_n > len(self.lalayer):
            raise ValueError(f"collect_last_n={collect_last_n} exceeds "
                             f"la_layers={len(self.lalayer)}")
        bias = extended_attention_mask(att_mask, self.compute_dtype)
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and self.config.update_lang_bert):
            x = self.embeddings(input_ids, gen)
            outs = []
            for layer in self.lalayer:
                x = layer(x, bias, gen)
                outs.append(x)
            if collect_last_n > 1:
                x = torch.cat(outs[-collect_last_n:], dim=-1)
        return x

    def cross_forward(self, text_embeds, att_mask,
                      img_feats: Optional[torch.Tensor], gen=None):
        """Vision encoding + vl_layers cross-modal attention + pooling.
        Frozen (``update_add_layer`` off), the vision and cross layers
        record no graph, as the reference detaches their outputs."""
        lang_bias = extended_attention_mask(att_mask, self.compute_dtype)
        lang = text_embeds.to(self.compute_dtype)
        visn = None
        if img_feats is not None:
            with torch.set_grad_enabled(torch.is_grad_enabled()
                                        and self.config.update_add_layer):
                visn = self.vision_encoder(img_feats, gen)
                for layer in self.vlayer:
                    visn = layer(visn, None, gen)  # all 36 views are valid
                for layer in self.addlayer:
                    lang, visn = layer(lang, lang_bias, visn, None, gen)
        return lang, self.pooler(lang), visn
