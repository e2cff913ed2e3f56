"""The legacy encoder zoo.

Counterpart of ``dasa_tpu/models/legacy.py`` (reference
r2r_src/r2rmodel.py:82-3162), selected by ``--encoderType``:

- :class:`TransformerTextEncoder` (``Transformer``): word embeddings, a
  self-attention stack and the top LSTM (r2rmodel.py:352-456); with
  ``causal`` the ``Gpt`` variant (r2rmodel.py:559-634).  Plain-encoder
  contract ``(ctx, decoder_init, c_t)``: it runs once per episode;
- :class:`BertImgEncoder` (``BertImg``, legacy ``vlbert``): one BERT over
  the joint [36 vision; L text] sequence (vilmodel.py:661-806); only the
  embeddings cache per episode;
- :class:`BertAddEncoder` (``BertAdd``): a text-only BERT stack, cached
  per episode, then ``vl_layers`` joint add-layers over [vision; text]
  (vilmodel.py:858-1010); ``strip_vision_ctx`` is ``BertMix``
  (r2rmodel.py:1755-1904), whose ctx keeps the text rows only.

The two cross encoders have ``DicEncoder``'s contract: ``text_forward``
per episode, ``forward`` per step returning ``(ctx, decoder_init, c_t,
None, visn)``.  Every encoder ends in :class:`LstmTail`, whose LSTM takes
``lstm_kernel`` (K1 forward and K2 backward on the card).  The BERT
blocks are ``models/bert.py``'s, at the encoder's own ``BertConfig``.
"""

from __future__ import annotations

import torch
from torch import nn

from dasa_tpu_torch.models.bert import (
    BertConfig,
    BertEmbeddings,
    BertLayer,
    extended_attention_mask,
)
from dasa_tpu_torch.models.encoder import _lstm
from dasa_tpu_torch.models.layers import Dense, dropout


class LstmTail(nn.Module):
    """The top LSTM and decoder-init projections every legacy encoder ends
    in (r2rmodel.py:431-456): ``encoder2decoder_ct`` exists only where
    the LSTM's width ``hidden * directions`` differs from the decoder's."""

    def __init__(self, in_features: int, hidden_size: int,
                 dec_hidden_size: int, bidirectional: bool = True,
                 dropout_ratio: float = 0.0, compute_dtype=torch.float32):
        super().__init__()
        self.dropout_ratio = dropout_ratio
        self.lstm = _lstm(hidden_size, in_features, bidirectional,
                          compute_dtype)
        out = hidden_size * (2 if bidirectional else 1)
        kw = dict(compute_dtype=compute_dtype)
        self.encoder2decoder_ht = Dense(out, dec_hidden_size, **kw)
        if out != dec_hidden_size:
            self.encoder2decoder_ct = Dense(out, dec_hidden_size, **kw)

    def forward(self, ctx_in, valid_mask, lstm_kernel: bool = False,
                gen=None):
        ctx, (h_t, c_t) = self.lstm(ctx_in, valid_mask, kernel=lstm_kernel)
        decoder_init = torch.tanh(self.encoder2decoder_ht(h_t))
        if hasattr(self, "encoder2decoder_ct"):
            c_t = self.encoder2decoder_ct(c_t)
        return dropout(ctx, self.dropout_ratio, gen), decoder_init, c_t


class TransformerTextEncoder(nn.Module):
    """Word embeddings + ``n_layers`` BERT layers (``heads`` heads,
    intermediate ``4 * width``) + :class:`LstmTail`; ``causal`` adds the
    triangular mask of the ``Gpt`` variant."""

    def __init__(self, vocab_size: int, width: int, heads: int,
                 n_layers: int, hidden_size: int, dec_hidden_size: int,
                 bidirectional: bool = True, causal: bool = False,
                 dropout_ratio: float = 0.0, compute_dtype=torch.float32):
        super().__init__()
        self.causal = causal
        self.compute_dtype = compute_dtype
        cfg = BertConfig(vocab_size=vocab_size, hidden_size=width,
                         num_attention_heads=heads,
                         intermediate_size=4 * width,
                         hidden_dropout_prob=dropout_ratio,
                         attention_probs_dropout_prob=dropout_ratio)
        self.embeddings = BertEmbeddings(cfg, compute_dtype)
        self.layers = nn.ModuleList(BertLayer(cfg, compute_dtype)
                                    for _ in range(n_layers))
        self.tail = LstmTail(width, hidden_size, dec_hidden_size,
                             bidirectional, dropout_ratio, compute_dtype)

    def forward(self, inputs, valid_mask, lstm_kernel: bool = False,
                gen=None):
        x = self.embeddings(inputs, gen)
        bias = extended_attention_mask(valid_mask, self.compute_dtype)
        if self.causal:
            length = inputs.shape[1]
            tri = torch.ones(length, length, dtype=bias.dtype,
                             device=bias.device).tril()
            bias = bias + (1.0 - tri)[None, None] * -10000.0
        for layer in self.layers:
            x = layer(x, bias, gen)
        return self.tail(x, valid_mask, lstm_kernel, gen)


def _joint(img, text_embeds, valid_mask):
    """The [vision; text] sequence and its valid mask (every view valid)."""
    ones = torch.ones(img.shape[:2], dtype=torch.bool, device=img.device)
    return (torch.cat([img, text_embeds.to(img.dtype)], dim=1),
            torch.cat([ones, valid_mask], dim=1))


class BertImgEncoder(nn.Module):
    """Single-stream BERT over [vision; text] (the legacy ``vlbert``):
    every one of the ``la_layers`` layers attends across both, so only
    the embedding lookup caches per episode; ctx spans the joint
    (36 + L) tokens."""

    def __init__(self, bert_config: BertConfig, hidden_size: int,
                 dec_hidden_size: int, bidirectional: bool = True,
                 n_vision_tokens: int = 36, dropout_ratio: float = 0.0,
                 compute_dtype=torch.float32):
        super().__init__()
        cfg = bert_config
        self.n_vision_tokens = n_vision_tokens
        self.compute_dtype = compute_dtype
        self.embeddings = BertEmbeddings(cfg, compute_dtype)
        self.img_embedding = Dense(cfg.img_feature_dim, cfg.hidden_size,
                                   compute_dtype=compute_dtype)
        self.layers = nn.ModuleList(BertLayer(cfg, compute_dtype)
                                    for _ in range(cfg.la_layers))
        self.tail = LstmTail(cfg.hidden_size, hidden_size, dec_hidden_size,
                             bidirectional, dropout_ratio, compute_dtype)

    def text_forward(self, inputs, valid_mask, gen=None):
        return self.embeddings(inputs, gen)

    def forward(self, text_embeds, valid_mask, seq_len, f_t_all=None,
                lstm_kernel: bool = False, gen=None):
        joint, joint_valid = _joint(self.img_embedding(f_t_all),
                                    text_embeds, valid_mask)
        bias = extended_attention_mask(joint_valid, self.compute_dtype)
        for layer in self.layers:
            joint = layer(joint, bias, gen)
        visn = joint[:, :self.n_vision_tokens]
        ctx, decoder_init, c_t = self.tail(joint, joint_valid, lstm_kernel,
                                           gen)
        return ctx, decoder_init, c_t, None, visn


class BertAddEncoder(nn.Module):
    """A text-only BERT stack (``la_layers``, frozen unless
    ``update_lang_bert``), cached per episode like DicModel's, then
    ``vl_layers`` joint add-layers over [vision; text] every step; ctx
    spans the joint tokens, or with ``strip_vision_ctx`` (BertMix,
    r2rmodel.py:1776) the text rows only."""

    def __init__(self, bert_config: BertConfig, hidden_size: int,
                 dec_hidden_size: int, bidirectional: bool = True,
                 n_vision_tokens: int = 36, strip_vision_ctx: bool = False,
                 dropout_ratio: float = 0.0, compute_dtype=torch.float32):
        super().__init__()
        cfg = bert_config
        self.config = cfg
        self.n_vision_tokens = n_vision_tokens
        self.strip_vision_ctx = strip_vision_ctx
        self.compute_dtype = compute_dtype
        self.embeddings = BertEmbeddings(cfg, compute_dtype)
        self.text_layers = nn.ModuleList(BertLayer(cfg, compute_dtype)
                                         for _ in range(cfg.la_layers))
        self.img_embedding = Dense(cfg.img_feature_dim, cfg.hidden_size,
                                   compute_dtype=compute_dtype)
        self.add_layers = nn.ModuleList(BertLayer(cfg, compute_dtype)
                                        for _ in range(cfg.vl_layers))
        self.tail = LstmTail(cfg.hidden_size, hidden_size, dec_hidden_size,
                             bidirectional, dropout_ratio, compute_dtype)

    def text_forward(self, inputs, valid_mask, gen=None):
        """The text stack; frozen, it records no graph (the JAX
        module's stop_gradient)."""
        bias = extended_attention_mask(valid_mask, self.compute_dtype)
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and self.config.update_lang_bert):
            x = self.embeddings(inputs, gen)
            for layer in self.text_layers:
                x = layer(x, bias, gen)
        return x

    def forward(self, text_embeds, valid_mask, seq_len, f_t_all=None,
                lstm_kernel: bool = False, gen=None):
        joint, joint_valid = _joint(self.img_embedding(f_t_all),
                                    text_embeds, valid_mask)
        bias = extended_attention_mask(joint_valid, self.compute_dtype)
        for layer in self.add_layers:
            joint = layer(joint, bias, gen)
        visn = joint[:, :self.n_vision_tokens]
        if self.strip_vision_ctx:
            seq, seq_valid = joint[:, -valid_mask.shape[1]:], valid_mask
        else:
            seq, seq_valid = joint, joint_valid
        ctx, decoder_init, c_t = self.tail(seq, seq_valid, lstm_kernel, gen)
        return ctx, decoder_init, c_t, None, visn
