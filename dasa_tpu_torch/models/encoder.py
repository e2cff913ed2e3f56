"""Instruction encoders.

Counterpart of ``dasa_tpu/models/encoder.py``:

- :class:`EncoderLSTM` — the plain-path encoder (reference
  r2r_src/model.py:16-86): word embedding, a masked (Bi)LSTM, the
  decoder-init projection;
- :class:`BertTextEncoderLSTM` — B/CEncoderLSTM (model.py:88-247): the
  text-only BERT (optionally frozen, optionally the concat of its last n
  layers, and for C projected to the word-embedding width) under the same
  LSTM tail;
- :class:`DicEncoder` — the DASA path (r2rmodel.py:2199-2365): the
  DicModel cross-modal BERT, masked input reversal, the top LSTM
  (bidirectional, or one direction), the projections to decoder dims and,
  with ``ctx_v``, the projection of the vision tokens to the feature
  width.  ``text_forward`` runs once per episode; the cross layers and the
  top LSTM run every step, followed by the ``d_dropout_ratio`` dropout on
  the instruction ctx (``dasa_tpu/models/encoder.py:226,276``);
- :class:`MultiDicEncoder` and :func:`merge_sentence_attention` — the
  shared-weights three-instruction DicEncoder and the per-sentence
  attention merge (r2rmodel.py:2709-2820, tasks/R2R/model.py:3571-3579).

Every LSTM here takes ``lstm_kernel``: True runs it through ``ops.lstm``'s
autograd Functions (K1 forward, K2 backward on the card).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from dasa_tpu_torch.models.bert import BertConfig, DicModel
from dasa_tpu_torch.models.layers import LSTM, BiLSTM, Dense, dropout


def _lstm(hidden: int, in_features: int, bidirectional: bool,
          compute_dtype) -> nn.Module:
    return (BiLSTM(hidden, in_features, compute_dtype) if bidirectional
            else LSTM(hidden, in_features, compute_dtype=compute_dtype))


class _LstmHead(nn.Module):
    """The tail EncoderLSTM and BertTextEncoderLSTM share
    (``dasa_tpu/models/encoder.py:45-61``): the (Bi)LSTM over the token
    features, ``encoder2decoder`` on the final state (``sub_out="tanh"``)
    or on the masked max of ctx over the tokens (``"max"``), dropout on
    ctx, and zero init states under ``zero_init``."""

    def __init__(self, in_features: int, hidden_size: int,
                 bidirectional: bool, sub_out: str, zero_init: bool,
                 dropout_ratio: float, compute_dtype):
        super().__init__()
        if sub_out not in ("tanh", "max"):
            raise ValueError(f"sub_out={sub_out!r}")
        self.sub_out = sub_out
        self.zero_init = zero_init
        self.dropout_ratio = dropout_ratio
        self.lstm = _lstm(hidden_size, in_features, bidirectional,
                          compute_dtype)
        out = hidden_size * (2 if bidirectional else 1)
        self.encoder2decoder = Dense(out, out, compute_dtype=compute_dtype)

    def _head(self, x, valid_mask, lstm_kernel: bool, gen):
        x = dropout(x, self.dropout_ratio, gen)
        ctx, (h_t, c_t) = self.lstm(x, valid_mask, kernel=lstm_kernel)
        if self.sub_out == "max":
            pooled = ctx.masked_fill(~valid_mask[..., None],
                                     float("-inf")).amax(1)
        else:
            pooled = h_t
        decoder_init = torch.tanh(self.encoder2decoder(pooled))
        ctx = dropout(ctx, self.dropout_ratio, gen)
        if self.zero_init:
            return ctx, torch.zeros_like(decoder_init), torch.zeros_like(c_t)
        return ctx, decoder_init, c_t


class EncoderLSTM(_LstmHead):
    """Embedding -> dropout -> (Bi)LSTM -> (ctx, decoder_init, c_t)
    (model.py:16-86).  ``hidden_size`` is per direction."""

    def __init__(self, vocab_size: int, embedding_size: int,
                 hidden_size: int, bidirectional: bool = True,
                 sub_out: str = "tanh", zero_init: bool = False,
                 dropout_ratio: float = 0.0, compute_dtype=torch.float32):
        super().__init__(embedding_size, hidden_size, bidirectional, sub_out,
                         zero_init, dropout_ratio, compute_dtype)
        self.compute_dtype = compute_dtype
        self.embedding = nn.Embedding(vocab_size, embedding_size)
        nn.init.normal_(self.embedding.weight,
                        std=1.0 / math.sqrt(embedding_size))

    def forward(self, inputs, valid_mask, lstm_kernel: bool = False,
                gen=None):
        """inputs (B, L) word ids; valid_mask (B, L) True = valid."""
        x = self.embedding(inputs).to(self.compute_dtype)
        return self._head(x, valid_mask, lstm_kernel, gen)


class BertTextEncoderLSTM(_LstmHead):
    """B/CEncoderLSTM (model.py:88-247): the text-only BERT embeddings
    (frozen unless ``bert_config.update_lang_bert``, as ``update_bert``
    gates the reference's ``.detach()``; the concat of the last
    ``n_layer_concat`` layers) feed the LSTM tail; the C variant first
    projects the BERT width to ``project_dim`` (``linear_in``,
    model.py:186, 221).  Fully cacheable per episode: no vision input."""

    def __init__(self, bert_config: BertConfig, hidden_size: int,
                 project_dim: Optional[int] = None,
                 bidirectional: bool = True, sub_out: str = "tanh",
                 zero_init: bool = False, n_layer_concat: int = 1,
                 dropout_ratio: float = 0.0, compute_dtype=torch.float32):
        width = bert_config.hidden_size * n_layer_concat
        super().__init__(project_dim or width, hidden_size, bidirectional,
                         sub_out, zero_init, dropout_ratio, compute_dtype)
        self.n_layer_concat = n_layer_concat
        self.bert = DicModel(bert_config, compute_dtype, text_only=True)
        if project_dim is not None:
            self.linear_in = Dense(width, project_dim,
                                   compute_dtype=compute_dtype)

    def forward(self, inputs, valid_mask, lstm_kernel: bool = False,
                gen=None):
        x = self.bert.text_forward(inputs, valid_mask.int(), gen,
                                   collect_last_n=self.n_layer_concat)
        if hasattr(self, "linear_in"):
            x = self.linear_in(x)
        return self._head(x, valid_mask, lstm_kernel, gen)


def reverse_valid_tokens(embeds, valid_mask, seq_len):
    """Reverse each row's first seq_len tokens in place, zeroing pads —
    the reference's masked scatter reversal (r2rmodel.py:2326-2330)."""
    length = embeds.shape[1]
    j = torch.arange(length, device=embeds.device)[None, :]
    src = (seq_len[:, None].long() - 1 - j).clamp(0, length - 1)
    rev = torch.gather(embeds, 1,
                       src[:, :, None].expand(-1, -1, embeds.shape[-1]))
    return torch.where(valid_mask[:, :, None], rev, torch.zeros_like(rev))


class DicEncoder(nn.Module):
    """DicModel + top LSTM instruction encoder for the DG agent."""

    def __init__(self, bert_config: BertConfig, hidden_size: int,
                 dec_hidden_size: int, bidirectional: bool = True,
                 reverse_input: bool = True, top_lstm: bool = True,
                 ctx_v: bool = False, ctx_v_dim: int = 2176,
                 compute_dtype=torch.float32, dropout_ratio: float = 0.0):
        super().__init__()
        self.hidden_size = hidden_size
        self.dec_hidden_size = dec_hidden_size
        self.reverse_input = reverse_input
        self.top_lstm = top_lstm
        self.dropout_ratio = dropout_ratio
        self.bert = DicModel(bert_config, compute_dtype)
        hid = bert_config.hidden_size
        kw = dict(compute_dtype=compute_dtype)
        # parameters exist where the JAX module creates them: only the
        # projections its forward uses
        self.num_dir = 2 if bidirectional else 1
        out = self.num_dir * hidden_size
        if top_lstm:
            self.lstm = _lstm(hidden_size, hid, bidirectional, compute_dtype)
            self.encoder_lstm2decoder_ht = Dense(out, dec_hidden_size, **kw)
            if out != dec_hidden_size:
                self.encoder_lstm2decoder_ct = Dense(out, dec_hidden_size,
                                                     **kw)
        else:
            self.encoder2decoder_ht = Dense(hid, dec_hidden_size, **kw)
            self.encoder2decoder_ct = Dense(hid, dec_hidden_size, **kw)
        if ctx_v:
            self.ctx_v_to_v = Dense(hid, ctx_v_dim, **kw)

    def text_forward(self, inputs, valid_mask, gen=None):
        """Cacheable text-only stack (exact to re-running per step when
        update_lang_bert is False)."""
        return self.bert.text_forward(inputs, valid_mask.int(), gen)

    def forward(self, text_embeds, valid_mask, seq_len, f_t_all=None,
                lstm_kernel: bool = False, gen=None):
        """text_embeds: output of text_forward (B, L, H_bert).
        Returns (ctx, decoder_init, c_t, ctx_v, visn): ``ctx_v`` (B, 36,
        ctx_v_dim) the vision tokens' projection where ``ctx_v`` is on and
        the vision stream ran, else None; ``visn`` the raw vision-token
        stream (B, 36, H_bert) the MT decoder reads.  ``lstm_kernel``
        routes the top LSTM through ``ops.lstm``'s autograd Functions (K1
        forward, K2 backward); ``gen`` draws the dropout masks (None = no
        dropout)."""
        embeds, pooled, visn = self.bert.cross_forward(
            text_embeds, valid_mask.int(), f_t_all, gen)
        if self.reverse_input:
            embeds = reverse_valid_tokens(embeds, valid_mask, seq_len)
        if not self.top_lstm:
            ctx = embeds
            c_t = self.encoder2decoder_ct(embeds[:, -1])
            decoder_init = torch.tanh(self.encoder2decoder_ht(pooled))
        else:
            ctx, (h_t, c_t) = self.lstm(embeds, valid_mask,
                                        kernel=lstm_kernel)
            decoder_init = torch.tanh(self.encoder_lstm2decoder_ht(h_t))
            if self.num_dir * self.hidden_size != self.dec_hidden_size:
                c_t = self.encoder_lstm2decoder_ct(c_t)
        ctx = dropout(ctx, self.dropout_ratio, gen)
        ctx_v = None
        if hasattr(self, "ctx_v_to_v") and visn is not None:
            ctx_v = self.ctx_v_to_v(visn)
        return ctx, decoder_init, c_t, ctx_v, visn


class MultiDicEncoder(nn.Module):
    """Shared-weights three-instruction DicEncoder (r2rmodel.py:2709-2820,
    ``multi_share=True``, the only mode the reference implements;
    ``dasa_tpu/models/encoder.py:115``): the sentence axis folds into the
    batch for one (B*S, L) pass of the same BERT and LSTM, and the
    decoder init states are averaged over the sentences
    (r2rmodel.py:2812-2817)."""

    def __init__(self, bert_config: BertConfig, hidden_size: int,
                 dec_hidden_size: int, bidirectional: bool = True,
                 reverse_input: bool = True, top_lstm: bool = True,
                 compute_dtype=torch.float32, dropout_ratio: float = 0.0):
        super().__init__()
        self.inner = DicEncoder(
            bert_config, hidden_size, dec_hidden_size,
            bidirectional=bidirectional, reverse_input=reverse_input,
            top_lstm=top_lstm, compute_dtype=compute_dtype,
            dropout_ratio=dropout_ratio)

    def text_forward(self, instr, valid_mask, gen=None):
        """instr (B, S, L) -> the folded text embeds (B*S, L, H_bert)."""
        b, s, length = instr.shape
        return self.inner.text_forward(instr.reshape(b * s, length),
                                       valid_mask.reshape(b * s, length),
                                       gen)

    def forward(self, text_embeds, valid_mask, seq_len, f_t_all=None,
                lstm_kernel: bool = False, gen=None):
        """text_embeds (B*S, L, H) from :meth:`text_forward`; valid_mask
        (B, S, L); seq_len (B, S).  Returns (ctxs (B, S, L, C),
        decoder_init, c_t, masks (B, S, L))."""
        b, s, length = valid_mask.shape
        f_rep = (None if f_t_all is None
                 else f_t_all.repeat_interleave(s, dim=0))
        ctx, h0, c0, _ctx_v, _visn = self.inner(
            text_embeds, valid_mask.reshape(b * s, length),
            seq_len.reshape(b * s), f_t_all=f_rep, lstm_kernel=lstm_kernel,
            gen=gen)
        ctxs = ctx.reshape(b, s, length, ctx.shape[-1])
        return (ctxs, h0.reshape(b, s, -1).mean(1),
                c0.reshape(b, s, -1).mean(1), valid_mask)


def merge_sentence_attention(attention_fn, h, ctxs, valid_masks,
                             merge: str = "mean"):
    """Per-sentence instruction attention and its merge (the legacy
    decoders' att_ctx_merge, tasks/R2R/model.py:3489-3498, 3571-3579):
    ``attention_fn(h, ctx, mask) -> (h_tilde, attn)`` against each
    sentence's context, the h_tildes combined by mean / sum / max or
    concatenated (``cat``).  ctxs (B, S, L, C); valid_masks (B, S, L)
    True = valid.  Returns (merged, the per-sentence attentions)."""
    tildes, attns = [], []
    for si in range(ctxs.shape[1]):
        h_tilde, attn = attention_fn(h, ctxs[:, si], ~valid_masks[:, si])
        tildes.append(h_tilde)
        attns.append(attn)
    stack = torch.stack(tildes, dim=1)                       # (B, S, D)
    if merge == "mean":
        merged = stack.mean(1)
    elif merge == "sum":
        merged = stack.sum(1)
    elif merge == "max":
        merged = stack.amax(1)
    elif merge == "cat":
        merged = stack.flatten(1)
    else:
        raise ValueError(merge)
    return merged, attns
