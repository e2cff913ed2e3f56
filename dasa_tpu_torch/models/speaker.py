"""Speaker networks (trajectory -> instruction).

PyTorch counterpart of ``dasa_tpu/models/speaker.py`` (reference
r2r_src/model.py:984-1078), with the reference's torch parameter names
(``lstm``, ``post_lstm``, ``attention_layer``, ``embedding``,
``projection``).  The encoder consumes the action feature sequence (the
candidate feature of each teacher move) with per-step attention over the
panorama sequence; the decoder is a word LSTM with attention over the
encoder context.  As in the reference, the encoder LSTMs run unpacked over
the padded sequence (padding carries repeated final-state features and
zero action features) and masking happens only in the decoder's ctx
attention.  Dropout draws from an explicit ``torch.Generator``; none means
no dropout.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dasa_tpu_torch.models.decoder import drop_visual
from dasa_tpu_torch.models.layers import (
    LSTM,
    BiLSTM,
    Dense,
    LstmCell,
    SoftDotAttention,
    cast_param,
    dropout,
)


class SpeakerEncoder(nn.Module):
    """Two LSTMs over the path, bidirectional (``rnn_dim / 2`` a
    direction) or, with ``bidirectional=False``, one direction of
    ``rnn_dim``.  With ``kernel=True`` they run through ``ops.lstm``'s
    autograd Functions (K1 forward, K2 backward on the card), else as the
    plain token loop."""

    def __init__(self, feature_size: int, hidden_size: int,
                 dropout_ratio: float, featdropout: float,
                 angle_feat_size: int, bidirectional: bool = True,
                 compute_dtype=torch.float32):
        super().__init__()
        self.hidden_size = hidden_size
        self.dropout_ratio = dropout_ratio
        self.featdropout = featdropout
        self.angle_feat_size = angle_feat_size
        if bidirectional:
            per_dir = hidden_size // 2
            self.lstm = BiLSTM(per_dir, feature_size, compute_dtype)
            self.post_lstm = BiLSTM(per_dir, hidden_size, compute_dtype)
        else:
            self.lstm = LSTM(hidden_size, feature_size,
                             compute_dtype=compute_dtype)
            self.post_lstm = LSTM(hidden_size, hidden_size,
                                  compute_dtype=compute_dtype)
        self.attention_layer = SoftDotAttention(
            hidden_size, feature_size, compute_dtype=compute_dtype)

    def forward(self, action_embeds, feature, already_dropfeat: bool = False,
                gen: Optional[torch.Generator] = None, kernel: bool = False):
        """action_embeds (B, T, F); feature (B, T, 36, F) -> ctx
        (B, T, hidden)."""
        rate = self.dropout_ratio
        x = action_embeds
        if not already_dropfeat:
            x = drop_visual(x, self.angle_feat_size, self.featdropout, gen)
        b, t, _ = x.shape
        all_valid = torch.ones(b, t, dtype=torch.bool, device=x.device)
        ctx, _ = self.lstm(x, all_valid, kernel=kernel)
        ctx = dropout(ctx, rate, gen)
        if not already_dropfeat:
            feature = drop_visual(feature, self.angle_feat_size,
                                  self.featdropout, gen)
        x, _ = self.attention_layer(
            ctx.reshape(b * t, self.hidden_size),
            feature.reshape(b * t, feature.shape[2], -1))
        x = dropout(x.reshape(b, t, self.hidden_size), rate, gen)
        x, _ = self.post_lstm(x, all_valid, kernel=kernel)
        return dropout(x, rate, gen)


class SpeakerDecoder(nn.Module):
    def __init__(self, vocab_size: int, embedding_size: int,
                 hidden_size: int, dropout_ratio: float,
                 compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.dropout_ratio = dropout_ratio
        self.embedding = nn.Embedding(vocab_size, embedding_size)
        self.lstm = LstmCell(hidden_size, embedding_size, compute_dtype)
        self.attention_layer = SoftDotAttention(
            hidden_size, hidden_size, compute_dtype=compute_dtype)
        self.projection = Dense(hidden_size, vocab_size,
                                compute_dtype=compute_dtype)

    def step(self, word, ctx, ctx_mask, h, c,
             gen: Optional[torch.Generator] = None):
        """One decode step: word (B,) int64 -> (logits (B, V), h, c)."""
        rate = self.dropout_ratio
        x = cast_param(self.embedding.weight, self.compute_dtype)[word]
        x = dropout(x, rate, gen)
        h, c = self.lstm((h, c), x)
        y = dropout(h, rate, gen)
        y, _ = self.attention_layer(y, ctx, ctx_mask)
        y = dropout(y, rate, gen)
        return self.projection(y), h, c

    def forward(self, words, ctx, ctx_mask, h0, c0,
                gen: Optional[torch.Generator] = None):
        """Teacher-forced decode over words (B*m, Lw) -> logits
        (B*m, Lw, V).  The words batch may be an integer multiple m of the
        ctx batch, the beam expansion multiplier (reference
        model.py:1060-1071): each ctx row is repeated for its m beams."""
        mult = words.shape[0] // ctx.shape[0]
        if mult > 1:
            ctx = ctx.repeat_interleave(mult, 0)
            ctx_mask = ctx_mask.repeat_interleave(mult, 0)
        h, c = h0, c0
        logits = []
        for i in range(words.shape[1]):
            logit, h, c = self.step(words[:, i], ctx, ctx_mask, h, c, gen)
            logits.append(logit)
        return torch.stack(logits, 1)


class SpeakerModel(nn.Module):
    """``encoder`` + ``decoder`` at the config's widths
    (``dasa_tpu/agents/speaker.py:SpeakerModel``)."""

    def __init__(self, cfg, vocab_size: int, compute_dtype=torch.float32):
        super().__init__()
        self.encoder = SpeakerEncoder(
            cfg.feature_all_size, cfg.rnn_dim, cfg.dropout, cfg.featdropout,
            cfg.angle_feat_size, bidirectional=cfg.bidir,
            compute_dtype=compute_dtype)
        self.decoder = SpeakerDecoder(vocab_size, cfg.wemb, cfg.rnn_dim,
                                      cfg.dropout,
                                      compute_dtype=compute_dtype)
