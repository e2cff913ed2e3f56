"""The DASA instruction encoder.

Counterpart of ``DicEncoder`` in ``dasa_tpu/models/encoder.py``
(reference r2r_src/r2rmodel.py:2199-2365): the DicModel cross-modal BERT,
masked input reversal, the top LSTM (bidirectional, or one direction),
the projections to decoder dims and, with ``ctx_v``, the projection of
the vision tokens to the feature width.  ``text_forward`` runs once per
episode; the cross layers and the top LSTM run every step, followed by
the ``d_dropout_ratio`` dropout on the instruction ctx
(``dasa_tpu/models/encoder.py:226,276``).  The other encoders of the JAX
module (``EncoderLSTM``, ``BertTextEncoderLSTM``, ``MultiDicEncoder``) come
with a later slice (ROADMAP.md).
"""

from __future__ import annotations

import torch
from torch import nn

from dasa_tpu_torch.models.bert import BertConfig, DicModel
from dasa_tpu_torch.models.layers import LSTM, BiLSTM, Dense, dropout


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
            self.lstm = (BiLSTM(hidden_size, hid, compute_dtype)
                         if bidirectional
                         else LSTM(hidden_size, hid,
                                   compute_dtype=compute_dtype))
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
