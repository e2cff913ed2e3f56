"""MCAN co-attention blocks: the agent_mcatt ablation encoder.

Counterpart of ``dasa_tpu/models/mcan.py`` (reference
r2r_src/model.py:1083-1462): the Modular Co-Attention Network (MHAtt +
FFN, SA self-attention blocks, SGA guided attention, the stacked SGA-SGA
backbone, AttFlat pooling) and the McattEncoder that co-attends the
instruction tokens with the 36-view panorama (param.py:233-244).  Masks
are True at masked positions.  McattEncoder's dropout rate is the JAX
module's fixed 0.1, drawn from ``gen`` (None = none).
LayerNorm eps is flax's default, 1e-6.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from dasa_tpu_torch.models.bert import LayerNorm
from dasa_tpu_torch.models.layers import NEG_INF, BiLSTM, Dense, dropout

LN_EPS = 1e-6


class MHAtt(nn.Module):
    """Multi-head scaled dot attention with the merge projection."""

    def __init__(self, hidden_size: int, n_head: int, rate: float,
                 compute_dtype=torch.float32):
        super().__init__()
        self.n_head = n_head
        self.hidden_size = hidden_size
        self.rate = rate
        for name in ("linear_v", "linear_k", "linear_q", "linear_merge"):
            setattr(self, name, Dense(hidden_size, hidden_size,
                                      compute_dtype=compute_dtype))

    def forward(self, v, k, q, mask=None, gen=None):
        """mask (B, 1, 1, Lk) True = masked."""
        b = q.shape[0]

        def heads(x):
            return x.reshape(b, -1, self.n_head,
                             x.shape[-1] // self.n_head).transpose(1, 2)

        vq, vk, vv = (heads(self.linear_q(q)), heads(self.linear_k(k)),
                      heads(self.linear_v(v)))
        scores = vq @ vk.transpose(-1, -2) / math.sqrt(vq.shape[-1])
        if mask is not None:
            scores = scores.masked_fill(mask, NEG_INF)
        att = dropout(torch.softmax(scores, dim=-1), self.rate, gen)
        out = (att @ vv).transpose(1, 2).reshape(b, -1, self.hidden_size)
        return self.linear_merge(out)


class FFN(nn.Sequential):
    """Linear-ReLU-dropout-Linear; the JAX module's ``Dense_0`` and
    ``Dense_1`` are ``0`` and ``2``."""

    def __init__(self, in_size: int, mid_size: int, out_size: int,
                 rate: float, compute_dtype=torch.float32):
        kw = dict(compute_dtype=compute_dtype)
        super().__init__(Dense(in_size, mid_size, **kw), nn.ReLU(),
                         Dense(mid_size, out_size, **kw))
        self.rate = rate

    def forward(self, x, gen=None):
        return self[2](dropout(torch.relu(self[0](x)), self.rate, gen))


class SA(nn.Module):
    """Self-attention block with residual LayerNorms."""

    def __init__(self, hidden_size: int, n_head: int, ff_size: int,
                 rate: float, compute_dtype=torch.float32):
        super().__init__()
        self.rate = rate
        self.mhatt = MHAtt(hidden_size, n_head, rate, compute_dtype)
        self.ffn = FFN(hidden_size, ff_size, hidden_size, rate,
                       compute_dtype)
        self.norm1 = LayerNorm(hidden_size, LN_EPS, compute_dtype)
        self.norm2 = LayerNorm(hidden_size, LN_EPS, compute_dtype)

    def forward(self, x, mask=None, gen=None):
        att = self.mhatt(x, x, x, mask, gen)
        x = self.norm1(x + dropout(att, self.rate, gen))
        return self.norm2(x + dropout(self.ffn(x, gen), self.rate, gen))


class SGA(nn.Module):
    """Self-attention, then attention guided by ``y``, then the FFN."""

    def __init__(self, hidden_size: int, n_head: int, ff_size: int,
                 rate: float, compute_dtype=torch.float32):
        super().__init__()
        self.rate = rate
        self.mhatt1 = MHAtt(hidden_size, n_head, rate, compute_dtype)
        self.mhatt2 = MHAtt(hidden_size, n_head, rate, compute_dtype)
        self.ffn = FFN(hidden_size, ff_size, hidden_size, rate,
                       compute_dtype)
        for i in (1, 2, 3):
            setattr(self, f"norm{i}",
                    LayerNorm(hidden_size, LN_EPS, compute_dtype))

    def forward(self, x, y, x_mask=None, y_mask=None, gen=None):
        att = self.mhatt1(x, x, x, x_mask, gen)
        x = self.norm1(x + dropout(att, self.rate, gen))
        att = self.mhatt2(y, y, x, y_mask, gen)
        x = self.norm2(x + dropout(att, self.rate, gen))
        return self.norm3(x + dropout(self.ffn(x, gen), self.rate, gen))


class MCASGASGA(nn.Module):
    """The co-attention backbone (model.py MCA_SGA_SGA): per layer, SA on
    each stream, then SGA in both directions (``sa_x.i``, ``sa_y.i``,
    ``sga_x.i``, ``sga_y.i`` are the JAX module's ``sa_x_i``, ...)."""

    def __init__(self, hidden_size: int, n_head: int, ff_size: int,
                 n_layers: int, rate: float, compute_dtype=torch.float32):
        super().__init__()
        for name, cls in (("sa_x", SA), ("sa_y", SA), ("sga_x", SGA),
                          ("sga_y", SGA)):
            setattr(self, name, nn.ModuleList(
                cls(hidden_size, n_head, ff_size, rate, compute_dtype)
                for _ in range(n_layers)))

    def forward(self, x, y, x_mask=None, y_mask=None, gen=None):
        for sa_x, sa_y, sga_x, sga_y in zip(self.sa_x, self.sa_y, self.sga_x,
                                            self.sga_y):
            x = sa_x(x, x_mask, gen)
            y = sa_y(y, y_mask, gen)
            x2 = sga_x(x, y, x_mask, y_mask, gen)
            y = sga_y(y, x, y_mask, x_mask, gen)
            x = x2
        return x, y


class AttFlat(nn.Module):
    """Attention-weighted flattening of a token stream to one vector: the
    JAX module's ``Dense_0``, ``Dense_1`` (the glimpse scores) and
    ``Dense_2`` are ``mlp.0``, ``mlp.2`` and ``linear_merge``."""

    def __init__(self, hidden_size: int, flat_mlp_size: int,
                 flat_out_size: int, glimpses: int = 1, rate: float = 0.1,
                 compute_dtype=torch.float32):
        super().__init__()
        self.mlp = FFN(hidden_size, flat_mlp_size, glimpses, rate,
                       compute_dtype)
        self.linear_merge = Dense(hidden_size * glimpses, flat_out_size,
                                  compute_dtype=compute_dtype)

    def forward(self, x, mask=None, gen=None):
        att = self.mlp(x, gen)                                 # (B, L, G)
        if mask is not None:
            att = att.masked_fill(mask[:, 0, 0, :, None], NEG_INF)
        att = torch.softmax(att, dim=1)
        pooled = torch.einsum("blg,bld->bgd", att, x.to(att.dtype))
        return self.linear_merge(pooled.flatten(1))


class McattEncoder(nn.Module):
    """Instruction x panorama co-attention encoder (model.py:1340-1462),
    split as the DicModel is: :meth:`text_forward` (embedding + BiLSTM at
    ``hidden_size / 2`` a direction, vision-independent, cached per
    episode) and :meth:`cross_forward` (the backbone, AttFlat of the text
    and the flat text query's attention over the vision stream, every
    step)."""

    def __init__(self, vocab_size: int, word_embed_size: int,
                 hidden_size: int, n_head: int, ff_size: int, n_layers: int,
                 img_feat_size: int, flat_mlp_size: int = 512,
                 flat_out_size: int = 768, rate: float = 0.1,
                 compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.embedding = nn.Embedding(vocab_size, word_embed_size)
        nn.init.normal_(self.embedding.weight,
                        std=1.0 / math.sqrt(word_embed_size))
        self.lstm = BiLSTM(hidden_size // 2, word_embed_size, compute_dtype)
        self.img_feat_linear = Dense(img_feat_size, hidden_size,
                                     compute_dtype=compute_dtype)
        self.backbone = MCASGASGA(hidden_size, n_head, ff_size, n_layers,
                                  rate, compute_dtype)
        self.attflat_lang = AttFlat(hidden_size, flat_mlp_size,
                                    flat_out_size, rate=rate,
                                    compute_dtype=compute_dtype)

    def text_forward(self, seq, pad_mask, lstm_kernel: bool = False):
        """seq (B, L) word ids, pad_mask (B, L) True at padding ->
        the token stream (B, L, H)."""
        x = self.embedding(seq).to(self.compute_dtype)
        return self.lstm(x, ~pad_mask, kernel=lstm_kernel)[0]

    def cross_forward(self, x, pad_mask, f_t_all, gen=None):
        """Co-attention over (token stream, panorama (B, 36, F)).  Returns
        (seq_feat, attended_txt, v_feat, attended_v)."""
        seq_mask = pad_mask[:, None, None, :]
        v = self.img_feat_linear(f_t_all)
        v_mask = torch.zeros(v.shape[0], 1, 1, v.shape[1], dtype=torch.bool,
                             device=v.device)
        x, v = self.backbone(x.to(v.dtype), v, seq_mask, v_mask, gen)
        attended_txt = self.attflat_lang(x, seq_mask, gen)
        # single-head dot attention of the flat text query over vision
        scores = torch.einsum("bd,bvd->bv", attended_txt, v) / math.sqrt(
            attended_txt.shape[-1])
        attended_v = torch.einsum("bv,bvd->bd", torch.softmax(scores, -1), v)
        return x, attended_txt, v, attended_v

    def forward(self, seq, pad_mask, f_t_all, lstm_kernel: bool = False,
                gen=None):
        return self.cross_forward(
            self.text_forward(seq, pad_mask, lstm_kernel), pad_mask,
            f_t_all, gen)
