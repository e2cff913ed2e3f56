"""The DASA action decoder and the A2C critic.

Counterpart of ``BAttnDecoderLSTM`` and ``Critic`` in
``dasa_tpu/models/decoder.py`` (reference r2r_src/model.py:422-574,
970-982), as single-step modules.  Dropout, the visual featdropout
(``drop_visual``) and ``already_dropfeat`` follow the JAX modules; every
``forward`` takes the dropout generator ``gen`` (None = no dropout).  The
JAX decoder's ``input_noise`` / ``output_noise`` inputs, which no agent
path passes, are left out; the back-logit and progress-monitor heads and
the DyReLU candidate path raise until their slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from dasa_tpu_torch.models.layers import (
    Dense,
    LstmCell,
    ShiftSoftDotAttention,
    SoftDotAttention,
    dropout,
)


def drop_visual(x, angle_feat_size: int, rate: float, gen):
    """Dropout on the visual channels only, keeping the trailing angle
    features intact (``dasa_tpu/models/decoder.py:31``, model.py:506-508)."""
    if gen is None or rate == 0.0:
        return x
    visual = dropout(x[..., :-angle_feat_size], rate, gen)
    return torch.cat([visual, x[..., -angle_feat_size:]], dim=-1)


class Critic(nn.Module):
    """2-layer value head (model.py:970-982); ``state2value.0`` and
    ``state2value.3`` as in the reference's Sequential."""

    def __init__(self, in_dim: int, dim: int, dropout_ratio: float = 0.5,
                 compute_dtype=torch.float32):
        super().__init__()
        self.state2value = nn.Sequential(
            Dense(in_dim, dim, compute_dtype=compute_dtype), nn.ReLU(),
            nn.Dropout(dropout_ratio),
            Dense(dim, 1, compute_dtype=compute_dtype))
        self.rate = dropout_ratio

    def forward(self, state, gen=None):
        layers = self.state2value
        x = dropout(layers[1](layers[0](state)), self.rate, gen)
        return layers[3](x)[..., 0]


class BAttnDecoderLSTM(nn.Module):
    """The DASA action decoder step (model.py:422-574): angle-embed the
    previous action, attend over the (shift-smoothed) panorama, LSTMCell,
    attend over the instruction ctx, then score the candidates.
    ``dropout_ratio`` is ``cfg.dropout`` and ``featdropout`` the visual
    feature dropout (``dasa_tpu/models/decoder.py:53-217``)."""

    def __init__(self, embedding_size: int, hidden_size: int,
                 feature_size: int, angle_feat_size: int, ctx_dim: int,
                 use_shift: bool = False, shift_kernel_size: int = 3,
                 pred_back: bool = False, use_dyrelu: bool = False,
                 pred_pm: bool = False, use_kernel: bool = False,
                 compute_dtype=torch.float32, dropout_ratio: float = 0.0,
                 featdropout: float = 0.0):
        super().__init__()
        if pred_back or use_dyrelu or pred_pm:
            raise NotImplementedError(
                "BAttnDecoderLSTM: pred_back, pred_pm and the dyrelu "
                "decoder come with the variants slice (ROADMAP.md)")
        self.compute_dtype = compute_dtype
        self.angle_feat_size = angle_feat_size
        self.dropout_ratio = dropout_ratio
        self.featdropout = featdropout
        kw = dict(compute_dtype=compute_dtype)
        self.embedding = nn.Sequential(
            Dense(angle_feat_size, embedding_size, **kw), nn.Tanh())
        self.lstm = LstmCell(hidden_size, embedding_size + feature_size,
                             compute_dtype)
        if use_shift:
            self.feat_att_layer = ShiftSoftDotAttention(
                hidden_size, feature_size, shift_kernel_size, use_kernel,
                with_tilde=False, **kw)
        else:
            self.feat_att_layer = SoftDotAttention(
                hidden_size, feature_size, with_tilde=False, **kw)
        self.attention_layer = SoftDotAttention(hidden_size, ctx_dim, **kw)
        self.candidate_att_layer = SoftDotAttention(
            hidden_size, feature_size, with_tilde=False, **kw)

    def forward(self, action, feature, cand_feat, prev_h1, c_0, ctx,
                ctx_mask=None, gen=None, already_dropfeat: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor, Dict[str, torch.Tensor]]:
        """action (B, A); feature (B, 36, F); cand_feat (B, K, F);
        prev_h1/c_0 (B, H); ctx (B, L, C); ctx_mask True = masked.
        ``already_dropfeat``: the env-drop noise already dropped the
        visual features, so featdropout is skipped.
        Returns (h_1, c_1, logit, h_tilde, aux)."""
        dt = self.compute_dtype
        rate, feat_rate = self.dropout_ratio, self.featdropout
        action_embeds = dropout(self.embedding(action.to(dt)), rate, gen)
        if not already_dropfeat:
            feature = drop_visual(feature, self.angle_feat_size, feat_rate,
                                  gen)
        attn_feat, _ = self.feat_att_layer(dropout(prev_h1, rate, gen),
                                           feature, output_tilde=False)
        concat_input = torch.cat([action_embeds, attn_feat.to(dt)], dim=-1)
        h_1, c_1 = self.lstm((prev_h1.to(dt), c_0.to(dt)), concat_input)
        h_tilde, alpha = self.attention_layer(dropout(h_1, rate, gen), ctx,
                                              ctx_mask)
        if not already_dropfeat:
            cand_feat = drop_visual(cand_feat, self.angle_feat_size,
                                    feat_rate, gen)
        _, logit = self.candidate_att_layer(dropout(h_tilde, rate, gen),
                                            cand_feat, output_tilde=False,
                                            output_prob=False)
        return h_1, c_1, logit, h_tilde, {"alpha": alpha}
