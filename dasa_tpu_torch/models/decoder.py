"""The action decoders and the A2C critic.

Counterpart of ``BAttnDecoderLSTM``, ``AttnDecoderLSTM`` and ``Critic`` in
``dasa_tpu/models/decoder.py`` (reference r2r_src/model.py:358-574,
970-982), as single-step modules.  Dropout, the visual featdropout
(``drop_visual``) and ``already_dropfeat`` follow the JAX modules; every
``forward`` takes the dropout generator ``gen`` (None = no dropout).  The
JAX decoder's ``input_noise`` / ``output_noise`` inputs, which no agent
path passes, are left out.
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
    feature dropout (``dasa_tpu/models/decoder.py:53-217``).  Heads:
    ``pred_back`` scores the candidates again for the back-translation
    target from the previous hidden state (``back_input="pre"``) or the
    dropped h_tilde (``"cur"``), ``aux["back_logit"]``; ``pred_pm``
    regresses the progress from the instruction attention
    (:meth:`_pm_score`), ``aux["pm_score"]``; ``use_dyrelu`` passes the
    candidates' visual channels through a DyReLU conditioned on the
    max-pooled panorama (model.py:1713-1817).  ``aux["alpha"]`` is the
    instruction attention."""

    def __init__(self, embedding_size: int, hidden_size: int,
                 feature_size: int, angle_feat_size: int, ctx_dim: int,
                 use_shift: bool = False, shift_kernel_size: int = 3,
                 pred_back: bool = False, back_input: str = "pre",
                 use_dyrelu: bool = False, pred_pm: bool = False,
                 pm_type: str = "att", max_input: int = 80,
                 use_kernel: bool = False, compute_dtype=torch.float32,
                 dropout_ratio: float = 0.0, featdropout: float = 0.0):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.angle_feat_size = angle_feat_size
        self.dropout_ratio = dropout_ratio
        self.featdropout = featdropout
        self.back_input = back_input
        self.pm_type = pm_type
        self.max_input = max_input
        kw = dict(compute_dtype=compute_dtype)
        self.embedding = nn.Sequential(
            Dense(angle_feat_size, embedding_size, **kw), nn.Tanh())
        self.lstm = LstmCell(hidden_size, embedding_size + feature_size,
                             compute_dtype)
        if use_dyrelu:
            from dasa_tpu_torch.models.variants import lang_dyrelu_c

            visual = feature_size - angle_feat_size
            self.dyrelu1 = lang_dyrelu_c(visual, visual, **kw)
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
        if pred_back:
            self.back_candidate_att_layer = SoftDotAttention(
                hidden_size, feature_size, with_tilde=False, **kw)
        if pred_pm:
            with_hid = pm_type in ("att_hid", "plain_att_hid")
            self.pm_critic = Dense(max_input + (hidden_size if with_hid
                                                else 0), 1, **kw)

    def _pm_score(self, alpha, ctx_mask, h_tilde_drop):
        """Progress-monitor score (model.py:533-553,
        ``dasa_tpu/models/decoder.py:118``).  For ``att`` / ``att_hid`` each
        row's valid prefix of the instruction attention is resampled
        linearly (align corners) to the full width and renormalized;
        ``plain_att*`` takes the raw padded attention.  Zero-padded to
        ``max_input`` columns; the ``*_hid`` types append the dropped
        h_tilde.  Returns sigmoid(pm_critic(.)) (B,)."""
        dt = self.compute_dtype
        length = alpha.shape[1]
        alpha = alpha.to(dt)
        if self.pm_type in ("att", "att_hid"):
            attw = alpha
            if ctx_mask is not None:
                ln = (~ctx_mask).sum(-1).clamp(min=2).to(dt)
                pos = (torch.arange(length, dtype=dt, device=alpha.device)
                       [None, :] * (ln[:, None] - 1.0) / max(length - 1, 1))
                lo = torch.floor(pos).long()
                hi = (lo + 1).clamp(max=length - 1)
                frac = (pos - lo).to(dt)
                attw = (alpha.gather(1, lo) * (1.0 - frac)
                        + alpha.gather(1, hi) * frac)
            attw = attw / (attw.sum(-1, keepdim=True) + 1e-10)
        else:
            attw = alpha
        if length < self.max_input:
            attw = nn.functional.pad(attw, (0, self.max_input - length))
        if self.pm_type in ("att_hid", "plain_att_hid"):
            attw = torch.cat([attw, h_tilde_drop.to(dt)], dim=-1)
        return torch.sigmoid(self.pm_critic(attw))[:, 0]

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
        aux: Dict[str, torch.Tensor] = {}
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
        h_tilde_drop = dropout(h_tilde, rate, gen)
        if hasattr(self, "pm_critic"):
            aux["pm_score"] = self._pm_score(alpha, ctx_mask, h_tilde_drop)
        if not already_dropfeat:
            cand_feat = drop_visual(cand_feat, self.angle_feat_size,
                                    feat_rate, gen)
        if hasattr(self, "dyrelu1"):
            a = self.angle_feat_size
            max_feat = feature[..., :-a].to(dt).amax(dim=1)
            cand_view = self.dyrelu1(cand_feat[..., :-a].to(dt), max_feat)
            cand_feat = torch.cat([cand_view, cand_feat[..., -a:].to(dt)],
                                  dim=-1)
        _, logit = self.candidate_att_layer(h_tilde_drop, cand_feat,
                                            output_tilde=False,
                                            output_prob=False)
        if hasattr(self, "back_candidate_att_layer"):
            back_q = prev_h1 if self.back_input == "pre" else h_tilde_drop
            _, aux["back_logit"] = self.back_candidate_att_layer(
                back_q, cand_feat, output_tilde=False, output_prob=False)
        aux["alpha"] = alpha
        return h_1, c_1, logit, h_tilde, aux


class AttnDecoderLSTM(BAttnDecoderLSTM):
    """The baseline decoder step of the plain encoders (model.py:358-420,
    ``dasa_tpu/models/decoder.py:220``): the BAttn skeleton with plain
    panorama attention and no heads; instruction attention at
    ``hidden_size``.  Its aux dict is empty, as the JAX module's."""

    def forward(self, *args, **kwargs):
        h_1, c_1, logit, h_tilde, _aux = super().forward(*args, **kwargs)
        return h_1, c_1, logit, h_tilde, {}
