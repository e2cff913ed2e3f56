"""Pretraining models: MLM + next-action (+ progress) heads on DicModel.

Counterpart of ``dasa_tpu/pretrain/model.py`` (reference
r2r_src/r2rpretrain_class.py: ``DicAddActionPreTrain`` 106-147,
``DicPMActionPreTrain`` 150-235).  The MLM head is a transform (Dense,
exact GELU, LayerNorm) and a decoder TIED to the word embeddings plus a
free bias, as the JAX ``embeddings.attend(x) + bias`` (model.py:39): one
parameter serves the embedding lookup and the decoder, so autograd sums
both uses' gradients into it.  The logits are f32 whatever the compute
dtype.  The next-action classifier is one Dense over the pooled CLS.

Parameter names: the DicModel's under ``bert.`` (the listener's
``encoder.bert.`` without the prefix), the MLM head in HF
``BertOnlyMLMHead``'s layout (``mlmhead.predictions.transform.dense``,
``mlmhead.predictions.transform.LayerNorm``, ``mlmhead.predictions.bias``;
the tied decoder has no entry of its own), ``next_action`` and
``pm_head``.  Dropout draws its masks from the caller's generator ``gen``
(None = no dropout).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dasa_tpu_torch.models.bert import BertConfig, DicModel, LayerNorm
from dasa_tpu_torch.models.layers import Dense, cast_param


def _masked_ce(logits: torch.Tensor, labels: torch.Tensor,
               count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross entropy over the positions whose label is >= 0 (the
    ignore index is -1; at least one position counted).  ``count``, when
    given, is the number of such positions to divide by (a data-parallel
    rank passes the whole batch's)."""
    logp = torch.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, labels.long().clamp(min=0)[..., None])[..., 0]
    w = (labels >= 0).float()
    if count is None:
        count = w.sum()
    return (ce * w).sum() / count.clamp(min=1.0)


def _mean(x: torch.Tensor, norm: Optional[dict]) -> torch.Tensor:
    """The mean over the batch's rows (all ranks' under ``norm``)."""
    return x.mean() if norm is None else x.sum() / norm["rows"]


class _Transform(nn.Module):
    def __init__(self, cfg: BertConfig, compute_dtype):
        super().__init__()
        self.dense = Dense(cfg.hidden_size, cfg.hidden_size,
                           compute_dtype=compute_dtype)
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                   compute_dtype)

    def forward(self, x):
        return self.LayerNorm(nn.functional.gelu(self.dense(x)))


class _Predictions(nn.Module):
    def __init__(self, cfg: BertConfig, compute_dtype):
        super().__init__()
        self.transform = _Transform(cfg, compute_dtype)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size))


class BertMLMHead(nn.Module):
    """transform (dense + exact GELU + LN), then the tied word-embedding
    decoder + bias."""

    def __init__(self, cfg: BertConfig, compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.predictions = _Predictions(cfg, compute_dtype)

    def forward(self, hidden, word_embeddings: nn.Parameter):
        dt = self.compute_dtype
        x = self.predictions.transform(hidden)
        # the product in the compute dtype, the f32 bias added to it in f32
        # (the JAX bf16 + f32 promotion)
        return (nn.functional.linear(x, cast_param(word_embeddings, dt))
                .float() + self.predictions.bias)


class NextActionPrediction(Dense):
    """Linear classifier over the 36-view action space
    (r2rpretrain_class.py:649-663)."""

    def __init__(self, hidden_size: int, action_space: int,
                 compute_dtype=torch.float32):
        super().__init__(hidden_size, action_space,
                         compute_dtype=compute_dtype)


class _PreTrainBase(nn.Module):
    def __init__(self, cfg: BertConfig, compute_dtype=torch.float32):
        super().__init__()
        self.config = cfg
        self.bert = DicModel(cfg, compute_dtype)
        self.mlmhead = BertMLMHead(cfg, compute_dtype)
        self.next_action = NextActionPrediction(
            cfg.hidden_size, cfg.action_space, compute_dtype)

    def _encode(self, seq, lang_mask, img_feats, gen):
        if lang_mask is None:
            lang_mask = torch.ones_like(seq)
        text = self.bert.text_forward(seq, lang_mask, gen)
        ctx, pooled, _ = self.bert.cross_forward(text, lang_mask, img_feats,
                                                 gen)
        return ctx, pooled

    def _mlm_and_action(self, seq, labels, actions, img_feats, lang_mask,
                        gen, norm):
        ctx, pooled = self._encode(seq, lang_mask, img_feats, gen)
        mlm_logits = self.mlmhead(
            ctx, self.bert.embeddings.word_embeddings.weight)
        action_logits = self.next_action(pooled).float()
        norm = norm or {}
        loss = _masked_ce(mlm_logits, labels, norm.get("mlm"))
        if actions is not None:
            loss = loss + _masked_ce(action_logits, actions,
                                     norm.get("action"))
        return loss, mlm_logits, action_logits, pooled


class DicAddActionPreTrain(_PreTrainBase):
    """MLM + next-action objective; with ``isnext`` / ``next_img`` also the
    reference's NSP-style objective (pretrain_class.py:120-140 +
    batch_loader.py:419-432): the next-step panorama, true (isnext 1) or a
    same-viewpoint fake (isnext 0), scored by the action classifier, whose
    classes 0 / 1 carry the decision."""

    def forward(self, seq, labels, actions=None, img_feats=None,
                lang_mask=None, isnext=None, next_img=None,
                gen: Optional[torch.Generator] = None,
                norm: Optional[dict] = None):
        """seq (B, L) masked tokens; labels (B, L) original ids at masked
        positions, -1 elsewhere; actions (B,) or None; img_feats
        (B, 36, F).  Returns (loss, mlm_logits, action_logits), and the
        isnext logits last when ``isnext`` is given.  ``norm`` holds the
        whole batch's counts (``mlm``, ``action`` positions, ``rows``)
        when these rows are one rank's share: the loss is then its part of
        the batch's."""
        loss, mlm_logits, action_logits, _ = self._mlm_and_action(
            seq, labels, actions, img_feats, lang_mask, gen, norm)
        if isnext is None:
            return loss, mlm_logits, action_logits
        _, pooled_n = self._encode(seq, lang_mask, next_img, gen)
        n_logits = self.next_action(pooled_n).float()
        n_ce = -torch.log_softmax(n_logits, -1).gather(
            -1, isnext.long()[:, None])[:, 0]
        return loss + _mean(n_ce, norm), mlm_logits, action_logits, n_logits


class DicPMActionPreTrain(_PreTrainBase):
    """Adds a sigmoid progress-regression head on the pooled CLS
    (r2rpretrain_class.py:150-235)."""

    def __init__(self, cfg: BertConfig, compute_dtype=torch.float32):
        super().__init__(cfg, compute_dtype)
        self.pm_head = Dense(cfg.hidden_size, 1, compute_dtype=compute_dtype)

    def forward(self, seq, labels, actions=None, progress=None,
                img_feats=None, lang_mask=None,
                gen: Optional[torch.Generator] = None,
                norm: Optional[dict] = None):
        """Returns (loss, mlm_logits, action_logits, progress (B,));
        ``norm`` as in :class:`DicAddActionPreTrain`."""
        loss, mlm_logits, action_logits, pooled = self._mlm_and_action(
            seq, labels, actions, img_feats, lang_mask, gen, norm)
        pm = torch.sigmoid(self.pm_head(pooled)[:, 0]).float()
        if progress is not None:
            loss = loss + _mean((pm - progress) ** 2, norm)
        return loss, mlm_logits, action_logits, pm
