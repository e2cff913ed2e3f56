"""Reference PyTorch checkpoints onto the port's parameter names: the
pretraining half.

Counterpart of the pretraining part of ``dasa_tpu/utils/torch_import.py``
(``load_torch_state_dict`` :381 as ``numpy_state_dict``,
``detect_pretrain_family`` :216, ``translate_vic_model`` :143,
``translate_bert_add_model`` :159, ``translate_bert_add_encoder`` :184,
``apply_translated`` :330, ``import_pretrained_bert`` :392).  The port's
names ARE the reference's torch names, so where the JAX package translates
(transposes, renames ``weight`` to ``kernel``) the port strips or adds a
prefix:

- ``dic`` (DicAdd / DicPM, r2rpretrain_class.py:106-235): the checkpoint's
  ``bert.*`` is the listener's ``encoder.bert.*``;
- ``vic`` (VicModel, 61-104): its full text BERT ``encoder.layer.N``
  becomes ``lalayer.N`` of the ``Vic``-aliased DicModel (12 text layers,
  ``config.py``);
- ``hugadd`` (HugAdd, vilmodel BertAddModel, 11-59) grafts onto the
  legacy ``BertAddEncoder`` (``models/legacy.py``): ``embeddings.*`` and
  ``img_embedding.*`` keep their names, the text stack ``encoder.layer.N``
  becomes ``text_layers.N`` and the joint ``addlayer.layer.N``
  ``add_layers.N``; the pooler has no counterpart and is not taken;
- ``bertadd_encoder`` (BertAdd*, the r2rmodel BertAddEncoder, 285-378)
  carries the whole encoder: its HF BertModel under ``bert.`` maps as
  HugAdd's does, and its top ``lstm`` and ``encoder_lstm2decoder_{ht,ct}``
  land on the tail's ``lstm`` and ``encoder2decoder_{ht,ct}``, each LSTM
  direction's two biases summed into ``bias_ih`` (``bias_hh`` zero, the
  port's LSTM convention).

The listener half (``import_listener_checkpoint``) needs no module here:
``Seq2SeqAgent.load`` reads a reference listener file directly.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

ENCODER_BERT = "encoder.bert."
# the embedding tables, whose row counts may differ on a row-sliced graft
_EMBEDDINGS = tuple(f"{ENCODER_BERT}embeddings.{n}.weight" for n in
                    ("word_embeddings", "position_embeddings",
                     "token_type_embeddings"))


def numpy_state_dict(blob) -> Dict[str, np.ndarray]:
    """A loaded .bin / .pth torch checkpoint (a state_dict, or a dict
    holding one under ``state_dict``) as numpy arrays, floats in f32."""
    if isinstance(blob, dict) and "state_dict" in blob:
        blob = blob["state_dict"]
    return {k: v.float().numpy() if isinstance(v, torch.Tensor)
            and v.is_floating_point() else np.asarray(v)
            for k, v in blob.items()}


def detect_pretrain_family(bert_state: Dict[str, np.ndarray]) -> str:
    """Classify a pretrain checkpoint's ``bert.*`` sub-dict by its key
    structure (the four families of r2rpretrain_class.py)."""
    keys = bert_state.keys()
    if any(k.startswith("lalayer.") for k in keys):
        return "dic"                   # DicAdd / DicPM (DicModel)
    if any(k.startswith("bert.encoder.layer.") for k in keys) \
            or "lstm.weight_ih_l0" in keys:
        return "bertadd_encoder"       # BertAdd* (r2rmodel encoder)
    if any(k.startswith("addlayer.layer.") for k in keys):
        return "hugadd"                # HugAdd (vilmodel BertAddModel)
    if any(".visual_attention." in k for k in keys):
        return "vic"                   # Vic (vilmodel VicModel)
    raise ValueError(
        f"unrecognized pretrain checkpoint family; sample keys: "
        f"{sorted(keys)[:8]}")


# the BertAdd families' reference names -> the port's BertAddEncoder's
# (under "encoder."): HugAdd's BertAddModel, and the r2rmodel
# BertAddEncoder's HF BertModel under "bert." with its top LSTM and
# projections
_HUGADD = (("embeddings.", "embeddings."),
           ("img_embedding.", "img_embedding."),
           ("encoder.layer.", "text_layers."),
           ("addlayer.layer.", "add_layers."))
_BERTADD_ENCODER = (("bert.embeddings.", "embeddings."),
                    ("img_embedding.", "img_embedding."),
                    ("bert.encoder.layer.", "text_layers."),
                    ("addlayer.layer.", "add_layers."),
                    ("lstm.", "tail.lstm."),
                    ("encoder_lstm2decoder_ht.", "tail.encoder2decoder_ht."),
                    ("encoder_lstm2decoder_ct.", "tail.encoder2decoder_ct."))


def _renamed(state: Dict[str, np.ndarray], prefixes) -> Dict[str, np.ndarray]:
    """The parameters (``weight*`` / ``bias*``) whose key starts with a
    prefix of ``prefixes``, renamed onto the port's encoder; the JAX
    translators take no others (a pooler, buffers)."""
    out = {}
    for key, val in state.items():
        if not key.rsplit(".", 1)[-1].startswith(("weight", "bias")):
            continue
        for old, new in prefixes:
            if key.startswith(old):
                out["encoder." + new + key[len(old):]] = val
                break
    return out


def _fold_lstm_biases(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Each LSTM direction's bias_hh added into its bias_ih and zeroed:
    the JAX cell's one bias is their sum (``translate_lstm``), and the
    port's LSTM trains bias_ih alone (``models/layers.py:_fold_bias_``)."""
    out = dict(state)
    for key, val in state.items():
        if ".bias_hh_l0" in key:
            ih = key.replace("bias_hh", "bias_ih")
            out[ih] = np.asarray(state[ih]) + np.asarray(val)
            out[key] = np.zeros_like(np.asarray(val))
    return out


def translate_pretrained_bert(state: Dict[str, np.ndarray]
                              ) -> Dict[str, np.ndarray]:
    """A pretrain checkpoint's ``bert.*`` weights under the listener's
    names (``encoder.bert.*``, or the legacy BertAddEncoder's
    ``encoder.*``), by family."""
    bert_state = {k[len("bert."):]: v for k, v in state.items()
                  if k.startswith("bert.")}
    family = detect_pretrain_family(bert_state)
    if family == "hugadd":
        return _renamed(bert_state, _HUGADD)
    if family == "bertadd_encoder":
        return _fold_lstm_biases(_renamed(bert_state, _BERTADD_ENCODER))
    if family == "vic":
        bert_state = {("lalayer." + k[len("encoder.layer."):]
                       if k.startswith("encoder.layer.") else k): v
                      for k, v in bert_state.items()}
    return {ENCODER_BERT + k: v for k, v in bert_state.items()}


def apply_translated(state: Dict[str, torch.Tensor],
                     translated: Dict[str, np.ndarray],
                     row_slice_embeddings: bool = False
                     ) -> Tuple[Dict[str, torch.Tensor], List[str], int]:
    """Write translated weights into a copy of ``state``; returns (the new
    state, the missed names, the count applied).  Shapes must match; with
    ``row_slice_embeddings`` an embedding table may differ in ROW COUNT
    only: a source with more rows keeps its leading rows (the
    Pretrainer's vocab appends <MASK>), a source with fewer rows
    overwrites the target's leading rows (the listener keeps the
    30522-row BERT table while the Pretrainer sizes it to the word
    vocab)."""
    new = dict(state)
    missed: List[str] = []
    for name, value in translated.items():
        cur = new.get(name)
        if cur is None:
            missed.append(name)
            continue
        value = torch.as_tensor(np.asarray(value))
        if tuple(value.shape) != tuple(cur.shape):
            if (row_slice_embeddings and name in _EMBEDDINGS
                    and value.dim() == cur.dim() == 2
                    and value.shape[1] == cur.shape[1]):
                merged = cur.detach().clone()
                rows = min(value.shape[0], cur.shape[0])
                merged[:rows] = value[:rows].to(merged.dtype)
                value = merged
            else:
                missed.append(f"{name} shape {tuple(cur.shape)} vs "
                              f"{tuple(value.shape)}")
                continue
        new[name] = value.to(cur.dtype)
    return new, missed, len(translated) - len(missed)
