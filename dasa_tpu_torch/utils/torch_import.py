"""Reference PyTorch checkpoints onto the port's parameter names: the
pretraining half.

Counterpart of the pretraining part of ``dasa_tpu/utils/torch_import.py``
(``load_torch_state_dict`` :381 as ``numpy_state_dict``,
``detect_pretrain_family`` :216,
``translate_vic_model`` :143, ``apply_translated`` :330,
``import_pretrained_bert`` :392).  The port's names ARE the reference's
torch names, so where the JAX package translates (transposes, renames
``weight`` to ``kernel``) the port strips or adds a prefix:

- ``dic`` (DicAdd / DicPM, r2rpretrain_class.py:106-235): the checkpoint's
  ``bert.*`` is the listener's ``encoder.bert.*``;
- ``vic`` (VicModel, 61-104): its full text BERT ``encoder.layer.N``
  becomes ``lalayer.N`` of the ``Vic``-aliased DicModel (12 text layers,
  ``config.py``);
- ``hugadd`` and ``bertadd_encoder`` need the legacy ``BertAddEncoder``
  (``models/legacy.py``), which the port has not yet (ROADMAP.md, item 5
  of section 1): they raise ``NotImplementedError``.

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


def translate_pretrained_bert(state: Dict[str, np.ndarray]
                              ) -> Dict[str, np.ndarray]:
    """A pretrain checkpoint's ``bert.*`` weights under the listener's
    names (``encoder.bert.*``), by family."""
    bert_state = {k[len("bert."):]: v for k, v in state.items()
                  if k.startswith("bert.")}
    family = detect_pretrain_family(bert_state)
    if family in ("hugadd", "bertadd_encoder"):
        raise NotImplementedError(
            f"pretrain checkpoint family {family!r} grafts onto the legacy "
            "BertAddEncoder (models/legacy.py), which comes with the "
            "legacy encoders (ROADMAP.md section 1, item 5)")
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
