"""Initialize the listener encoder from a pretraining checkpoint.

Counterpart of ``dasa_tpu/utils/pretrain_load.py``: the reference's
headline run builds its encoder FROM the PREVALENT checkpoint at agent
init (``encoder.bert = premodel.bert``, r2r_src/agent_dg.py:135-188; its
README passes ``--pretrain_model_name``).  Three on-disk formats resolve:

1. an HF ``save_pretrained`` directory (its ``pytorch_model.bin``) or a
   bare ``.bin``, of any of the four families of r2rpretrain_class.py
   (``utils/torch_import.py``): DicAdd / DicPM and Vic onto the DicModel,
   HugAdd and BertAdd onto the legacy BertAddEncoder (a Dic listener
   grafts nothing from those two and refuses them, as JAX's does).  Its
   tables graft only at equal shapes: a word table of another row count
   is a reported miss.
2. the port's own Pretrainer snapshot ``checkpoint-N``
   (``pretrain/trainer.py``: a torch file of ``{"step", "state_dict"}``).
3. the JAX package's Pretrainer snapshot ``checkpoint-N`` (a pickle of
   ``{"step", "params": flax msgpack bytes}``), read by
   ``utils/flax_msgpack.py`` without flax; its ``bert`` subtree is
   carried across by ``utils/jax_params.py``.

The two Pretrainer snapshots hold a word table of ``len(tok)`` rows and
graft row-sliced (``torch_import.apply_translated``), as the JAX package
does on that path alone.  A directory resolves to an HF
``pytorch_model.bin`` or else its highest ``checkpoint-N``; a file's
format is read from its first bytes, and a file of no known format is an
error.  Unmatched or mis-shaped weights are reported and skipped, but
grafting NOTHING raises ``ValueError``: a silently inert
``--pretrain_model_name`` is worse than a crash.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Tuple

import torch

from dasa_tpu_torch.utils import flax_msgpack
from dasa_tpu_torch.utils.jax_params import policy_state_dict_from_jax
from dasa_tpu_torch.utils.torch_import import (
    ENCODER_BERT,
    apply_translated,
    numpy_state_dict,
    translate_pretrained_bert,
)


def resolve_pretrain_checkpoint(path: str) -> Tuple[str, str]:
    """Map a ``--pretrain_model_name`` value to (kind, file): ``"torch"``
    (an HF ``.bin`` or the port's snapshot) or ``"jax"`` (the JAX
    Pretrainer's snapshot)."""
    if os.path.isdir(path):
        hf_bin = os.path.join(path, "pytorch_model.bin")
        if os.path.exists(hf_bin):
            return "torch", hf_bin
        cands = []
        for name in os.listdir(path):
            m = re.fullmatch(r"checkpoint-(\d+)", name)
            if m and os.path.isfile(os.path.join(path, name)):
                cands.append((int(m.group(1)), name))
        if not cands:
            raise FileNotFoundError(
                f"pretrain_model_name dir {path!r} has neither a "
                "pytorch_model.bin nor checkpoint-N files")
        path = os.path.join(path, max(cands)[1])
    elif not os.path.exists(path):
        raise FileNotFoundError(f"pretrain_model_name {path!r} not found")
    fmt = flax_msgpack.file_format(path)
    if fmt == "pickle":
        return "jax", path
    if fmt == "torch":
        return "torch", path
    raise ValueError(f"pretrain checkpoint {path!r} is a {fmt} file: "
                     "neither torch weights nor a Pretrainer snapshot")


def _jax_snapshot_bert(file: str) -> Dict[str, object]:
    """The JAX Pretrainer snapshot's DicModel weights under the listener's
    names."""
    blob = flax_msgpack.load_plain_pickle(file)
    tree = flax_msgpack.msgpack_restore(blob["params"])
    params = tree.get("params", tree)
    if "bert" not in params:
        raise KeyError(f"{file!r} is not a Pretrainer checkpoint: no 'bert' "
                       f"subtree (top-level keys: {sorted(params)[:8]})")
    return policy_state_dict_from_jax({"encoder": {"bert": params["bert"]}})


def load_pretrained_encoder(policy_state: Dict[str, torch.Tensor],
                            path: str
                            ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Graft a pretraining checkpoint's encoder weights into a copy of the
    policy's ``state_dict`` (the reference's ``encoder.bert =
    premodel.bert``).  Returns (the new state, the missed names); raises
    ``ValueError`` if nothing grafts."""
    kind, file = resolve_pretrain_checkpoint(path)
    snapshot = True
    if kind == "jax":
        translated = _jax_snapshot_bert(file)
    else:
        blob = torch.load(file, map_location="cpu", weights_only=True)
        snapshot = isinstance(blob, dict) and "step" in blob
        if snapshot:  # the port's Pretrainer snapshot
            translated = {ENCODER_BERT + k[len("bert."):]: v.float().numpy()
                          for k, v in blob["state_dict"].items()
                          if k.startswith("bert.")}
        else:
            translated = translate_pretrained_bert(numpy_state_dict(blob))
    new, missed, n_applied = apply_translated(
        policy_state, translated, row_slice_embeddings=snapshot)
    if n_applied == 0:
        raise ValueError(
            f"pretrain checkpoint {file!r} grafted ZERO leaves onto the "
            f"encoder — encoder_type mismatch? first misses: {missed[:5]}")
    return new, missed
