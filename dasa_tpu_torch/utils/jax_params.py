"""Carry weights from the JAX package's param tree into the port.

``policy_state_dict_from_jax`` takes the flax param tree of the JAX
``DasaPolicy`` (nested dicts of arrays, as ``jax.tree_util.tree_map(
np.asarray, params)`` gives it; no JAX import is needed here) and returns
the port's ``state_dict``, whose names are the reference r2r_src torch
names; ``speaker_state_dict_from_jax`` does the same for the JAX
``SpeakerModel`` and ``pretrain_state_dict_from_jax`` for the JAX
``DicAddActionPreTrain`` / ``DicPMActionPreTrain``.  Leaves may be numpy
arrays or, for the ``bfloat16`` arrays of ``utils/flax_msgpack.py``,
torch tensors.  Conventions, the inverse of
``dasa_tpu/utils/torch_import.py``:

- a flax ``kernel`` (in, out) is a torch Linear ``weight`` (out, in),
  transposed; LayerNorm ``scale`` and Embed ``embedding`` are ``weight``;
- an LSTM cell's ``wi``/``wh`` (in, 4H) become ``weight_ih``/``weight_hh``
  (4H, in); its single bias ``b`` goes to ``bias_ih`` and zeros to
  ``bias_hh``; BiLSTM ``fwd_cell``/``bwd_cell`` are torch's ``_l0`` and
  ``_l0_reverse``, a one-direction LSTM's ``LstmCell_0`` its ``_l0``;
- a raw parameter (``a_csb``, ``kv``, ``v_stop_feat``, ...) keeps its
  name;
- in the policy, ``lalayer_3`` is ``lalayer.3`` (and the legacy
  encoders' ``layer_3``, ``text_3``, ``add_3`` are ``layers.3``,
  ``text_layers.3``, ``add_layers.3``; the MCAN backbone's ``sa_x_3`` is
  ``sa_x.3``); a decoder's ``embedding`` is the reference Sequential's
  ``embedding.0``; the critic's ``Dense_0`` and ``Dense_1`` are
  ``state2value.0`` and ``state2value.3``, an MLP's (``a_fc_content``,
  ..., an MCAN ``ffn``) ``0`` and ``2``, AttFlat's ``Dense_0``-``2``
  ``mlp.0``, ``mlp.2`` and ``linear_merge``; the Mutan fusion's
  ``linear_hv_3`` is ``list_linear_hv.3``.  The
  speaker's names carry over unchanged;
- in the pretraining models, the MLM head's ``transform`` and
  ``LayerNorm`` are HF ``BertOnlyMLMHead``'s
  ``predictions.transform.dense`` / ``.LayerNorm`` and its ``bias``
  ``predictions.bias``; ``next_action/Dense_0`` is ``next_action``.
  :func:`jax_path_of` maps a port name back to its JAX path.

Under ``use_pallas="always"`` the JAX kernel paths store their params
under flat keys (``"a_fc/kernel"``, ``"linear_in/kernel"``,
``dasa_tpu/models/adain.py:71-75``, ``dasa_tpu/models/layers.py:286-293``)
where the plain paths nest them (``{"a_fc": {"kernel": ...}}``); both
layouts are accepted.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

Path = Tuple[str, ...]

_INDEXED = re.compile(r"^(lalayer|addlayer|vlayer|linear_hv|linear_hq|layer|"
                      r"text|add|sa_x|sa_y|sga_x|sga_y)_(\d+)$")
_LISTS = {"linear_hv": "list_linear_hv", "linear_hq": "list_linear_hq",
          "layer": "layers", "text": "text_layers", "add": "add_layers"}
# the auto-named Dense layers of a module, by its name: the MLPs'
# (``a_fc_content``, ..., the MCAN FFNs) are a Sequential's 0 and 2;
# AttFlat's an MLP and its merge
_MLP = re.compile(r"(_fc_(content|style|fuse)|^ffn)$")
_MLP_LAYERS = {"Dense_0": ("0",), "Dense_1": ("2",)}
_ATTFLAT_LAYERS = {"Dense_0": ("mlp", "0"), "Dense_1": ("mlp", "2"),
                   "Dense_2": ("linear_merge",)}
_RENAME = {("decoder", "embedding"): ("decoder", "embedding", "0"),
           ("decoder", "rgb_decoder", "embedding"):
               ("decoder", "rgb_decoder", "embedding", "0"),
           ("decoder", "depth_decoder", "embedding"):
               ("decoder", "depth_decoder", "embedding", "0"),
           ("critic", "Dense_0"): ("critic", "state2value", "0"),
           ("critic", "Dense_1"): ("critic", "state2value", "3")}
# parameters a JAX module declares itself (not a layer's kernel or bias)
_RAW = ("a_csb", "b_csb", "kv", "v_stop_feat")
# applied in order, each to the path the rules before it left
_PRETRAIN_RENAME = {
    ("mlmhead",): ("mlmhead", "predictions"),
    ("mlmhead", "predictions", "transform"):
        ("mlmhead", "predictions", "transform", "dense"),
    ("mlmhead", "predictions", "LayerNorm"):
        ("mlmhead", "predictions", "transform", "LayerNorm"),
    ("next_action", "Dense_0"): ("next_action",)}


def flatten_params(tree: Mapping, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    """Nested param dicts -> {path: array}, splitting the "a/b" flat keys
    of the JAX kernel paths into nested path parts."""
    out: Dict[Path, np.ndarray] = {}
    for key, val in tree.items():
        path = prefix + tuple(str(key).split("/"))
        if isinstance(val, Mapping):
            out.update(flatten_params(val, path))
        else:
            out[path] = val if isinstance(val, torch.Tensor) \
                else np.asarray(val)
    return out


def _module_path(path: Path, renames: Mapping[Path, Path]) -> Path:
    for head, new in renames.items():
        if path[:len(head)] == head:
            path = new + path[len(head):]
    out = []
    for i, p in enumerate(path):
        parent = path[i - 1] if i else ""
        if (m := _INDEXED.match(p)):
            out.append(f"{_LISTS.get(m.group(1), m.group(1))}.{m.group(2)}")
        elif p in _MLP_LAYERS and _MLP.search(parent):
            out.extend(_MLP_LAYERS[p])
        elif p in _ATTFLAT_LAYERS and parent == "attflat_lang":
            out.extend(_ATTFLAT_LAYERS[p])
        else:
            out.append(p)
    return tuple(out)


def policy_state_dict_from_jax(params: Mapping) -> Dict[str, np.ndarray]:
    """The port's ``DasaPolicy`` state_dict (numpy f32 arrays) from the
    JAX ``DasaPolicy`` param tree."""
    return _state_dict_from_jax(params, _RENAME)


def speaker_state_dict_from_jax(params: Mapping) -> Dict[str, np.ndarray]:
    """The port's ``SpeakerModel`` state_dict (numpy f32 arrays) from the
    JAX ``SpeakerModel`` param tree."""
    return _state_dict_from_jax(params, {})


def pretrain_state_dict_from_jax(params: Mapping) -> Dict[str, np.ndarray]:
    """The port's ``DicAddActionPreTrain`` / ``DicPMActionPreTrain``
    state_dict (numpy f32 arrays) from the JAX model's param tree."""
    return _state_dict_from_jax(params, _PRETRAIN_RENAME)


def jax_path_of(model: nn.Module, name: str) -> str:
    """The JAX pretraining model's param path (``"bert/lalayer_0/..."``)
    of the port's parameter ``name``: the renames of
    :func:`pretrain_state_dict_from_jax` undone in reverse order, and a
    ``weight`` named by its module's kind (Embedding ``embedding``,
    LayerNorm ``scale``, Linear ``kernel``)."""
    *mod, leaf = name.split(".")
    owner = model.get_submodule(".".join(mod))
    if leaf == "weight":
        leaf = ("embedding" if isinstance(owner, nn.Embedding) else
                "scale" if isinstance(owner, nn.LayerNorm) else "kernel")
    path = tuple(mod)
    for head, new in reversed(list(_PRETRAIN_RENAME.items())):
        if path[:len(new)] == new:
            path = head + path[len(new):]
    # "lalayer.0" is JAX's "lalayer_0"
    return re.sub(r"/(\d+)(?=/)", r"_\1", "/".join(path + (leaf,)))


def _as_f32(val) -> np.ndarray:
    if isinstance(val, torch.Tensor):
        return val.float().numpy()
    return np.asarray(val, np.float32)


def _state_dict_from_jax(params: Mapping, renames: Mapping[Path, Path]
                         ) -> Dict[str, np.ndarray]:
    tree = params.get("params", params)
    state: Dict[str, np.ndarray] = {}
    for path, val in flatten_params(tree).items():
        *mod, leaf = path
        val = _as_f32(val)
        if mod[-1] in ("fwd_cell", "bwd_cell", "LstmCell_0"):
            sfx = "_l0_reverse" if mod[-1] == "bwd_cell" else "_l0"
            base = ".".join(_module_path(tuple(mod[:-1]), renames))
        elif leaf in ("wi", "wh", "b"):
            sfx = ""
            base = ".".join(_module_path(tuple(mod), renames))
        else:
            sfx = None
            base = ".".join(_module_path(tuple(mod), renames))
        if sfx is not None:
            if leaf == "wi":
                state[f"{base}.weight_ih{sfx}"] = val.T
            elif leaf == "wh":
                state[f"{base}.weight_hh{sfx}"] = val.T
            else:
                state[f"{base}.bias_ih{sfx}"] = val
                state[f"{base}.bias_hh{sfx}"] = np.zeros_like(val)
        elif leaf == "kernel":
            state[f"{base}.weight"] = val.T
        elif leaf in ("scale", "embedding"):
            state[f"{base}.weight"] = val
        elif leaf == "bias":
            state[f"{base}.bias"] = val
        elif leaf in _RAW:
            state[f"{base}.{leaf}"] = val
        else:
            raise KeyError(f"unmapped JAX param {'/'.join(path)}")
    return {k: np.array(v, np.float32, order="C") for k, v in state.items()}


def resnet_state_dict_from_jax(variables: Mapping) -> Dict[str, np.ndarray]:
    """The port's ``ResNet`` state_dict (numpy f32 arrays) from the JAX
    ``ResNet``'s variables ``{"params", "batch_stats"}``: a conv's HWIO
    ``kernel`` becomes the OIHW ``weight``; a BatchNorm's ``scale`` /
    ``bias`` its ``weight`` / ``bias`` and its ``batch_stats`` ``mean`` /
    ``var`` its ``running_mean`` / ``running_var``; flax's ``layer{i}_{j}``
    is ``layer{i}.{j}``, ``downsample_conv`` / ``downsample_bn`` are
    ``downsample.0`` / ``downsample.1``.  Every leaf must be consumed."""
    state: Dict[str, np.ndarray] = {}
    names = {"kernel": "weight", "scale": "weight", "bias": "bias",
             "mean": "running_mean", "var": "running_var"}
    for coll in ("params", "batch_stats"):
        for path, val in flatten_params(variables[coll]).items():
            *mod, leaf = path
            parts = []
            for p in mod:
                if (m := re.match(r"^layer(\d+)_(\d+)$", p)):
                    parts += [f"layer{m.group(1)}", m.group(2)]
                elif p in ("downsample_conv", "downsample_bn"):
                    parts += ["downsample", "0" if p.endswith("conv")
                              else "1"]
                elif re.match(r"^(conv|bn)\d$", p):
                    parts.append(p)
                else:
                    raise KeyError(f"unmapped JAX ResNet leaf "
                                   f"{coll}/{'/'.join(path)}")
            is_conv = parts[-1].startswith("conv") or parts[-2:] == [
                "downsample", "0"]
            allowed = (("kernel",) if is_conv else
                       ("scale", "bias") if coll == "params" else
                       ("mean", "var"))
            if leaf not in allowed or (is_conv and coll != "params"):
                raise KeyError(f"unmapped JAX ResNet leaf "
                               f"{coll}/{'/'.join(path)}")
            val = _as_f32(val)
            if leaf == "kernel":
                val = val.transpose(3, 2, 0, 1)
            state[".".join(parts + [names[leaf]])] = val
    for key in [k for k in state if k.endswith(".running_var")]:
        state[key[:-len("running_var")] + "num_batches_tracked"] = \
            np.zeros((), np.int64)
    return {k: np.array(v, v.dtype if v.dtype == np.int64 else np.float32,
                        order="C") for k, v in state.items()}
