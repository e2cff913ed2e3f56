"""NDH (CVDN dialog navigation) in the PyTorch port against the JAX package.

``data/ndh.py``, ``data/btokenizer.py`` and ``data/semantic.py`` are copies
of the JAX package's modules: the same inputs give the same outputs, held
exactly.  The tokenizer is built from a vocab file the test writes (never
``from_pretrained``), and the semantic views are PNGs and a palette the
test writes.  ``World(ndh=True)`` over ``testing.py``'s synthetic world
and ``write_ndh_task``'s dialogs (the ``all`` history, instructions of
~130 tokens) gives JAX's items, vocabulary and encoded instructions.  Then
the Dic / channel-AdaIN / shift-5 listener of ``tests/test_torch_train.py``
(its BERT narrowed to 64 wide on both sides) at ``max_input`` 128 over
those dialogs: the teacher pass and the fused argmax pass against the JAX
agent, with dropout off and the same env-drop noise, at that file's
tolerances (loss rtol 1e-4; gradients rtol 2e-4, atol 1e-6).
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import dasa_tpu.data.btokenizer as jax_btok
import dasa_tpu.data.ndh as jax_ndh
import dasa_tpu.data.semantic as jax_sem
import dasa_tpu.models.policy as jax_policy
from dasa_tpu.agents import Seq2SeqAgent as JaxAgent
from dasa_tpu.config import Config as JaxConfig
from dasa_tpu.data.features import FeatureDB as JaxFeatureDB
from dasa_tpu.env import R2REnv as JaxEnv
from dasa_tpu.train.trainer import World as JaxWorld
import dasa_tpu_torch.data.btokenizer as port_btok
import dasa_tpu_torch.data.ndh as port_ndh
import dasa_tpu_torch.data.semantic as port_sem
import dasa_tpu_torch.models.policy as port_policy
from dasa_tpu_torch.agents import Seq2SeqAgent
from dasa_tpu_torch.config import Config
from dasa_tpu_torch.data.datasets import expand_instructions
from dasa_tpu_torch.data.features import FeatureDB
from dasa_tpu_torch.env import R2REnv
from dasa_tpu_torch.testing import (
    torch_threads,
    write_ndh_task,
    write_synthetic_connectivity,
)
from dasa_tpu_torch.train.trainer import World
from dasa_tpu_torch.utils.jax_params import policy_state_dict_from_jax

SCANS = ("synthA", "synthB")
DIM = 24
L = 128
CFG = dict(
    rnn_dim=32, wemb=16, aemb=8, critic_dim=32, angle_feat_size=8,
    feature_size=DIM, max_input=L, max_candidates=16, max_action=5,
    batch_size=2, d_enc_hidden_size=16, d_hidden_size=32, d_vl_layers=1,
    d_la_layers=1, encoder_type="Dic", include_vision=True,
    adain_type="channel", ab_type="a", a_type="sigmoid", use_shift=True,
    shift_kernel_size=5, consistent_drop=True, depth_drop=True,
    featdropout=0.3, ml_weight=0.2, dropout=0.0, d_dropout_ratio=0.0,
    d_hidden_dropout_prob=0.0, d_attn_dropout_prob=0.0,
    path_type="trusted_path", history="all")
NARROW = dict(hidden_size=64, num_attention_heads=2, intermediate_size=128)
LOSS_RTOL = 1e-4
GRAD_TOL = dict(rtol=2e-4, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(autouse=True, scope="module")
def narrow_bert():
    """The 64-wide BERT on both sides (flax re-reads it at every apply)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_policy, port_policy):
            base = mod.bert_config_from
            mp.setattr(mod, "bert_config_from",
                       lambda cfg, base=base: dataclasses.replace(
                           base(cfg), **NARROW))
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_ndh_world")
    conn, data = str(root / "connectivity"), str(root / "task")
    write_synthetic_connectivity(conn, SCANS, n_nodes=24, seed=0)
    write_ndh_task(data, SCANS[:1], SCANS[1:], conn, n_train=6, n_val=2,
                   dialog_words=100)
    return root, conn, data


def cvdn_items(world, split="train"):
    with open(os.path.join(world[2], f"NDH_{split}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("history", jax_ndh.HISTORIES)
def test_dialog_to_instruction_matches_jax(world, history):
    for item in cvdn_items(world):
        assert port_ndh.dialog_to_instruction(item, history) == \
            jax_ndh.dialog_to_instruction(item, history)
    with pytest.raises(ValueError):
        port_ndh.dialog_to_instruction(cvdn_items(world)[0], "every")


@pytest.mark.parametrize("path_type", jax_ndh.PATH_TYPES)
def test_select_path_and_convert_match_jax(world, path_type):
    raw = cvdn_items(world)
    picked = [port_ndh.select_path(item, path_type) for item in raw]
    assert picked == [jax_ndh.select_path(item, path_type) for item in raw]
    if path_type == "trusted_path":  # both branches of the mix are taken
        assert {p == item["planner_path"] for p, item in zip(picked, raw)} \
            == {True, False}
    for history in ("all", "target"):
        assert port_ndh.convert_ndh_items(raw, path_type, history) == \
            jax_ndh.convert_ndh_items(raw, path_type, history)
    assert port_ndh.PATH_TYPES == jax_ndh.PATH_TYPES
    assert port_ndh.HISTORIES == jax_ndh.HISTORIES


def test_btokenizer_matches_jax(tmp_path):
    """Both BTokenizers over one vocab file: ids, padding, SEP-overwrite
    truncation, decode, shrink, sizes."""
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "go", "left",
             "right", "the", "stairs", "kitchen", "walk", "##ing", "##s",
             "turn", "to", ".", ",", "door"]
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n")
    port = port_btok.BTokenizer(encoding_length=12, vocab_file=str(path))
    ref = jax_btok.BTokenizer(encoding_length=12, vocab_file=str(path))
    assert port.word_to_index == ref.word_to_index
    assert (port.vocab_size(), len(port)) == (ref.vocab_size(), len(ref))
    for sentence in ("go left, walking the stairs.",
                     "turn right to the kitchen door " * 4,
                     "go zebra left", ""):
        for max_length in (None, 6, 30):
            enc = port.encode_sentence(sentence, max_length)
            np.testing.assert_array_equal(
                enc, ref.encode_sentence(sentence, max_length))
            assert port.decode_sentence(enc) == ref.decode_sentence(enc)
            assert port.shrink(enc) == ref.shrink(enc)
    assert port.split_sentence("Go left.") == ref.split_sentence("Go left.")


def test_semantic_views_match_jax(tmp_path):
    """A palette and 36 semantic PNGs per viewpoint written here (with
    colours outside the palette): the palette, the decoded label ids, the
    stacks and the listings equal the JAX module's."""
    rng = np.random.default_rng(0)
    palette = {label: {"R": int(r), "G": int(g), "B": int(b)}
               for label, (r, g, b) in zip(
                   ("void", "wall", "floor", "chair", "door"),
                   rng.integers(0, 256, (5, 3)))}
    pal_path = tmp_path / "label2color.json"
    pal_path.write_text(json.dumps(palette))
    colors = np.array([[c["R"], c["G"], c["B"]] for c in palette.values()],
                      np.uint8)
    root = tmp_path / "semantic_views"
    for vp in ("vp0", "vp1"):
        os.makedirs(root / "scanA" / vp)
        os.makedirs(root / "scanA" / f"{vp}_rgb")
        for i in range(36):
            img = colors[rng.integers(0, len(colors), (6, 8))]
            img[0, 0] = (1, 2, 3)  # an edge pixel outside the palette
            Image.fromarray(img).save(root / "scanA" / vp / f"{i}.png")
    l2c = port_sem.load_label2color(str(pal_path))
    assert l2c == jax_sem.load_label2color(str(pal_path))
    port_pal = port_sem.SemanticPalette(l2c)
    ref_pal = jax_sem.SemanticPalette(l2c)
    assert (len(port_pal), port_pal.labels) == (len(ref_pal), ref_pal.labels)
    assert port_pal.label_id("chair") == ref_pal.label_id("chair") == 3
    assert port_sem.list_semantic_viewpoints(str(root), "scanA") == \
        jax_sem.list_semantic_viewpoints(str(root), "scanA") == ["vp0", "vp1"]
    assert port_sem.list_semantic_viewpoints(str(root), "none") == []
    for rgb in (False, True):
        assert port_sem.semantic_view_paths(str(root), "scanA", "vp1", rgb) \
            == jax_sem.semantic_view_paths(str(root), "scanA", "vp1", rgb)
    for pal in (None, port_pal):
        ref = jax_sem.load_semantic_views(
            str(root), "scanA", "vp0", ref_pal if pal else None,
            views=[0, 5, 35])
        got = port_sem.load_semantic_views(str(root), "scanA", "vp0", pal,
                                           views=[0, 5, 35])
        np.testing.assert_array_equal(got, ref)
    ids = port_sem.load_semantic_views(str(root), "scanA", "vp1", port_pal)
    assert ids.shape == (36, 6, 8) and ids[0, 0, 0] == -1
    assert (ids[:, 1:, 1:] >= 0).all()


def test_ndh_world_matches_jax(world):
    """World(ndh=True): the converted items of every split, the vocabulary
    built from the converted train dialogs, each env's encoded
    instructions (longer than 80 tokens) and the evaluators' goals."""
    root, conn, data = world
    kw = dict(connectivity_dir=conn, data_dir=data, max_input=L,
              feature_size=DIM, path_type="trusted_path", history="all")
    port = World(Config(**kw, vocab_path=str(root / "port_vocab.txt")),
                 ndh=True)
    ref = JaxWorld(JaxConfig(**kw, vocab_path=str(root / "jax_vocab.txt")),
                   ndh=True)
    assert port.tok.vocab == ref.tok.vocab
    assert {"nav", "ora", "tar"} <= set(port.tok.vocab)
    assert set(port.envs) == set(ref.envs) == {"train", "val_seen",
                                               "val_unseen"}
    longest = 0
    for split, env in port.envs.items():
        assert len(env.data) == len(ref.envs[split].data), split
        for got, want in zip(env.data, ref.envs[split].data):
            assert got.keys() == want.keys()
            for key, val in got.items():
                np.testing.assert_array_equal(val, want[key], err_msg=key)
            longest = max(longest, int((got["instr_encoding"] != 0).sum()))
        assert port._load(split) == ref._load(split)
    assert longest > 80


@pytest.fixture(scope="module")
def pair(world):
    """The JAX and port listeners over the NDH train dialogs, the same
    weights."""
    _root, conn, data = world
    wcfg = Config(**CFG, connectivity_dir=conn, data_dir=data,
                  vocab_path=str(world[0] / "pair_vocab.txt"))
    tok = World(wcfg, ndh=True).tok
    raw = port_ndh.convert_ndh_items(cvdn_items(world), "trusted_path",
                                     "all")
    items = expand_instructions(raw, tok, max_input=L)
    jfeat = JaxFeatureDB.synthetic(SCANS, conn, dim=DIM)
    jdepth = JaxFeatureDB.synthetic(SCANS, conn, dim=DIM, salt=7)
    jenv = JaxEnv(jfeat, items, batch_size=2, connectivity_dir=conn,
                  max_candidates=16, max_input=L, depth_db=jdepth,
                  backend="python")
    jagent = JaxAgent(JaxConfig(**CFG, connectivity_dir=conn), jenv,
                      jfeat, depth_db=jdepth, vocab_size=len(tok),
                      rng_seed=11)
    feat = FeatureDB.synthetic(SCANS, conn, dim=DIM)
    depth = FeatureDB.synthetic(SCANS, conn, dim=DIM, salt=7)
    env = R2REnv(feat, items, batch_size=2, connectivity_dir=conn,
                 max_candidates=16, max_input=L, depth_db=depth)
    agent = Seq2SeqAgent(Config(**CFG, connectivity_dir=conn,
                                data_dir=data), env, feat,
                         depth_db=depth, vocab_size=len(tok),
                         device="cpu")
    agent.load_jax_params(jax.tree_util.tree_map(np.asarray, jagent.params))
    return jagent, agent


def noise_vector(seed=3):
    keep = np.random.default_rng(seed).random(DIM) > 0.3
    return (keep / 0.7).astype(np.float32)


@pytest.mark.parametrize("feedback", ["teacher", "argmax"])
def test_ndh_pass_matches_jax(pair, feedback):
    """The teacher pass (train_ml 1) and the fused argmax pass (train_ml
    0.2; argmax trains no A2C) over 128-token dialogs: loss, env steps and
    every gradient against the JAX agent's device pass.  Both agents
    advance through the same minibatches in step."""
    jagent, agent = pair
    noise = noise_vector()
    train_ml = 1.0 if feedback == "teacher" else 0.2
    args = list(jagent._device_rollout_args(feedback, train_ml, False))
    args[8] = jax.numpy.asarray(noise)
    grads, logs = jagent._device_grad_fn(feedback, True)(
        jagent.params, jagent.tables, jagent._dev_env.arrays(), *args)
    agent.zero_grad()
    agent.device_rollout(train_ml=train_ml, train_rl=False,
                         feedback=feedback, env_noise=torch.from_numpy(noise))
    # the minibatch's dialogs run past the R2R budget of 80 tokens
    assert int(np.asarray(args[6]).max()) > 80
    np.testing.assert_allclose(float(agent.losses[-1]), float(logs["loss"]),
                               rtol=LOSS_RTOL)
    assert int(agent._env_steps_log[-1]) == int(logs["env_steps"])
    ref = policy_state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            grads))
    got = {name: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
           for name, p in agent.policy.named_parameters()}
    assert got.keys() == ref.keys()
    for name, grad in got.items():
        np.testing.assert_allclose(grad, ref[name], err_msg=name, **GRAD_TOL)
