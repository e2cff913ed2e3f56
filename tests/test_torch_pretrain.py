"""The port's pretraining against the JAX package's ``dasa_tpu.pretrain``.

On a synthetic 2-scan world (the JAX env on its Python engine): the step
records and the masked batches of a seed must be equal; the pretraining
models (DicAdd with and without isnext, DicPM), with the JAX weights
carried across by ``pretrain_state_dict_from_jax``, must give the JAX
losses and logits at rtol 1e-5 / atol 1e-5 in f32 with dropout 0; the
weight-decay masks must be equal leaf for leaf; after 3 ``train_step``s
with ``warm_steps=2`` (the first step's rate is 0) the parameters must
agree at rtol 1e-4 / atol 1e-6 (the attention key biases, whose gradient
is rounding noise on both sides, within the rates' bound instead, and
that gradient below 1e-6 after a backward pass), and
``evaluate()`` at rtol 1e-5.  Then
``--train pretrain`` through the port's CLI writes ``checkpoint-N``.
The Pretrainers run at a narrow BERT (hidden 64) on both sides.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import dasa_tpu.pretrain.trainer as jax_trainer
from dasa_tpu.config import Config as JaxConfig
from dasa_tpu.data.features import FeatureDB as JaxFeatureDB
from dasa_tpu.env import R2REnv as JaxEnv
from dasa_tpu.models.bert import BertConfig as JaxBertConfig
from dasa_tpu.parallel import make_mesh
from dasa_tpu.pretrain import PretrainBatcher as JaxBatcher
from dasa_tpu.pretrain import generate_pretrain_records as jax_records
from dasa_tpu.pretrain.model import DicAddActionPreTrain as JaxDicAdd
from dasa_tpu.pretrain.model import DicPMActionPreTrain as JaxDicPM
import dasa_tpu_torch.pretrain.trainer as port_trainer
from dasa_tpu_torch.config import Config
from dasa_tpu_torch.data.datasets import (
    expand_instructions,
    load_datasets,
    make_synthetic_task,
)
from dasa_tpu_torch.data.features import FeatureDB
from dasa_tpu_torch.env import R2REnv
from dasa_tpu_torch.models.bert import BertConfig
from dasa_tpu_torch.pretrain import (
    DicAddActionPreTrain,
    DicPMActionPreTrain,
    PretrainBatcher,
    generate_pretrain_records,
)
from dasa_tpu_torch.pretrain.trainer import Pretrainer
from dasa_tpu_torch.testing import torch_threads, write_synthetic_connectivity
from dasa_tpu_torch.utils import Tokenizer, all_point_angle_feature, build_vocab
from dasa_tpu_torch.utils.jax_params import (
    flatten_params,
    jax_path_of,
    pretrain_state_dict_from_jax,
)

SCANS = ("synthA", "synthB")
DIM = 24
L = 20
B = 4
NARROW = dict(hidden_size=64, num_attention_heads=4, intermediate_size=128,
              hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
CFG = dict(feature_size=DIM, angle_feat_size=8, max_input=L, batch_size=B,
           d_la_layers=1, d_vl_layers=1, encoder_type="Dic",
           include_vision=True, d_hidden_dropout_prob=0.0,
           d_attn_dropout_prob=0.0, max_action=8)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_pretrain_world")
    conn, data = str(root / "connectivity"), str(root / "task")
    write_synthetic_connectivity(conn, SCANS, n_nodes=24, seed=0)
    make_synthetic_task(data, SCANS[:1], SCANS[1:], n_train=8, n_val=3,
                        connectivity_dir=conn)
    vocab = build_vocab(load_datasets(["train"], data), min_count=1)
    tok = Tokenizer(vocab, encoding_length=L)
    tok.add_word("<MASK>")
    items = expand_instructions(load_datasets(["train"], data), tok,
                                max_input=L)
    jfeat = JaxFeatureDB.synthetic(SCANS, conn, dim=DIM)
    jenv = JaxEnv(jfeat, items, batch_size=B, connectivity_dir=conn,
                  max_input=L, backend="python")
    feat = FeatureDB.synthetic(SCANS, conn, dim=DIM)
    # the python engine on both sides: the records hold its float geometry
    env = R2REnv(feat, items, batch_size=B, connectivity_dir=conn,
                 max_input=L, backend="python")
    records = generate_pretrain_records(env, max_steps=8)
    return dict(conn=conn, data=data, tok=tok, jenv=jenv, env=env,
                jfeat=jfeat, feat=feat, records=records)


def test_records_and_masked_batches_match_jax(world):
    jrec = jax_records(world["jenv"], max_steps=8)
    rec = world["records"]
    assert len(rec) == len(jrec) > 3 * B
    for a, b in zip(rec, jrec):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    tok = world["tok"]
    args = (B, len(tok), tok.word_to_index["<MASK>"])
    for seed in (0, 3):
        batches = list(PretrainBatcher(rec, *args, seed=seed).epoch())
        jbatches = list(JaxBatcher(jrec, *args, seed=seed).epoch())
        assert len(batches) == len(jbatches) == len(rec) // B
        for a, b in zip(batches, jbatches):
            assert a.keys() == b.keys() and "isnext" in a
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        # masked positions exist and only they carry labels
        labels = np.concatenate([b["labels"] for b in batches])
        assert (labels >= 0).any() and (labels[:, 0] == -1).all()


def model_inputs(world, batch):
    feat = world["feat"].values
    ang = np.asarray(all_point_angle_feature(8))

    def pano(rows, views):
        return np.concatenate([feat[rows], ang[views]], -1).astype(np.float32)

    return dict(seq=batch["seq"], labels=batch["labels"],
                actions=batch["action"],
                img=pano(batch["feat_row"], batch["view_index"]),
                lang_mask=batch["lang_mask"], isnext=batch["isnext"],
                next_img=pano(batch["next_feat_row"], batch["next_view"]),
                progress=batch["progress"])


@pytest.mark.parametrize("kind", ["dicadd", "dicadd_isnext", "dicpm"])
def test_models_match_jax(world, kind):
    """Losses and every logit of the JAX model and the port's, same
    weights, f32, dropout 0."""
    tok = world["tok"]
    kw = dict(NARROW, vocab_size=len(tok), img_feature_dim=DIM + 8,
              la_layers=1, vl_layers=1, update_lang_bert=True,
              update_add_layer=True)
    batch = next(PretrainBatcher(world["records"], B, len(tok),
                                 tok.word_to_index["<MASK>"]).epoch())
    x = model_inputs(world, batch)
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    jcls, cls = ((JaxDicPM, DicPMActionPreTrain) if kind == "dicpm"
                 else (JaxDicAdd, DicAddActionPreTrain))
    jmodel = jcls(JaxBertConfig(**kw))
    if kind == "dicpm":
        jargs = (x["seq"], x["labels"], x["actions"], x["progress"],
                 x["img"], x["lang_mask"])
        args = (t["seq"], t["labels"], t["actions"], t["progress"],
                t["img"], t["lang_mask"])
        jkw = kw_t = {}
    else:
        jargs = (x["seq"], x["labels"], x["actions"], x["img"],
                 x["lang_mask"])
        args = (t["seq"], t["labels"], t["actions"], t["img"],
                t["lang_mask"])
        jkw = kw_t = {}
        if kind == "dicadd_isnext":
            jkw = dict(isnext=x["isnext"], next_img=x["next_img"])
            kw_t = dict(isnext=t["isnext"], next_img=t["next_img"])
    params = jmodel.init(jax.random.PRNGKey(1), *jargs, **jkw)
    jout = jmodel.apply(params, *jargs, **jkw)
    model = cls(BertConfig(**kw))
    state = pretrain_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params))
    assert state.keys() == model.state_dict().keys()
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    with torch.no_grad():
        out = model(*args, **kw_t)
    assert len(out) == len(jout)
    for got, want in zip(out, jout):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the decoder is the word table: one tensor, two uses
    assert not any("decoder" in k for k in state)


def narrow_bert(bert_config_from):
    def fn(cfg):
        return dataclasses.replace(bert_config_from(cfg), **NARROW)
    return fn


@pytest.fixture()
def pretrainers(world, monkeypatch):
    """The JAX and port Pretrainers at the narrow width, same weights."""
    monkeypatch.setattr(jax_trainer, "bert_config_from",
                        narrow_bert(jax_trainer.bert_config_from))
    monkeypatch.setattr(port_trainer, "bert_config_from",
                        narrow_bert(port_trainer.bert_config_from))
    kw = dict(CFG, lr=1e-3, warm_steps=2, iters=10, weight_decay=0.0)
    tok = world["tok"]
    jpt = jax_trainer.Pretrainer(
        JaxConfig(**kw), world["jfeat"], len(tok),
        mesh=make_mesh(n_data=1, devices=jax.devices()[:1]))
    pt = Pretrainer(Config(**kw), world["feat"], len(tok), device="cpu")
    state = pretrain_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jpt.params))
    pt.model.load_state_dict({k: torch.as_tensor(v)
                              for k, v in state.items()})
    return jpt, pt


def test_decay_masks_match_jax(pretrainers):
    jpt, pt = pretrainers
    jmask = {"/".join(p): bool(v) for p, v in
             flatten_params(_jax_mask(jpt.params["params"])).items()}
    got = {jax_path_of(pt.model, n): d
           for n, d in pt.optimizer.decay.items()}
    assert got == jmask
    # JAX decays the vision encoder's visn_layer_norm scale
    assert got["bert/vision_encoder/visn_layer_norm/scale"] is True
    assert got["bert/embeddings/LayerNorm/scale"] is False


def _jax_mask(params):
    """The mask ``build_adamw`` hands ``optax.add_decayed_weights``."""
    captured = {}
    real = jax_trainer.optax.add_decayed_weights

    def spy(rate, mask=None):
        captured["mask"] = mask
        return real(rate, mask=mask)

    jax_trainer.optax.add_decayed_weights = spy
    try:
        jax_trainer.build_adamw(JaxConfig(**CFG), params, 10)
    finally:
        jax_trainer.optax.add_decayed_weights = real
    return jax.tree_util.tree_map(np.asarray, captured["mask"](params))


def test_train_steps_and_evaluate_match_jax(world, pretrainers):
    """Three steps with warm_steps=2 (rates 0, lr/2, lr), then the
    parameters and ``evaluate()``."""
    jpt, pt = pretrainers
    tok = world["tok"]
    args = (B, len(tok), tok.word_to_index["<MASK>"])
    batches = list(PretrainBatcher(world["records"], *args,
                                   seed=2).epoch())[:3]
    before = {k: v.clone() for k, v in pt.model.state_dict().items()}
    rng = jax.random.PRNGKey(0)
    for i, batch in enumerate(batches):
        jloss, jaux = jpt.train_step(batch, jax.random.fold_in(rng, i))
        loss, aux = pt.train_step(batch)
        np.testing.assert_allclose(loss, jloss, rtol=1e-4, atol=1e-5)
        assert aux.keys() == jaux.keys()
        if i == 0:  # the first step's rate is 0
            for k, v in pt.model.state_dict().items():
                torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    ref = pretrain_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jpt.params))
    got = pt.model.state_dict()
    moved = 0
    for k, v in ref.items():
        if k.endswith(".key.bias"):
            # an attention key bias has an analytically zero gradient (the
            # softmax over keys is shift-invariant): Adam scales each
            # framework's rounding noise into steps of up to the rate, so
            # both are held to the rates' sum, not to each other
            bound = 2 * sum(pt.optimizer.schedule(i) for i in range(3))
            for side in (got[k].numpy(), v):
                assert np.abs(side - before[k].numpy()).max() <= bound, k
            continue
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
        moved += not torch.equal(got[k], before[k])
    assert moved > len(ref) // 2
    # the exemption rests on that zero gradient: one backward pass leaves
    # the key biases rounding noise, where the value biases get a real one
    # (the last vision self-attention, whose output no loss reads, none)
    pt.optimizer.zero_grad()
    pt._forward(pt._tensors(batches[0]), None, False)[0].backward()
    grads = {n: p.grad.abs().max().item()
             for n, p in pt.model.named_parameters()
             if n.endswith((".key.bias", ".value.bias"))
             and p.grad is not None}
    keys = [n for n in grads if n.endswith(".key.bias")]
    assert keys and len(keys) * 2 == len(grads)
    for n, g in grads.items():
        assert g < 1e-6 if n.endswith(".key.bias") else g > 1e-4, (n, g)
    val = list(PretrainBatcher(world["records"], *args, seed=5).epoch())
    jval = jpt.evaluate(_ListBatcher(val), max_batches=2)
    pval = pt.evaluate(_ListBatcher(val), max_batches=2)
    for k in ("loss", "mlm_acc", "act_acc"):
        np.testing.assert_allclose(pval[k], jval[k], **TOL, err_msg=k)


class _ListBatcher:
    """Fixed batches for both evaluate()s (a batcher reshuffles)."""

    def __init__(self, batches):
        self.batches = batches

    def epoch(self):
        return iter(self.batches)


def test_isnext_step_matches_jax(world, pretrainers, monkeypatch):
    """One step with the isnext objective on: loss and accuracies."""
    jpt, pt = pretrainers
    monkeypatch.setattr(pt, "cfg", pt.cfg.replace(pretrain_isnext=True))
    jpt.cfg = jpt.cfg.replace(pretrain_isnext=True)
    jpt._train_step = jpt._build_train_step()
    tok = world["tok"]
    batch = next(PretrainBatcher(world["records"], B, len(tok),
                                 tok.word_to_index["<MASK>"]).epoch())
    jloss, jaux = jpt.train_step(batch, jax.random.PRNGKey(0))
    loss, aux = pt.train_step(batch)
    np.testing.assert_allclose(loss, jloss, rtol=1e-4, atol=1e-5)
    assert set(aux) == set(jaux) == {"mlm_acc", "act_acc", "isnext_acc"}
    for k in aux:
        np.testing.assert_allclose(aux[k], jaux[k], **TOL)


def test_cli_pretrain_writes_checkpoints(world, tmp_path, capsys):
    """python -m dasa_tpu_torch.cli --train pretrain: records, steps,
    validation, checkpoint-N (a torch file of step + state_dict), and the
    world's tokenizer gains <MASK>."""
    from dasa_tpu_torch.cli import main

    args = ["--device", "cpu", "--connectivity_dir", world["conn"],
            "--data_dir", world["data"], "--snap_dir", str(tmp_path / "snap"),
            "--log_dir", str(tmp_path / "log"), "--name", "pre",
            "--vocab_path", str(tmp_path / "vocab.txt"),
            "--train", "pretrain", "--iters", "3", "--log_every", "1",
            "--val_every", "3", "--save_every", "2", "--batchSize", "4"]
    for key, val in CFG.items():
        if key != "batch_size":
            args += [f"--{key}", str(val)]
    main(args)
    out = capsys.readouterr().out
    assert "pretrain records:" in out and "pretrain iter 3:" in out
    assert "pretrain VAL iter 3:" in out
    snap = tmp_path / "snap" / "pre" / "pretrain"
    assert sorted(os.listdir(snap)) == ["checkpoint-2", "checkpoint-3"]
    blob = torch.load(snap / "checkpoint-3", weights_only=True)
    assert blob["step"] == 3
    assert "bert.embeddings.word_embeddings.weight" in blob["state_dict"]
    assert "mlmhead.predictions.bias" in blob["state_dict"]
