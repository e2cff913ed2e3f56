"""Repaired faults of the port against the JAX package.

F1: ``pretrain_model_name`` grafts the checkpoint's encoder weights at
construction, as the JAX agent does (a refusal stood in before the
pretraining loader was ported).
F2: a parameter left without a gradient in a step is stepped with a zero
gradient, as ``optax.multi_transform`` over ``build_optimizer`` feeds every
leaf (RMSprop's and Adam's moments decay, Adam's count stays the
component's, weight decay moves the leaf).  F3: an LSTM's bias moves as
the JAX cell's single bias b: ``bias_hh`` is zero and untrained.
F5: under ``load_optim`` a JAX listener or speaker file's optax state
becomes the torch optimizers' state (RMSprop's ``square_avg``, Adam's
moments and step, the schedule's count): after one more step from the same
gradients the port's parameters equal the JAX agent's.  F6: the port's
``Pretrainer.load`` reads the JAX Pretrainer's ``checkpoint-N``.
"""

import dataclasses
import pickle
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import dasa_tpu.pretrain.trainer as jax_trainer
from dasa_tpu.agents import Seq2SeqAgent as JaxAgent
from dasa_tpu.agents.speaker import SpeakerAgent as JaxSpeaker
from dasa_tpu.config import Config as JaxConfig
from dasa_tpu.data.features import FeatureDB as JaxFeatureDB
from dasa_tpu.parallel import make_mesh
from dasa_tpu.train.optim import build_optimizer
from dasa_tpu.utils import Tokenizer as JaxTokenizer
import dasa_tpu_torch.pretrain.trainer as port_trainer
from dasa_tpu_torch.agents import Seq2SeqAgent
from dasa_tpu_torch.agents.speaker import SpeakerAgent
from dasa_tpu_torch.config import Config
from dasa_tpu_torch.data.datasets import (
    expand_instructions,
    load_datasets,
    make_synthetic_task,
)
from dasa_tpu_torch.data.features import FeatureDB
from dasa_tpu_torch.env import R2REnv
from dasa_tpu_torch.models.layers import BiLSTM, LstmCell
from dasa_tpu_torch.pretrain import PretrainBatcher, generate_pretrain_records
from dasa_tpu_torch.testing import write_synthetic_connectivity
from dasa_tpu_torch.train.optim import (
    CLIP_NORM,
    ComponentOptimizer,
    clip_grad_global_norm_,
    fill_missing_grads_,
)
from dasa_tpu_torch.utils import Tokenizer, build_vocab
from dasa_tpu_torch.utils.jax_params import (
    policy_state_dict_from_jax,
    pretrain_state_dict_from_jax,
    speaker_state_dict_from_jax,
)

NAMES = ("encoder", "decoder", "critic", "adain")


def test_pretrain_model_name_raises(tmp_path, capsys):
    """F1 repaired: the agent grafts the checkpoint's DicModel into its
    encoder at construction (before its optimizer is built) instead of
    raising; every other weight keeps its init."""
    cfg = Config(encoder_type="Dic", include_vision=True, d_la_layers=1,
                 d_vl_layers=1, d_enc_hidden_size=16, d_hidden_size=32,
                 critic_dim=32, feature_size=16, angle_feat_size=8)
    feats = SimpleNamespace(values=np.zeros((2, 36, 16), np.float32))
    plain = Seq2SeqAgent(cfg, None, feats, device="cpu")
    bert = {k: v + 1.0 for k, v in
            plain.policy.encoder.bert.state_dict().items()}
    vocab = 40  # a Pretrainer's word vocab: the leading rows of 30522
    bert["embeddings.word_embeddings.weight"] = \
        bert["embeddings.word_embeddings.weight"][:vocab]
    torch.save({"step": 5, "state_dict": {f"bert.{k}": v
                                          for k, v in bert.items()}},
               tmp_path / "checkpoint-5")
    agent = Seq2SeqAgent(cfg.replace(pretrain_model_name=str(tmp_path)),
                         None, feats, device="cpu")
    assert "Initialized encoder from pretrain checkpoint" in \
        capsys.readouterr().out
    got, init = agent.policy.state_dict(), plain.policy.state_dict()
    for k, v in init.items():
        if not k.startswith("encoder.bert."):
            assert torch.equal(got[k], v), k
        elif k.endswith("word_embeddings.weight"):
            assert torch.equal(got[k][:vocab], bert[k[13:]])
            assert torch.equal(got[k][vocab:], v[vocab:])
        else:
            assert torch.equal(got[k], bert[k[13:]]), k


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("optim", ["rms", "adam"])
def test_missing_gradient_steps_like_build_optimizer(optim, weight_decay):
    """Three steps; in step 2 ``critic`` has no gradient in the port and a
    zero gradient in the JAX chain.  The case ROADMAP.md section 3 measured
    (max |torch - jax| 2.8e-2 at weight_decay 0.01 before the repair)."""
    cfg_kw = dict(optim=optim, lr=1e-2, weight_decay=weight_decay)
    rng = np.random.default_rng(1)
    init = {n: rng.standard_normal((3, 4)).astype(np.float32) for n in NAMES}

    class Policy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for n in NAMES:
                self.add_module(n, torch.nn.Module())
                getattr(self, n).w = torch.nn.Parameter(
                    torch.from_numpy(init[n].copy()))

    policy = Policy()
    opt = ComponentOptimizer(Config(**cfg_kw), policy)
    params = {n: {"w": jnp.asarray(init[n])} for n in NAMES}
    tx = build_optimizer(JaxConfig(**cfg_kw), params)
    state = tx.init(params)
    for step in range(3):
        g = {n: (rng.standard_normal((3, 4)) * 3).astype(np.float32)
             for n in NAMES}
        if step == 1:
            g["critic"] = np.zeros((3, 4), np.float32)
        for n in NAMES:
            getattr(policy, n).w.grad = (
                None if step == 1 and n == "critic"
                else torch.from_numpy(g[n]))
        opt.step()
        updates, state = tx.update({n: {"w": jnp.asarray(g[n])}
                                    for n in NAMES}, state, params)
        params = optax.apply_updates(params, updates)
        for n in NAMES:
            np.testing.assert_allclose(
                getattr(policy, n).w.detach().numpy(),
                np.asarray(params[n]["w"]), rtol=1e-5, atol=1e-6,
                err_msg=f"{n} after step {step + 1}")


def test_lstm_second_bias_is_zero_and_untrained():
    """bias_ih alone plays the JAX cell's b: bias_hh starts at zero, gets
    no gradient, and no optimizer holds it."""
    class Policy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.encoder = BiLSTM(4, 3)
            self.decoder = LstmCell(4, 3)

    policy = Policy()
    opt = ComponentOptimizer(Config(optim="adam", lr=1e-2), policy)
    x = torch.randn(2, 5, 3)
    ctx, _ = policy.encoder(x, torch.ones(2, 5, dtype=torch.bool))
    h, c = policy.decoder((torch.zeros(2, 4), torch.zeros(2, 4)), x[:, 0])
    (ctx.sum() + h.sum() + c.sum()).backward()
    opt.step()
    held = {id(p) for ps in opt.params.values() for p in ps}
    for name, p in policy.named_parameters():
        if "bias_hh" in name:
            assert not p.requires_grad and p.grad is None, name
            assert id(p) not in held, name
            assert torch.count_nonzero(p) == 0, name
        else:
            assert p.grad is not None and id(p) in held, name


# F5: the plain EncoderLSTM listener and the speaker at test widths; the
# schedule's warmup makes the third step's rate depend on the restored count
SMALL = dict(rnn_dim=32, wemb=16, aemb=8, critic_dim=32, angle_feat_size=8,
             feature_size=16, lr=1e-2, use_lr_scheduler=True, warm_steps=4,
             decay_start=6, decay_intervals=1, load_optim=True)
WORDS = ["<PAD>", "<UNK>", "<EOS>", "go", "left", "right", "stop", "the"]
FEATS = SimpleNamespace(values=np.zeros((2, 36, 16), np.float32))


def _random_grads(rng, params):
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(1e-3 * rng.standard_normal(np.shape(x)),
                              jnp.float32), params)


def _set_port_grads(named_params, grads):
    for name, p in named_params:
        if p.requires_grad:
            p.grad = torch.from_numpy(grads[name].copy())


def _assert_trained_equal(named_params, ref):
    for name, p in named_params:
        if p.requires_grad:
            np.testing.assert_allclose(p.detach().numpy(), ref[name],
                                       rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("fmt", ["msgpack", "round1_pickle"])
@pytest.mark.parametrize("optim", ["rms", "adam"])
def test_jax_listener_optimizer_state_restored(tmp_path, capsys, optim, fmt):
    """F5, the listener: a JAX agent steps twice and saves; a JAX agent and
    the port each load the file and step once more from the same
    gradients."""
    kw = dict(SMALL, optim=optim)
    rng = np.random.default_rng(0)
    jagent = JaxAgent(JaxConfig(**kw), None, FEATS, vocab_size=len(WORDS),
                      rng_seed=3)
    for _ in range(2):
        jagent._grad_accum = _random_grads(rng, jagent.params["params"])
        jagent.optim_step()
    path = str(tmp_path / "listener")
    if fmt == "msgpack":
        jagent.save(2, path)
    else:  # the round-1 format the JAX load still reads
        with open(path, "wb") as f:
            pickle.dump({"epoch": 2,
                         "params": serialization.to_bytes(jagent.params),
                         "opt_state": serialization.to_bytes(
                             jagent.opt_state)}, f)
    grads = _random_grads(rng, jagent.params["params"])
    jload = JaxAgent(JaxConfig(**kw), None, FEATS, vocab_size=len(WORDS),
                     rng_seed=5)
    assert jload.load(path) == 2
    jload._grad_accum = grads
    jload.optim_step()
    agent = Seq2SeqAgent(Config(**kw), None, FEATS, vocab_size=len(WORDS),
                         rng_seed=7, device="cpu")
    assert agent.load(path) == 2
    assert "not restored" not in capsys.readouterr().out
    assert agent.optimizer.iteration == 2
    _set_port_grads(agent.policy.named_parameters(),
                    policy_state_dict_from_jax(
                        jax.tree_util.tree_map(np.asarray, grads)))
    agent.optim_step()
    _assert_trained_equal(agent.policy.named_parameters(),
                          policy_state_dict_from_jax(jax.tree_util.tree_map(
                              np.asarray, jload.params)))


@pytest.mark.parametrize("optim", ["rms", "adam"])
def test_jax_speaker_optimizer_state_restored(tmp_path, capsys, optim):
    """F5, the speaker: as the listener's, through its pickle of flax
    bytes and its one optax chain (clip, the moments, the rate)."""
    kw = dict(SMALL, optim=optim)
    rng = np.random.default_rng(1)
    jtok = JaxTokenizer(WORDS, encoding_length=8)
    tok = Tokenizer(WORDS, encoding_length=8)

    def jax_step(sp, grads):
        updates, sp.opt_state = sp.tx.update(grads, sp.opt_state,
                                             sp.params["params"])
        sp.params = {"params": optax.apply_updates(sp.params["params"],
                                                   updates)}

    jsp = JaxSpeaker(JaxConfig(**kw), None, FEATS, vocab_size=len(tok),
                     tok=jtok)
    for _ in range(2):
        jax_step(jsp, _random_grads(rng, jsp.params["params"]))
    path = str(tmp_path / "speaker")
    jsp.save(2, path)
    grads = _random_grads(rng, jsp.params["params"])
    jload = JaxSpeaker(JaxConfig(**kw), None, FEATS, vocab_size=len(tok),
                       tok=jtok, rng_seed=4)
    assert jload.load(path) == 2
    jax_step(jload, grads)
    sp = SpeakerAgent(Config(**kw), None, FEATS, vocab_size=len(tok),
                      tok=tok, rng_seed=6, device="cpu")
    assert sp.load(path) == 2
    assert "not restored" not in capsys.readouterr().out
    _set_port_grads(sp.model.named_parameters(), speaker_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, grads)))
    fill_missing_grads_(sp.params)
    clip_grad_global_norm_(sp.params, CLIP_NORM)
    sp.optimizer.step()
    _assert_trained_equal(sp.model.named_parameters(),
                          speaker_state_dict_from_jax(jax.tree_util.tree_map(
                              np.asarray, jload.params)))


PRETRAIN = dict(feature_size=16, angle_feat_size=8, max_input=12,
                batch_size=3, d_la_layers=1, d_vl_layers=1,
                encoder_type="Dic", include_vision=True,
                d_hidden_dropout_prob=0.0, d_attn_dropout_prob=0.0,
                max_action=6, lr=1e-3, warm_steps=1, iters=4)
NARROW_BERT = dict(hidden_size=64, num_attention_heads=4,
                   intermediate_size=128, hidden_dropout_prob=0.0,
                   attention_probs_dropout_prob=0.0)


def test_pretrainer_loads_jax_snapshot(tmp_path, monkeypatch):
    """F6: a JAX Pretrainer saves its ``checkpoint-N``; the port's
    Pretrainer loads it (params and step count) and its ``eval_outputs``
    and ``evaluate`` equal the JAX Pretrainer's after it loaded the same
    file (rtol 1e-5)."""
    for mod in (jax_trainer, port_trainer):
        base = mod.bert_config_from
        monkeypatch.setattr(mod, "bert_config_from", lambda cfg, base=base:
                            dataclasses.replace(base(cfg), **NARROW_BERT))
    scans = ("synthA", "synthB")
    conn, data = str(tmp_path / "conn"), str(tmp_path / "task")
    write_synthetic_connectivity(conn, scans, n_nodes=16, seed=0)
    make_synthetic_task(data, scans[:1], scans[1:], n_train=6, n_val=2,
                        connectivity_dir=conn)
    tok = Tokenizer(build_vocab(load_datasets(["train"], data), min_count=1),
                    encoding_length=12)
    tok.add_word("<MASK>")
    feat = FeatureDB.synthetic(scans, conn, dim=16)
    env = R2REnv(feat, expand_instructions(load_datasets(["train"], data),
                                           tok, max_input=12),
                 batch_size=3, connectivity_dir=conn, max_input=12)
    records = generate_pretrain_records(env, max_steps=6)
    batches = list(PretrainBatcher(records, 3, len(tok),
                                   tok.word_to_index["<MASK>"],
                                   seed=2).epoch())[:3]
    jfeat = JaxFeatureDB.synthetic(scans, conn, dim=16)

    jpt = jax_trainer.Pretrainer(
        JaxConfig(**PRETRAIN), jfeat, len(tok),
        mesh=make_mesh(n_data=1, devices=jax.devices()[:1]))
    jpt.step_count = 2
    path = str(tmp_path / "pretrain" / "checkpoint-2")
    jpt.save(path)
    pt = port_trainer.Pretrainer(Config(**PRETRAIN), feat, len(tok),
                                 device="cpu")
    pt.load(path)
    assert pt.step_count == 2
    want = pretrain_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jpt.params))
    for k, v in pt.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    jpt.step_count = 0
    jpt.load(path)
    assert jpt.step_count == 2

    class Fixed:
        def epoch(self):
            return iter(batches)

    jval = jpt.evaluate(Fixed(), max_batches=3)
    pval = pt.evaluate(Fixed(), max_batches=3)
    for k in ("loss", "mlm_acc", "act_acc"):
        np.testing.assert_allclose(pval[k], jval[k], rtol=1e-5, err_msg=k)
    loss, mlm_logits, action_logits = pt.eval_outputs(batches[0])
    assert torch.isfinite(mlm_logits).all() and torch.isfinite(
        action_logits).all()
    np.testing.assert_allclose(float(loss), pt.eval_batch(batches[0])[0],
                               rtol=1e-5)
