"""Repaired faults of the port against the JAX package.

F1: ``pretrain_model_name`` grafts the checkpoint's encoder weights at
construction, as the JAX agent does (a refusal stood in before the
pretraining loader was ported).
F2: a parameter left without a gradient in a step is stepped with a zero
gradient, as ``optax.multi_transform`` over ``build_optimizer`` feeds every
leaf (RMSprop's and Adam's moments decay, Adam's count stays the
component's, weight decay moves the leaf).  F3: an LSTM's bias moves as
the JAX cell's single bias b: ``bias_hh`` is zero and untrained.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dasa_tpu.config import Config as JaxConfig
from dasa_tpu.train.optim import build_optimizer
from dasa_tpu_torch.agents import Seq2SeqAgent
from dasa_tpu_torch.config import Config
from dasa_tpu_torch.models.layers import BiLSTM, LstmCell
from dasa_tpu_torch.train.optim import ComponentOptimizer

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
