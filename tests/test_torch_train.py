"""The PyTorch port's listener training against the JAX package.

On a synthetic 2-scan world, the JAX ``Seq2SeqAgent`` and the port's agent
carry the same weights (``policy_state_dict_from_jax``) for the Dic /
channel-AdaIN / shift-5 listener of tests/test_device_env.py, in f32 on
the CPU.  Every dropout rate is 0 and both get the same env-drop noise
(the two frameworks' random streams differ), so the teacher pass, the A2C
replay loss and the fused argmax pass must give the same loss and
gradients, at tests/test_device_env.py:142-145's tolerances (loss rtol
1e-4; gradients rtol 2e-4, atol 1e-6).  Then, within the port: the fused
sampled pass against the replay of its own episode, the optimizer step
against ``build_optimizer``, the training loop, checkpoints and
determinism.
"""

import os

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dasa_tpu.models.policy as jax_policy
from dasa_tpu.agents import Seq2SeqAgent as JaxAgent
from dasa_tpu.config import Config as JaxConfig
from dasa_tpu.data.features import FeatureDB as JaxFeatureDB
from dasa_tpu.env import R2REnv as JaxEnv
from dasa_tpu.train.optim import build_optimizer
import dasa_tpu_torch.models.policy as port_policy
from dasa_tpu_torch.agents import Seq2SeqAgent
from dasa_tpu_torch.config import Config
from dasa_tpu_torch.data.datasets import (
    expand_instructions,
    load_datasets,
    make_synthetic_task,
)
from dasa_tpu_torch.data.features import FeatureDB
from dasa_tpu_torch.env import R2REnv
from dasa_tpu_torch.testing import torch_threads, write_synthetic_connectivity
from dasa_tpu_torch.train.optim import CLIP_NORM, ComponentOptimizer
from dasa_tpu_torch.utils import Tokenizer, build_vocab
from dasa_tpu_torch.utils.jax_params import policy_state_dict_from_jax

SCANS = ("synthA", "synthB")
DIM = 24
L = 24
# tests/test_device_env.py:34-43 widths, the Dic/channel/shift-5 policy
CFG = dict(
    rnn_dim=32, wemb=16, aemb=8, critic_dim=32, angle_feat_size=8,
    feature_size=DIM, max_input=L, max_candidates=16, max_action=5,
    batch_size=2, d_enc_hidden_size=16, d_hidden_size=32, d_vl_layers=1,
    d_la_layers=1, encoder_type="Dic", include_vision=True,
    adain_type="channel", ab_type="a", a_type="sigmoid", use_shift=True,
    shift_kernel_size=5, consistent_drop=True, depth_drop=True,
    featdropout=0.3, ml_weight=0.2)
NO_DROPOUT = dict(dropout=0.0, d_dropout_ratio=0.0, d_hidden_dropout_prob=0.0,
                  d_attn_dropout_prob=0.0)
LOSS_RTOL = 1e-4
GRAD_TOL = dict(rtol=2e-4, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(autouse=True, scope="module")
def narrow_bert():
    """The frozen BERT 64 wide on both sides (its width is only a shape
    here; flax re-reads it at every apply)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_policy, port_policy):
            base = mod.bert_config_from
            mp.setattr(mod, "bert_config_from",
                       lambda cfg, base=base: dataclasses.replace(
                           base(cfg), hidden_size=64, num_attention_heads=2,
                           intermediate_size=128))
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train_world")
    conn, data = str(root / "connectivity"), str(root / "task")
    write_synthetic_connectivity(conn, SCANS, n_nodes=24, seed=0)
    make_synthetic_task(data, SCANS[:1], SCANS[1:], n_train=6, n_val=2,
                        connectivity_dir=conn)
    vocab = build_vocab(load_datasets(["train"], data), min_count=1)
    return conn, data, Tokenizer(vocab, encoding_length=L)


def port_agent(world, seed=0, **kw):
    conn, data, tok = world
    items = expand_instructions(load_datasets(["train"], data), tok,
                                max_input=L)
    cfg = Config(**{**CFG, **kw}, connectivity_dir=conn, data_dir=data)
    feat = FeatureDB.synthetic(SCANS, conn, dim=DIM)
    depth = FeatureDB.synthetic(SCANS, conn, dim=DIM, salt=7)
    env = R2REnv(feat, items, batch_size=2, connectivity_dir=conn,
                 max_candidates=16, max_input=L, depth_db=depth)
    return Seq2SeqAgent(cfg, env, feat, depth_db=depth, rng_seed=seed,
                        device="cpu")


def make_pair(world, use_pallas):
    """JAX and port agents over the train split, same weights, dropout 0."""
    conn, data, tok = world
    items = expand_instructions(load_datasets(["train"], data), tok,
                                max_input=L)
    kw = {**CFG, **NO_DROPOUT, "use_pallas": use_pallas}
    jfeat = JaxFeatureDB.synthetic(SCANS, conn, dim=DIM)
    jdepth = JaxFeatureDB.synthetic(SCANS, conn, dim=DIM, salt=7)
    jenv = JaxEnv(jfeat, items, batch_size=2, connectivity_dir=conn,
                  max_candidates=16, max_input=L, depth_db=jdepth)
    jagent = JaxAgent(JaxConfig(**kw, connectivity_dir=conn), jenv, jfeat,
                      depth_db=jdepth, vocab_size=len(tok), rng_seed=11)
    agent = port_agent(world, **NO_DROPOUT, use_pallas=use_pallas)
    agent.load_jax_params(jax.tree_util.tree_map(np.asarray, jagent.params))
    return jagent, agent


def noise_vector(seed=3):
    keep = np.random.default_rng(seed).random(DIM) > 0.3
    return (keep / 0.7).astype(np.float32)


def jax_pass(jagent, feedback, train_ml, train_rl, noise):
    """One JAX device pass with the env-drop noise replaced."""
    args = list(jagent._device_rollout_args(feedback, train_ml, train_rl))
    args[8] = jnp.asarray(noise)
    grads, logs = jagent._device_grad_fn(feedback, True)(
        jagent.params, jagent.tables, jagent._dev_env.arrays(), *args)
    return grads, {k: np.asarray(v) for k, v in logs.items()}


def port_grads(agent):
    return {name: (torch.zeros_like(p) if p.grad is None else p.grad)
            .numpy() for name, p in agent.policy.named_parameters()}


def assert_grads_match(agent, jax_grads):
    """Every gradient leaf of the port against the JAX tree, mapped onto
    the port's names (an LSTM's single JAX bias b is bias_ih; the frozen
    bias_hh has no gradient, which the mapping gives as zeros)."""
    ref = policy_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_grads))
    got = port_grads(agent)
    assert got.keys() == ref.keys()
    for name, grad in got.items():
        np.testing.assert_allclose(grad, ref[name], err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("use_pallas", ["never", "always"])
def test_teacher_pass_matches_jax(world, use_pallas):
    """device_rollout(feedback="teacher", train_ml=1, no RL): the
    gather-only teacher walk and its batched-percept replay."""
    jagent, agent = make_pair(world, use_pallas)
    noise = noise_vector()
    grads, logs = jax_pass(jagent, "teacher", 1.0, False, noise)
    agent.zero_grad()
    agent.device_rollout(train_ml=1.0, train_rl=False, feedback="teacher",
                         env_noise=torch.from_numpy(noise))
    np.testing.assert_allclose(float(agent.losses[-1]), logs["loss"],
                               rtol=LOSS_RTOL)
    assert int(agent._env_steps_log[-1]) == int(logs["env_steps"])
    assert_grads_match(agent, grads)


def test_a2c_replay_loss_matches_jax(world):
    """The replay body with RL on (rl_weight 1, ent_weight 0.01) over the
    same recorded episode, with actions off the teacher's path, random
    rewards and the JAX _grad_fn."""
    jagent, agent = make_pair(world, "never")
    dev, ep, instr, valid, seq_len = agent._batch_inputs()
    n_steps = 4
    stacked, final, _rewards, masks, ended = agent._teacher_trajectory(
        dev, ep, n_steps)
    rng = np.random.default_rng(5)
    cand_n = stacked["cand_n"].numpy()
    stacked["action"] = torch.from_numpy(
        rng.integers(0, cand_n + 1)).to(torch.int64)
    rewards = torch.from_numpy(
        rng.choice([-2.0, -1.0, 0.0, 1.0, 2.0], masks.shape)
        .astype(np.float32)) * masks
    noise = noise_vector()
    loss, _logs = agent._replay_loss(
        instr, valid, seq_len, stacked, final, rewards, masks, ended,
        agent._gen, torch.from_numpy(noise), 0.2, 1.0, 0.01)
    agent.zero_grad()
    loss.backward()

    def jnp_tree(tree):
        return {k: jnp.asarray(v.numpy().astype(np.int32)
                               if v.dtype == torch.int64 else v.numpy())
                for k, v in tree.items()}

    grads, logs = jagent._grad_fn(True, n_steps)(
        jagent.params, jagent.tables, jnp.asarray(instr.numpy(), jnp.int32),
        jnp.asarray(valid.numpy()), jnp.asarray(seq_len.numpy(), jnp.int32),
        jnp_tree(stacked), jnp_tree(final), jnp.asarray(rewards.numpy()),
        jnp.asarray(masks.numpy()), jnp.asarray(ended.numpy()),
        jnp.zeros(2), jax.random.PRNGKey(0), jnp.asarray(noise),
        jnp.float32(0.2), jnp.float32(1.0), jnp.float32(0.01))
    np.testing.assert_allclose(loss.item(), float(logs["loss"]),
                               rtol=LOSS_RTOL)
    assert_grads_match(agent, grads)


def test_fused_argmax_pass_matches_jax(world):
    """device_rollout(feedback="argmax", train_ml=0.2): the fused
    step-by-step pass is deterministic, so both take the same actions."""
    jagent, agent = make_pair(world, "always")
    noise = noise_vector()
    grads, logs = jax_pass(jagent, "argmax", 0.2, False, noise)
    agent.zero_grad()
    agent.device_rollout(train_ml=0.2, train_rl=True, feedback="argmax",
                         env_noise=torch.from_numpy(noise))
    np.testing.assert_allclose(float(agent.losses[-1]), logs["loss"],
                               rtol=LOSS_RTOL)
    # the same trajectories: the same active steps, in total and per pass
    assert int(agent._env_steps_log[-1]) == int(logs["env_steps"])
    assert float(agent.logs["total"][-1]) == float(logs["total"])
    assert_grads_match(agent, grads)


def test_fused_sample_pass_grads_match_its_replay(world):
    """The port of test_device_rollout_grads_match_host: the sampled pass
    (kernel route of the top BiLSTM, per-step percepts) and the replay of
    the episode it sampled (batched percepts, plain BiLSTM) give the same
    A2C loss and gradients."""
    agent = port_agent(world, **NO_DROPOUT, use_pallas="always")
    noise = torch.from_numpy(noise_vector())
    record = {}
    agent.zero_grad()
    agent.device_rollout(train_ml=None, train_rl=True, feedback="sample",
                         env_noise=noise, record=record)
    fused, loss_fused = port_grads(agent), float(agent.losses[-1])
    agent.zero_grad()
    loss, _ = agent._replay_loss(
        record["instr"], record["valid"], record["seq_len"],
        record["stacked"], record["final_sobs"], record["rewards"],
        record["rl_masks"], record["final_ended"], agent._gen, noise,
        0.0, 1.0, 0.01)
    loss.backward()
    np.testing.assert_allclose(loss.item(), loss_fused, rtol=LOSS_RTOL)
    for name, grad in port_grads(agent).items():
        np.testing.assert_allclose(grad, fused[name], err_msg=name,
                                   **GRAD_TOL)


def test_optimizer_step_matches_build_optimizer():
    """RMSprop per component, the clip at 40 on encoder and decoder
    (engaged: every gradient norm is far above 40), and the warmup /
    step-decay multiplier on decoder, critic and adain: warmup steps 0-1,
    plateau 2, decayed 3-4."""
    cfg_kw = dict(optim="rms", lr=1e-2, use_lr_scheduler=True, warm_steps=2,
                  decay_start=3, decay_intervals=1, lr_decay=0.5)
    rng = np.random.default_rng(0)
    names = ("encoder", "decoder", "critic", "adain")
    init = {n: rng.standard_normal((3, 4)).astype(np.float32) for n in names}

    class Policy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for n in names:
                self.add_module(n, torch.nn.Module())
                getattr(self, n).w = torch.nn.Parameter(
                    torch.from_numpy(init[n].copy()))

    policy = Policy()
    opt = ComponentOptimizer(Config(**cfg_kw), policy)
    params = {n: {"w": jnp.asarray(init[n])} for n in names}
    tx = build_optimizer(JaxConfig(**cfg_kw), params)
    state = tx.init(params)
    for _ in range(5):
        g = {n: (rng.standard_normal((3, 4)) * 30).astype(np.float32)
             for n in names}
        assert min(np.linalg.norm(v) for v in g.values()) > CLIP_NORM
        for n in names:
            getattr(policy, n).w.grad = torch.from_numpy(g[n])
        opt.step()
        updates, state = tx.update({n: {"w": jnp.asarray(g[n])}
                                    for n in names}, state, params)
        params = optax.apply_updates(params, updates)
        for n in names:
            np.testing.assert_allclose(
                getattr(policy, n).w.detach().numpy(),
                np.asarray(params[n]["w"]), rtol=1e-5, atol=1e-6,
                err_msg=f"{n} after step {opt.iteration}")


def test_train_loop_saves_and_loads(world, tmp_path):
    """train(cfg, world, device="cpu"): finite losses, moved parameters,
    validation and checkpoints; load() restores the saved parameters."""
    from dasa_tpu_torch.train.trainer import World, make_agent, train

    conn, data, _tok = world
    cfg = Config(**CFG, use_pallas="always", iters=2, log_every=1,
                 val_every=2, save_every=100, connectivity_dir=conn,
                 data_dir=data, snap_dir=str(tmp_path / "snap"),
                 log_dir=str(tmp_path / "log"))
    w = World(cfg)
    agent = make_agent(cfg, w, device="cpu")
    before = {k: v.clone() for k, v in agent.policy.state_dict().items()}
    agent = train(cfg, w, agent=agent)
    assert agent.iter_count == 2
    losses = [float(x) for x in agent.logs["loss"]]
    assert len(losses) == 2 and np.isfinite(losses).all()  # one interval
    after = agent.policy.state_dict()
    moved = [k for k in after if not torch.equal(after[k], before[k])]
    assert any(k.startswith("decoder.") for k in moved)
    assert any(k.startswith("encoder.lstm.") for k in moved)
    assert not any(k.startswith("encoder.bert.") for k in moved)  # frozen
    path = os.path.join(cfg.snap_dir, cfg.name, "state_dict", "LAST_iter2")
    assert os.path.exists(path)
    fresh = make_agent(cfg.replace(load_optim=True), w, device="cpu",
                       rng_seed=1)
    assert fresh.load(path) == 2
    for key, val in fresh.policy.state_dict().items():
        torch.testing.assert_close(val, after[key], atol=0, rtol=0)
    assert fresh.iter_count == 2


def test_teacher_training_reduces_loss(world):
    """The port of test_device_rollout_training_reduces_loss."""
    agent = port_agent(world, lr=3e-3, optim="adam", dropout=0.3,
                       max_action=4, consistent_drop=False)
    losses = []
    for _ in range(12):
        agent.zero_grad()
        agent.device_rollout(train_ml=1.0, train_rl=False,
                             feedback="teacher")
        agent.optim_step()
        losses.append(float(agent.losses[-1]))
    assert np.mean(losses[-4:]) < np.mean(losses[:4]) * 0.9, losses
    assert agent.env_steps_total() > 0


def test_same_seed_same_gradients(world):
    """Dropout, the env-drop noise and the sampled actions all come from
    the agent's generator: the same seed gives the same pass pair."""
    def grads():
        agent = port_agent(world, seed=4)
        agent.zero_grad()
        agent.accumulate_gradient("sample")
        return port_grads(agent), [float(x) for x in agent.losses]

    (g1, l1), (g2, l2) = grads(), grads()
    assert l1 == l2 and np.isfinite(l1).all()
    for name in g1:
        np.testing.assert_array_equal(g1[name], g2[name], err_msg=name)


@pytest.mark.parametrize("option", [
    dict(device_rollout="never"), dict(pretrain_model_name="bert.pt"),
    dict(fuse_passes="auto"), dict(remat="percept")])
def test_unported_training_paths_raise(world, option, tmp_path):
    """The training options once left out of the port now run: a
    teacher-ML and a sampled pass with finite losses and gradients.
    ``device_rollout="never"`` runs the host act/replay rollout,
    ``pretrain_model_name`` grafts a Pretrainer snapshot (written here,
    under that name) into the encoder first, ``fuse_passes="auto"`` runs
    the same split pair and ``remat="percept"`` recomputes the percepts
    in the backward; each then takes an optimizer step."""
    if "pretrain_model_name" in option:
        plain = port_agent(world)
        snap = tmp_path / option["pretrain_model_name"]
        torch.save({"step": 1, "state_dict": {
            f"bert.{k}": v + 0.5
            for k, v in plain.policy.encoder.bert.state_dict().items()}},
            snap)
        option = dict(pretrain_model_name=str(snap))
        grafted = port_agent(world, **option).policy.encoder.bert
        assert torch.equal(grafted.pooler.dense.weight,
                           plain.policy.encoder.bert.pooler.dense.weight
                           + 0.5)
    agent = port_agent(world, **option)
    agent.zero_grad()
    agent.accumulate_gradient("sample")
    assert len(agent.losses) == 2
    assert np.isfinite([float(x) for x in agent.losses]).all()
    grads = [p.grad for p in agent.policy.parameters() if p.grad is not None]
    assert grads and all(torch.isfinite(g).all() for g in grads)
    agent.optim_step()
    assert agent.iter_count == 1


def test_cli_trains_and_validates_on_cpu(world, tmp_path, capsys):
    """python -m dasa_tpu_torch.cli --train listener, then validlistener
    --load on the checkpoint it wrote."""
    from dasa_tpu_torch.cli import main

    conn, data, _tok = world
    args = ["--device", "cpu", "--connectivity_dir", conn, "--data_dir", data,
            "--snap_dir", str(tmp_path / "snap"), "--log_dir",
            str(tmp_path / "log"), "--name", "cli", "--iters", "2",
            "--log_every", "2", "--val_every", "2", "--batchSize", "2"]
    for key, val in CFG.items():
        if key != "batch_size":
            args += [f"--{key}", str(val)]
    main(args + ["--train", "listener"])
    ckpt = tmp_path / "snap" / "cli" / "state_dict" / "LAST_iter2"
    assert ckpt.exists()
    assert "PROGRESS: 2/2" in capsys.readouterr().out
    main(args + ["--train", "validlistener", "--load", str(ckpt)])
    out = capsys.readouterr().out
    assert "Loaded listener at iter 2" in out and "val_unseen" in out
    # Dijkstra search with an untrained speaker's rescoring
    main(args + ["--train", "validlistener", "--beam", "--load", str(ckpt)])
    out = capsys.readouterr().out
    assert "Loaded listener at iter 2" in out
    assert "Env name: val_seen" in out and "Env name: val_unseen" in out
