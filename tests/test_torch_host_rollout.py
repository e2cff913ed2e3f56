"""The port's host act/replay rollout against the JAX package.

On a synthetic 2-scan world, the JAX ``Seq2SeqAgent`` and the port's carry
the same weights for the Dic / channel-AdaIN / shift-5 listener of
tests/test_torch_train.py, in f32 on the CPU, with every dropout rate 0
and the same env-drop noise (the two frameworks' random streams differ).
The JAX envs run the Python engine (``backend="python"``), the port's only
one, so that the geometry matches to the bit.  Argmax evaluation with
``submit`` (the visited-candidate mask) must give JAX's trajectories and
submit files exactly; the teacher pass and the replay of a sampled
episode must give JAX's loss and gradients at tests/test_device_env.py:
142-145's tolerances (loss rtol 1e-4; gradients rtol 2e-4, atol 1e-6).
Then, within the port: the host teacher pass against the device teacher
pass, deferred replays, the replay's per-step dropout streams, sampled
evaluation with dropout, and ``device_rollout="never"`` training.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dasa_tpu.models.policy as jax_policy
from dasa_tpu.agents import Seq2SeqAgent as JaxAgent
from dasa_tpu.config import Config as JaxConfig
from dasa_tpu.data.features import FeatureDB as JaxFeatureDB
from dasa_tpu.env import R2REnv as JaxEnv
from dasa_tpu.train import trainer as jax_trainer
import dasa_tpu_torch.models.policy as port_policy
from dasa_tpu_torch.agents import Seq2SeqAgent
from dasa_tpu_torch.agents.seq2seq import PassStreams, make_step_inputs
from dasa_tpu_torch.config import Config
from dasa_tpu_torch.data.datasets import (
    expand_instructions,
    load_datasets,
    make_synthetic_task,
)
from dasa_tpu_torch.data.features import FeatureDB
from dasa_tpu_torch.env import R2REnv
from dasa_tpu_torch.testing import torch_threads, write_synthetic_connectivity
from dasa_tpu_torch.train import trainer
from dasa_tpu_torch.utils import Tokenizer, build_vocab
from dasa_tpu_torch.utils.jax_params import policy_state_dict_from_jax

SCANS = ("synthA", "synthB")
DIM = 24
L = 24
B = 2
CFG = dict(
    rnn_dim=32, wemb=16, aemb=8, critic_dim=32, angle_feat_size=8,
    feature_size=DIM, max_input=L, max_candidates=16, max_action=5,
    batch_size=B, d_enc_hidden_size=16, d_hidden_size=32, d_vl_layers=1,
    d_la_layers=1, encoder_type="Dic", include_vision=True,
    adain_type="channel", ab_type="a", a_type="sigmoid", use_shift=True,
    shift_kernel_size=5, consistent_drop=True, depth_drop=True,
    featdropout=0.3, ml_weight=0.2)
NO_DROPOUT = dict(dropout=0.0, d_dropout_ratio=0.0, d_hidden_dropout_prob=0.0,
                  d_attn_dropout_prob=0.0)
TOL = dict(rtol=1e-4, atol=1e-5)
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
    root = tmp_path_factory.mktemp("torch_host_world")
    conn, data = str(root / "connectivity"), str(root / "task")
    write_synthetic_connectivity(conn, SCANS, n_nodes=24, seed=0)
    # one path (three instructions) a val split: two batches of B
    make_synthetic_task(data, SCANS[:1], SCANS[1:], n_train=6, n_val=1,
                        connectivity_dir=conn)
    vocab = build_vocab(load_datasets(["train"], data), min_count=1)
    return conn, data, Tokenizer(vocab, encoding_length=L)


class JaxPythonWorld(jax_trainer.World):
    """The JAX World with the Python engine in every env."""

    def _make_env(self, items, name):
        cfg = self.cfg
        return JaxEnv(self.feature_db, items, batch_size=cfg.batch_size,
                      seed=cfg.seed, name=name,
                      connectivity_dir=cfg.connectivity_dir,
                      max_candidates=cfg.max_candidates,
                      max_input=cfg.max_input, depth_db=self.depth_db,
                      backend="python")


def port_agent(world, split="train", seed=0, **kw):
    conn, data, tok = world
    items = expand_instructions(load_datasets([split], data), tok,
                                max_input=L)
    cfg = Config(**{**CFG, **kw}, connectivity_dir=conn, data_dir=data)
    feat = FeatureDB.synthetic(SCANS, conn, dim=DIM)
    depth = FeatureDB.synthetic(SCANS, conn, dim=DIM, salt=7)
    env = R2REnv(feat, items, batch_size=B, connectivity_dir=conn,
                 max_candidates=16, max_input=L, depth_db=depth)
    return Seq2SeqAgent(cfg, env, feat, depth_db=depth, rng_seed=seed,
                        device="cpu")


def make_pair(world, use_pallas="always", split="train", **kw):
    """JAX and port agents over one split, same weights, dropout 0."""
    conn, data, tok = world
    items = expand_instructions(load_datasets([split], data), tok,
                                max_input=L)
    kw = {**CFG, **NO_DROPOUT, **kw, "use_pallas": use_pallas}
    jfeat = JaxFeatureDB.synthetic(SCANS, conn, dim=DIM)
    jdepth = JaxFeatureDB.synthetic(SCANS, conn, dim=DIM, salt=7)
    jenv = JaxEnv(jfeat, items, batch_size=B, connectivity_dir=conn,
                  max_candidates=16, max_input=L, depth_db=jdepth,
                  backend="python")
    jagent = JaxAgent(JaxConfig(**kw, connectivity_dir=conn), jenv, jfeat,
                      depth_db=jdepth, vocab_size=len(tok), rng_seed=11)
    agent = port_agent(world, split, **kw)
    agent.load_jax_params(jax.tree_util.tree_map(np.asarray, jagent.params))
    return jagent, agent


def noise_vector(seed=3):
    keep = np.random.default_rng(seed).random(DIM) > 0.3
    return (keep / 0.7).astype(np.float32)


def fix_jax_noise(jagent, noise):
    jagent._noise_fn = lambda: (lambda _rng: jnp.asarray(noise))


def assert_grads_match(agent, jax_grads):
    ref = policy_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_grads))
    got = {name: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
           for name, p in agent.policy.named_parameters()}
    assert got.keys() == ref.keys()
    for name, grad in got.items():
        np.testing.assert_allclose(grad, ref[name], err_msg=name,
                                   **GRAD_TOL)


def replay_from_jax(agent, replay):
    """A JAX pending replay in the port's form."""
    (instr, valid, seq_len, stacked, final, rewards, masks, ended, _pm,
     _rng, noise, mlw, rlw, entw) = replay["args"]
    return {
        "instr": torch.from_numpy(np.array(instr)).long(),
        "valid": torch.from_numpy(np.array(valid)),
        "seq_len": torch.from_numpy(np.array(seq_len)).long(),
        "stacked": {k: np.asarray(v) for k, v in stacked.items()},
        "final_sobs": {k: np.asarray(v) for k, v in final.items()},
        "rewards": np.asarray(rewards), "rl_masks": np.asarray(masks),
        "final_ended": np.asarray(ended), "streams": agent._host_streams(),
        "noise": (torch.from_numpy(np.array(noise))
                  if replay["use_noise"] else None),
        "weights": (float(mlw), float(rlw), float(entw))}


def walk_skips_visited(trajectory):
    """No move of the walk returns to a viewpoint it left (micro-steps
    turn in place and repeat the viewpoint)."""
    seen, last = set(), None
    for vp, *_pose in trajectory:
        if vp != last:
            if vp in seen:
                return False
            seen.add(vp)
            last = vp
    return True


def test_submit_eval_matches_jax(world, tmp_path, monkeypatch):
    """validlistener --submit: the host argmax rollout under the
    visited-candidate mask over both val splits gives JAX's
    trajectories, summaries and submit files."""
    conn, data, _tok = world
    kw = dict(**CFG, **NO_DROPOUT, use_pallas="always", submit=True,
              connectivity_dir=conn, data_dir=data, name="sub")
    jcfg = JaxConfig(**kw, log_dir=str(tmp_path / "jax"))
    jworld = JaxPythonWorld(jcfg)
    jagent = jax_trainer.make_agent(jcfg, jworld)
    monkeypatch.setattr(jax_trainer, "make_agent", lambda *a, **k: jagent)
    jout = jax_trainer.valid(jcfg, jworld)

    cfg = Config(**kw, log_dir=str(tmp_path / "port"))
    pworld = trainer.World(cfg)
    agent = trainer.make_agent(cfg, pworld, device="cpu")
    agent.load_jax_params(jax.tree_util.tree_map(np.asarray, jagent.params))
    assert not agent.use_device_rollout()
    out = trainer.valid(cfg, pworld, agent=agent)
    assert out == jout
    for split in ("val_seen", "val_unseen"):
        name = os.path.join("sub", f"submit_{split}.json")
        with open(tmp_path / "port" / name) as f:
            got = json.load(f)
        with open(tmp_path / "jax" / name) as f:
            assert got == json.load(f)
        want = sorted(it["instr_id"] for it in pworld.envs[split].data)
        assert sorted(r["instr_id"] for r in got) == want
        assert all(walk_skips_visited(r["trajectory"]) for r in got)


def test_host_teacher_pass_matches_jax(world):
    """rollout(feedback="teacher", train_ml=1): the shortest-path walk on
    the host and the replay of it."""
    jagent, agent = make_pair(world)
    noise = noise_vector()
    fix_jax_noise(jagent, noise)
    jpaths = jagent.rollout(train_ml=1.0, train_rl=False,
                            feedback="teacher")
    agent.zero_grad()
    paths = agent.rollout(train_ml=1.0, train_rl=False, feedback="teacher",
                          env_noise=torch.from_numpy(noise))
    assert paths == jpaths
    np.testing.assert_allclose(float(agent.losses[-1]),
                               float(jagent.losses[-1]), rtol=LOSS_RTOL)
    assert agent.total_env_steps == jagent.total_env_steps
    assert_grads_match(agent, jagent._grad_accum)


def test_sampled_replay_matches_jax(world):
    """A sampled host episode of the JAX agent (its sampler draws
    differently), replayed by the port: the A2C loss and gradients."""
    jagent, agent = make_pair(world)
    fix_jax_noise(jagent, noise_vector())
    jagent.rollout(train_ml=None, train_rl=True, feedback="sample",
                   defer_grad=True)
    replay = replay_from_jax(agent, jagent._pending_replays[0])
    jagent.flush_replays()
    agent.zero_grad()
    agent._run_replays([replay])
    np.testing.assert_allclose(float(agent.losses[-1]),
                               float(jagent.losses[-1]), rtol=LOSS_RTOL)
    assert_grads_match(agent, jagent._grad_accum)


def test_host_teacher_pass_matches_device_teacher_pass(world):
    """The same batch through the host rollout and the device teacher
    pass: the same loss and gradients."""
    agent = port_agent(world, **NO_DROPOUT, use_pallas="always")
    noise = torch.from_numpy(noise_vector())
    grads = []
    for run in (agent.rollout, agent.device_rollout):
        agent.env.reset_epoch()
        agent.zero_grad()
        run(train_ml=0.2, train_rl=False, feedback="teacher",
            env_noise=noise)
        grads.append({n: p.grad.clone() for n, p in
                      agent.policy.named_parameters() if p.grad is not None})
    np.testing.assert_allclose(float(agent.losses[-1]),
                               float(agent.logs["loss"][0]), rtol=LOSS_RTOL)
    assert grads[0].keys() == grads[1].keys()
    for name, grad in grads[0].items():
        np.testing.assert_allclose(grad.numpy(), grads[1][name].numpy(),
                                   err_msg=name, **GRAD_TOL)


def test_deferred_replays_match_immediate(world):
    """rollout(defer_grad=True) queues the replay; flush_replays (which
    optim_step calls first) runs it: the gradients of a deferred pass pair
    equal the immediate pair's on the same batches and streams."""
    agent = port_agent(world, seed=3, device_rollout="never")

    def pair(defer):
        agent.env.reset_epoch()
        agent._rollout_counter = 0
        agent.zero_grad()
        agent.rollout(train_ml=0.2, train_rl=False, feedback="teacher",
                      defer_grad=defer)
        agent.rollout(train_ml=None, train_rl=True, feedback="sample",
                      defer_grad=defer)
        assert len(agent._pending_replays) == (2 if defer else 0)
        agent.flush_replays()
        return {n: p.grad.clone() for n, p in
                agent.policy.named_parameters() if p.grad is not None}

    now, later = pair(False), pair(True)
    assert now.keys() == later.keys()
    for name in now:
        torch.testing.assert_close(later[name], now[name], atol=0, rtol=0)


def test_replay_percepts_draw_the_act_steps_dropout(world):
    """With dropout on, a replay's batched percepts over T steps equal the
    act steps' one-step percepts (within the f32 tolerance: a product's
    rounding depends on its row count): each step's block of rows draws its
    dropout masks from that step's generator."""
    agent = port_agent(world, dropout=0.4, d_dropout_ratio=0.3,
                       d_hidden_dropout_prob=0.2, d_attn_dropout_prob=0.2,
                       use_pallas="always")
    agent.zero_grad()
    agent.rollout(train_ml=0.2, train_rl=False, feedback="teacher",
                  defer_grad=True)
    rep = agent._pending_replays[0]
    stacked = agent._put_sobs(rep["stacked"])
    streams = PassStreams("cpu", seed=1234)
    policy, noise = agent.policy, rep["noise"]
    n_steps = stacked["feat_row"].shape[0]
    with torch.no_grad():
        cached = policy.encode_text(rep["instr"], rep["valid"],
                                    rep["seq_len"], deterministic=False,
                                    gen=streams.text)
        flat = {k: v.flatten(0, 1) for k, v in stacked.items()}
        batched = policy.percept_step(
            {"text_embeds": cached["text_embeds"].repeat(n_steps, 1, 1)},
            rep["valid"].repeat(n_steps, 1), rep["seq_len"].repeat(n_steps),
            make_step_inputs(agent.cfg, agent.tables, flat),
            deterministic=False, env_noise=noise,
            gen=streams.steps(n_steps, 0))
        for t in range(n_steps):
            one = policy.percept_step(
                cached, rep["valid"], rep["seq_len"],
                make_step_inputs(agent.cfg, agent.tables,
                                 {k: v[t] for k, v in stacked.items()}),
                deterministic=False, env_noise=noise, gen=streams.at(t, 0))
            for key in ("ctx", "h0", "c0"):
                torch.testing.assert_close(
                    batched[key].unflatten(0, (n_steps, B))[t], one[key],
                    **TOL)
    # and the masks differ from step to step
    assert not torch.equal(batched["ctx"].unflatten(0, (n_steps, B))[0],
                           batched["ctx"].unflatten(0, (n_steps, B))[1])


def test_sampled_test_with_dropout_runs(world):
    """test(iters=2, feedback="sample", use_dropout=True): two host
    rollouts of a shuffled epoch, a trajectory for each episode."""
    agent = port_agent(world, split="val_seen", use_pallas="always")
    results = agent.test(iters=2, feedback="sample", use_dropout=True)
    assert 1 <= len(results) <= 2 * B
    ids = {it["instr_id"] for it in agent.env.data}
    for r in results:
        assert r["instr_id"] in ids and len(r["trajectory"]) >= 1
    assert agent.total_env_steps > 0


def test_never_device_rollout_trains(world):
    """train() under device_rollout="never": host pass pairs, finite
    losses, the listener moves, and every pass is counted."""
    agent = port_agent(world, device_rollout="never", use_pallas="always")
    before = {k: v.clone() for k, v in agent.policy.state_dict().items()}
    agent.train(1, feedback="sample")
    assert agent.iter_count == 1 and len(agent.losses) == 2
    assert np.isfinite([float(x) for x in agent.logs["loss"]]).all()
    moved = [k for k, v in agent.policy.state_dict().items()
             if not torch.equal(v, before[k])]
    assert any(k.startswith("decoder.") for k in moved)
    assert any(k.startswith("encoder.lstm.") for k in moved)
    assert agent.env_steps_total() == agent.total_env_steps > 0
