"""The port's training passes on the plain, legacy and mcatt encoders
against the JAX package.

Three configurations at test widths on a synthetic 2-scan world: the
plain ``EncoderLSTM`` listener (the Config default), ``BertAdd`` (the
cached text stack, the joint add-layer and its [views; tokens] ctx) and
``agent_type="mcatt"``.  The BERT is narrowed to 64 wide (2 heads) on
both sides; the JAX agent and the port carry the same weights
(``policy_state_dict_from_jax``), every dropout rate is 0 (the MCAN
blocks' fixed 0.1 too, patched on both sides) and both take the same
env-drop noise.  Per configuration: the device teacher pass (the replay
body), the fused argmax pass, a stream window, and the port's
``_run_replays`` of a JAX-sampled host episode must give the JAX agent's
loss, logs and gradients.

Tolerances: tests/test_torch_train.py's loss rtol 1e-4 and gradient rtol
2e-4 / atol 1e-6 (f32 sums over every step's percept round differently
in XLA and PyTorch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasa_tpu.agents import Seq2SeqAgent as JaxAgent
from dasa_tpu.config import Config as JaxConfig
from dasa_tpu.data.features import FeatureDB as JaxFeatureDB
from dasa_tpu.env import R2REnv as JaxEnv
from dasa_tpu.models import mcan as jax_mcan
from dasa_tpu.models import policy as jax_policy
from dasa_tpu_torch.agents import Seq2SeqAgent
from dasa_tpu_torch.config import Config
from dasa_tpu_torch.data.datasets import (
    expand_instructions,
    load_datasets,
    make_synthetic_task,
)
from dasa_tpu_torch.data.features import FeatureDB
from dasa_tpu_torch.env import R2REnv
from dasa_tpu_torch.models import mcan as port_mcan
from dasa_tpu_torch.models import policy as port_policy
from dasa_tpu_torch.testing import torch_threads, write_synthetic_connectivity
from dasa_tpu_torch.utils import Tokenizer, build_vocab
from dasa_tpu_torch.utils.jax_params import policy_state_dict_from_jax

SCANS = ("synthA", "synthB")
DIM = 24
L = 24
CFG = dict(
    rnn_dim=32, wemb=16, aemb=8, critic_dim=32, angle_feat_size=8,
    feature_size=DIM, max_input=L, max_candidates=16, max_action=5,
    batch_size=2, d_enc_hidden_size=16, d_hidden_size=32, d_vl_layers=1,
    d_la_layers=2, consistent_drop=True, depth_drop=True, featdropout=0.3,
    ml_weight=0.2, dropout=0.0, d_dropout_ratio=0.0,
    d_hidden_dropout_prob=0.0, d_attn_dropout_prob=0.0)
ENCODERS = {
    "EncoderLSTM": dict(),
    "BertAdd": dict(encoder_type="BertAdd", include_vision=True,
                    adain_type="channel", ab_type="a", a_type="sigmoid",
                    use_shift=True),
    "mcatt": dict(encoder_type="Dic", include_vision=True,
                  agent_type="mcatt", mcan_hidden_size=64, mcan_heads=2,
                  mcan_layers=1, mcan_flat_mlp_size=32),
}
NARROW = dict(hidden_size=64, num_attention_heads=2, intermediate_size=128)
LOSS_RTOL = 1e-4
GRAD_TOL = dict(rtol=2e-4, atol=1e-6)


class JaxMcattNoDropout(jax_mcan.McattEncoder):
    dropout: float = 0.0


class PortMcattNoDropout(port_mcan.McattEncoder):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw, rate=0.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(autouse=True, scope="module")
def narrow_and_dropout_free():
    """The 64-wide BERT and dropout-free MCAN blocks on both sides, for
    the whole module (flax re-reads them at every apply, and the shared
    pairs are built once)."""
    import dataclasses

    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_policy, port_policy):
            base = mod.bert_config_from
            mp.setattr(mod, "bert_config_from",
                       lambda cfg, base=base: dataclasses.replace(
                           base(cfg), **NARROW))
        mp.setattr(jax_mcan, "McattEncoder", JaxMcattNoDropout)
        mp.setattr(port_mcan, "McattEncoder", PortMcattNoDropout)
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_encoders_world")
    conn, data = str(root / "connectivity"), str(root / "task")
    write_synthetic_connectivity(conn, SCANS, n_nodes=24, seed=0)
    make_synthetic_task(data, SCANS[:1], SCANS[1:], n_train=6, n_val=2,
                        connectivity_dir=conn)
    vocab = build_vocab(load_datasets(["train"], data), min_count=1)
    return conn, data, Tokenizer(vocab, encoding_length=L)


def make_pair(world, **kw):
    """JAX and port agents over the train split, the same weights."""
    conn, data, tok = world
    items = expand_instructions(load_datasets(["train"], data), tok,
                                max_input=L)
    kw = {**CFG, **kw}
    jfeat = JaxFeatureDB.synthetic(SCANS, conn, dim=DIM)
    jdepth = JaxFeatureDB.synthetic(SCANS, conn, dim=DIM, salt=7)
    jenv = JaxEnv(jfeat, items, batch_size=2, connectivity_dir=conn,
                  max_candidates=16, max_input=L, depth_db=jdepth,
                  backend="python")
    jagent = JaxAgent(JaxConfig(**kw, connectivity_dir=conn), jenv, jfeat,
                      depth_db=jdepth, vocab_size=len(tok), rng_seed=11)
    feat = FeatureDB.synthetic(SCANS, conn, dim=DIM)
    depth = FeatureDB.synthetic(SCANS, conn, dim=DIM, salt=7)
    env = R2REnv(feat, items, batch_size=2, connectivity_dir=conn,
                 max_candidates=16, max_input=L, depth_db=depth)
    agent = Seq2SeqAgent(Config(**kw, connectivity_dir=conn, data_dir=data),
                         env, feat, depth_db=depth, vocab_size=len(tok),
                         device="cpu")
    agent.load_jax_params(jax.tree_util.tree_map(np.asarray, jagent.params))
    return jagent, agent


@pytest.fixture(scope="module")
def pairs(world, narrow_and_dropout_free):
    """One JAX / port pair per encoder, shared by the device passes and
    the host replay (each test zeroes the port's gradients; both agents
    of a pair advance through the same minibatches in step)."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = make_pair(world, **ENCODERS[name])
        return cache[name]

    return get


def noise_vector(seed=3):
    keep = np.random.default_rng(seed).random(DIM) > 0.3
    return (keep / 0.7).astype(np.float32)


def assert_grads_match(agent, jax_grads):
    ref = policy_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_grads))
    got = {name: (torch.zeros_like(p) if p.grad is None else p.grad)
           .numpy() for name, p in agent.policy.named_parameters()}
    assert got.keys() == ref.keys()
    for name, grad in got.items():
        np.testing.assert_allclose(grad, ref[name], err_msg=name,
                                   **GRAD_TOL)
    # the encoder's LSTM learns on every path
    assert any(np.abs(grad).max() > 0 for name, grad in got.items()
               if name.startswith("encoder.") and ".lstm." in name)


def assert_logs_match(agent, logs):
    for key in ("loss", "ml_loss", "forth_loss", "rl_loss", "critic_loss"):
        np.testing.assert_allclose(float(agent.logs[key][-1]),
                                   float(logs[key]), rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize("name", list(ENCODERS))
@pytest.mark.parametrize("feedback", ["teacher", "argmax"])
def test_device_pass_matches_jax(pairs, name, feedback):
    """The teacher pass (train_ml 1: the walk and its batched-percept
    replay, the per-episode cache repeated over the steps) and the fused
    argmax pass (train_ml 0.2 and the A2C terms, step by step)."""
    jagent, agent = pairs(name)
    noise = noise_vector()
    train_ml = 1.0 if feedback == "teacher" else 0.2
    args = list(jagent._device_rollout_args(feedback, train_ml, False))
    args[8] = jnp.asarray(noise)
    grads, logs = jagent._device_grad_fn(feedback, True)(
        jagent.params, jagent.tables, jagent._dev_env.arrays(), *args)
    agent.zero_grad()
    agent.device_rollout(train_ml=train_ml, train_rl=feedback == "argmax",
                         feedback=feedback, env_noise=torch.from_numpy(noise))
    assert_logs_match(agent, logs)
    assert int(agent._env_steps_log[-1]) == int(logs["env_steps"])
    assert_grads_match(agent, grads)


@pytest.mark.parametrize("name", list(ENCODERS))
def test_stream_window_matches_jax(world, name):
    """One stream window (2B = 4 slots x 4 steps; the text encode over
    [slots | teacher pool | sample pool] and the slot gather of each
    cache key): the loss, the logs and the gradients."""
    kw = dict(ENCODERS[name], featdropout=0.0, rollout_mode="stream",
              stream_steps=4)
    jagent, agent = make_pair(world, **kw)
    jagent.zero_grad()
    agent.zero_grad()
    jagent.device_rollout_stream(0.2, feedback="argmax")
    agent.device_rollout_stream(0.2, feedback="argmax")
    np.testing.assert_allclose(float(agent.losses[-1]),
                               float(jagent.losses[-1]), rtol=LOSS_RTOL)
    for key in ("ml_loss", "rl_loss", "critic_loss"):
        np.testing.assert_allclose(
            float(agent.logs[key][-1]), float(jagent.logs[key][-1]),
            rtol=LOSS_RTOL, atol=1e-6, err_msg=key)
    assert_grads_match(agent, jagent._grad_accum)


@pytest.mark.parametrize("name", list(ENCODERS))
def test_host_replay_matches_jax(pairs, name):
    """A sampled host episode of the JAX agent (its sampler draws
    differently), replayed by the port's ``_run_replays``: the A2C loss,
    the logs and the gradients."""
    jagent, agent = pairs(name)
    noise = noise_vector()
    jagent._noise_fn = lambda: (lambda _rng: jnp.asarray(noise))
    jagent.zero_grad()
    jagent.rollout(train_ml=0.2, train_rl=True, feedback="sample",
                   defer_grad=True)
    (instr, valid, seq_len, stacked, final, rewards, masks, ended, pm,
     _rng, _noise, mlw, rlw, entw) = jagent._pending_replays[0]["args"]
    replay = {
        "instr": torch.from_numpy(np.array(instr)).long(),
        "valid": torch.from_numpy(np.array(valid)),
        "seq_len": torch.from_numpy(np.array(seq_len)).long(),
        "stacked": {k: np.asarray(v) for k, v in stacked.items()},
        "final_sobs": {k: np.asarray(v) for k, v in final.items()},
        "rewards": np.asarray(rewards), "rl_masks": np.asarray(masks),
        "final_ended": np.asarray(ended), "pm_target": np.asarray(pm),
        "streams": agent._host_streams(), "noise": torch.from_numpy(noise),
        "weights": (float(mlw), float(rlw), float(entw))}
    jagent.flush_replays()
    agent.zero_grad()
    agent._run_replays([replay])
    np.testing.assert_allclose(float(agent.losses[-1]),
                               float(jagent.losses[-1]), rtol=LOSS_RTOL)
    for key in ("ml_loss", "rl_loss"):
        np.testing.assert_allclose(float(agent.logs[key][-1]),
                                   float(jagent.logs[key][-1]),
                                   rtol=LOSS_RTOL, atol=1e-6, err_msg=key)
    assert_grads_match(agent, jagent._grad_accum)
