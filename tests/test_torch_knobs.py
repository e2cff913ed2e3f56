"""The JAX agent's program knobs in the PyTorch port: ``fuse_passes="auto"``
and ``remat``.

``fuse_passes="auto"`` runs the port's split teacher + sampled pair (a
documented no-op: the JAX combined program's gain is one XLA program for
the pair).  Mirroring ``tests/test_combined.py:96-132``, the JAX agent's
combined 2B-wide program equals the port's teacher pass plus argmax A2C
pass over the same two minibatches and env-drop rows (argmax stands in
for sampling), loss rtol 1e-4, gradients rtol 2e-4, atol 1e-6, env steps
equal, with every dropout rate but the consistent env-drop at 0.  The
cases add the back and progress heads, ``normalize_loss="batch"``, the
MT agent's KL and the segmented program (``_teacher_len() <
max_action``: JAX narrows to the sampled half).

``remat`` mirrors ``tests/test_device_env.py:174-201`` with dropout ON:
every mode's gradients equal ``never``'s (rtol 1e-5, atol 1e-7) in the
fused sampled pass, the teacher replay, the host replay and a stream
window (17 steps, so that ``auto`` recomputes the whole step).  Each pass
runs under a cast-once context that puts a bf16-rounded copy on every
parameter (as ``bf16_grad_accum`` does on the card): a recompute that
read the parameter outside the block, or that drew new dropout masks,
would give other gradients.

The listener is ``tests/test_torch_train.py``'s Dic / channel-AdaIN /
shift-5 one, its BERT narrowed to 64 wide on both sides.
"""

import contextlib
import dataclasses

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
from dasa_tpu_torch.utils import Tokenizer, build_vocab
from dasa_tpu_torch.utils.jax_params import policy_state_dict_from_jax

SCANS = ("synthA", "synthB")
DIM = 24
L = 24
CFG = dict(
    rnn_dim=32, wemb=16, aemb=8, critic_dim=32, angle_feat_size=8,
    feature_size=DIM, max_input=L, max_candidates=16, max_action=5,
    batch_size=3, d_enc_hidden_size=16, d_hidden_size=32, d_vl_layers=1,
    d_la_layers=1, encoder_type="Dic", include_vision=True,
    adain_type="channel", ab_type="a", a_type="sigmoid", use_shift=True,
    shift_kernel_size=5, consistent_drop=True, depth_drop=True,
    featdropout=0.3, ml_weight=0.2)
NO_DROPOUT = dict(dropout=0.0, d_dropout_ratio=0.0, d_hidden_dropout_prob=0.0,
                  d_attn_dropout_prob=0.0)
NARROW = dict(hidden_size=64, num_attention_heads=2, intermediate_size=128)
LOSS_RTOL = 1e-4
GRAD_TOL = dict(rtol=2e-4, atol=1e-6)
REMAT_TOL = dict(rtol=1e-5, atol=1e-7)
MODES = ("percept", "dots", "auto", "always")
FULL_BERT = port_policy.bert_config_from  # the MT decoder reads BERT's width


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
    root = tmp_path_factory.mktemp("torch_knobs_world")
    conn, data = str(root / "connectivity"), str(root / "task")
    write_synthetic_connectivity(conn, SCANS, n_nodes=24, seed=0)
    make_synthetic_task(data, SCANS[:1], SCANS[1:], n_train=9, n_val=2,
                        connectivity_dir=conn)
    tok = Tokenizer(build_vocab(load_datasets(["train"], data), min_count=1),
                    encoding_length=L)
    items = expand_instructions(load_datasets(["train"], data), tok,
                                max_input=L)
    return conn, data, tok, items


def port_agent(world, seed=0, **kw):
    conn, data, tok, items = world
    cfg = Config(**{**CFG, **kw}, connectivity_dir=conn, data_dir=data)
    feat = FeatureDB.synthetic(SCANS, conn, dim=DIM)
    depth = FeatureDB.synthetic(SCANS, conn, dim=DIM, salt=7)
    env = R2REnv(feat, items, batch_size=cfg.batch_size,
                 connectivity_dir=conn, max_candidates=16, max_input=L,
                 depth_db=depth)
    return Seq2SeqAgent(cfg, env, feat, depth_db=depth, rng_seed=seed,
                        vocab_size=len(tok), device="cpu")


def port_grads(agent):
    return {name: (torch.zeros_like(p) if p.grad is None else p.grad)
            .numpy().copy() for name, p in agent.policy.named_parameters()}


def assert_grads_equal(got, ref, tol):
    assert got.keys() == ref.keys()
    for name, grad in got.items():
        np.testing.assert_allclose(grad, ref[name], err_msg=name, **tol)


# ---------------------------------------------------------------------
# fuse_passes="auto": the split pair against JAX's combined program
# ---------------------------------------------------------------------
SPLIT_CASES = [
    {},
    {"pred_pm": True, "pm_type": "att", "pred_back": True},
    {"normalize_loss": "batch"},
    {"max_action": 14},
    {"agent_type": "mt", "max_action": 14},
]
JAX_FULL_BERT = jax_policy.bert_config_from


def jax_agent(world, **kw):
    conn, data, tok, items = world
    jfeat = JaxFeatureDB.synthetic(SCANS, conn, dim=DIM)
    jdepth = JaxFeatureDB.synthetic(SCANS, conn, dim=DIM, salt=7)
    jenv = JaxEnv(jfeat, items, batch_size=CFG["batch_size"],
                  connectivity_dir=conn, max_candidates=16, max_input=L,
                  depth_db=jdepth, backend="python")
    return JaxAgent(JaxConfig(**{**CFG, **kw}, connectivity_dir=conn), jenv,
                    jfeat, depth_db=jdepth, vocab_size=len(tok), rng_seed=11)


@pytest.mark.parametrize("extra", SPLIT_CASES)
def test_combined_matches_split_pass_sum(world, extra, monkeypatch):
    """JAX's combined program == the port's teacher pass + argmax A2C
    pass, on the same minibatches, weights and env-drop rows: loss, env
    steps, every gradient (the MT case at the full BERT width, which its
    decoder reads)."""
    if extra.get("agent_type") == "mt":
        monkeypatch.setattr(port_policy, "bert_config_from", FULL_BERT)
        monkeypatch.setattr(jax_policy, "bert_config_from", JAX_FULL_BERT)
    kw = {**NO_DROPOUT, **extra}
    jagent = jax_agent(world, **kw)
    if extra.get("max_action"):  # the segmented program must be real
        assert jagent._teacher_len() < kw["max_action"]
    rows = np.stack([(np.random.default_rng(s).random(DIM) > 0.3) / 0.7
                     for s in (3, 4)]).astype(np.float32)
    args = list(jagent._device_combined_args("argmax", 0.2, True))
    b = CFG["batch_size"]
    args[8] = jnp.asarray(np.repeat(rows, b, 0)[:, None, :])
    grads, logs = jagent._device_combined_grad_fn("argmax", True, False)(
        jagent.params, jagent.tables, jagent._dev_env.arrays(), *args)

    agent = port_agent(world, **kw, fuse_passes="auto")
    agent.load_jax_params(jax.tree_util.tree_map(np.asarray, jagent.params))
    agent.zero_grad()
    agent.device_rollout(train_ml=0.2, train_rl=False, feedback="teacher",
                         env_noise=torch.from_numpy(rows[0]))
    dev, ep, instr, valid, seq_len, gen, noise = \
        agent._device_rollout_args(torch.from_numpy(rows[1]))
    with agent._cast_params_once():
        loss_a, logs_a = agent._fused_loss("argmax", dev, ep, instr, valid,
                                           seq_len, gen, noise, 0.0, 1.0,
                                           0.0)
        loss_a.backward()
    assert agent._rollout_counter == 2
    np.testing.assert_allclose(float(agent.losses[-1]) + loss_a.item(),
                               float(logs["loss"]), rtol=LOSS_RTOL)
    assert int(agent._env_steps_log[-1]) + int(logs_a["env_steps"]) == \
        int(logs["env_steps"])
    ref = policy_state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            grads))
    assert_grads_equal(port_grads(agent), ref, GRAD_TOL)


def test_fuse_passes_auto_accumulates(world):
    """accumulate_gradient under fuse_passes="auto" runs the split pair:
    a teacher-ML pass and a sampled pass per call, the gradients of
    ``never`` from the same seed, the aug alternation accumulating a
    second pair into ``.grad``, and training steps."""
    agents = [port_agent(world, fuse_passes=f) for f in ("auto", "never")]
    p0 = agents[0].policy.decoder.lstm.weight_hh.detach().clone()
    for _ in range(2):
        grads = []
        for agent in agents:
            agent.zero_grad()
            agent.accumulate_gradient("sample", ml_weight=0.2)
            grads.append(port_grads(agent))
            agent.accumulate_gradient("sample", ml_weight=0.6)
            grads.append(port_grads(agent))
            agent.optim_step()
        g1, g2, n1, n2 = grads
        assert_grads_equal(g1, n1, REMAT_TOL)
        assert_grads_equal(g2, n2, REMAT_TOL)
        assert any(not np.allclose(g1[k], g2[k]) for k in g1)
    agent = agents[0]
    assert len(agent._env_steps_log) == 8 and agent._rollout_counter == 8
    assert np.isfinite([float(x) for x in agent.logs["loss"]]).all()
    assert not torch.equal(p0, agent.policy.decoder.lstm.weight_hh)


# ---------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------
@contextlib.contextmanager
def rounded_cast_once(policy):
    """A bf16-rounded copy on every trained parameter for the block, read
    by each use as ``bf16_grad_accum``'s bf16 copy is on the card."""
    params = [p for p in policy.parameters() if p.requires_grad]
    for p in params:
        p._pass_cast = p.to(torch.bfloat16).float()
    try:
        yield
    finally:
        for p in params:
            del p._pass_cast


def remat_grads(world, remat, run, **kw):
    agent = port_agent(world, seed=2, remat=remat, max_action=17,
                       bf16_grad_accum=True, **kw)
    agent._cast_params_once = lambda: rounded_cast_once(agent.policy)
    agent.zero_grad()
    run(agent)
    agent.flush_replays()
    assert np.isfinite([float(x) for x in agent.losses]).all()
    return port_grads(agent)


SITES = {
    "fused": (dict(), lambda a: a.device_rollout(
        train_ml=0.2, train_rl=True, feedback="sample")),
    "teacher_replay": (dict(), lambda a: a.device_rollout(
        train_ml=1.0, train_rl=False, feedback="teacher")),
    "host_replay": (dict(device_rollout="never"), lambda a: a.rollout(
        train_ml=0.2, train_rl=True, feedback="sample")),
    "stream": (dict(rollout_mode="stream", stream_steps=17, stream_pool=3),
               lambda a: a.device_rollout_stream(0.2, feedback="sample")),
}


@pytest.mark.parametrize("site", SITES)
def test_remat_modes_are_grad_exact(world, site):
    """Dropout on: every remat mode's gradients equal never's."""
    kw, run = SITES[site]
    base = remat_grads(world, "never", run, **kw)
    for mode in MODES:
        assert_grads_equal(remat_grads(world, mode, run, **kw), base,
                           REMAT_TOL)


def test_remat_recompute_sees_the_pass_copies(world):
    """The failure the block guards against: a backward outside the
    cast-once block recomputes from the parameters themselves, not from
    the pass's rounded copies, and its gradients move away from never's
    (so the test above would catch a pass that ran it there)."""
    kw, run = SITES["teacher_replay"]
    base = remat_grads(world, "never", run, **kw)
    agent = port_agent(world, seed=2, remat="percept", max_action=17, **kw)
    agent.zero_grad()
    dev, ep, instr, valid, seq_len, gen, noise = \
        agent._device_rollout_args(None)
    with rounded_cast_once(agent.policy):
        stacked, final, rewards, masks, ended = agent._teacher_trajectory(
            dev, ep, agent._teacher_len())
        loss, _ = agent._replay_loss(instr, valid, seq_len, stacked, final,
                                     rewards, masks, ended, gen, noise, 1.0,
                                     0.0, 0.0)
    loss.backward()
    got = port_grads(agent)
    assert any(not np.allclose(got[k], base[k], **REMAT_TOL) for k in got)
