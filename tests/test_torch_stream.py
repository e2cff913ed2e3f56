"""The PyTorch port's stream regime against the JAX package.

On the synthetic 2-scan world of tests/test_torch_train.py, with its
tiny Dic / channel-AdaIN / shift-5 listener in f32 on the CPU and the
weights carried by ``policy_state_dict_from_jax``:

- ``stream_returns`` equals the JAX function on seeded random grids;
- with every dropout at 0, argmax feedback and ``featdropout=0`` under
  ``consistent_drop`` (the refill noise path runs and draws all ones in
  both frameworks), the port's windows equal
  ``JaxAgent.device_rollout_stream(record=True)``: the slot-time grids
  and the flow counters exactly, the losses within ``LOSS_RTOL`` and the
  first window's gradients within ``GRAD_TOL`` (tests/test_torch_train.py's
  tolerances); a pool of 3 makes admit clamps, re-queues and starvation
  happen;
- the streamed ``test()`` equals the port's episodic ``test()`` and the
  JAX package's streamed ``test()``;
- the data ledger, the sqrt lr rule, the org/aug carries, the CLI, a
  starved window and a pool larger than the dataset.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasa_tpu.agents import Seq2SeqAgent as JaxAgent
from dasa_tpu.agents.stream import stream_returns as jax_stream_returns
from dasa_tpu.config import Config as JaxConfig
from dasa_tpu.data.features import FeatureDB as JaxFeatureDB
from dasa_tpu.env import R2REnv as JaxEnv
from dasa_tpu_torch.agents import Seq2SeqAgent
from dasa_tpu_torch.agents.stream import stream_returns
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
# tests/test_torch_train.py's widths, streamed: W = 4 slots, S = 6 steps
CFG = dict(
    rnn_dim=32, wemb=16, aemb=8, critic_dim=32, angle_feat_size=8,
    feature_size=DIM, max_input=L, max_candidates=16, max_action=5,
    batch_size=2, d_enc_hidden_size=16, d_hidden_size=32, d_vl_layers=1,
    d_la_layers=1, encoder_type="Dic", include_vision=True,
    adain_type="channel", ab_type="a", a_type="sigmoid", use_shift=True,
    shift_kernel_size=5, consistent_drop=True, depth_drop=True,
    featdropout=0.3, ml_weight=0.2, rollout_mode="stream", stream_steps=6,
    stream_pool=3)
NO_DROPOUT = dict(dropout=0.0, featdropout=0.0, d_dropout_ratio=0.0,
                  d_hidden_dropout_prob=0.0, d_attn_dropout_prob=0.0)
LOSS_RTOL = 1e-4
GRAD_TOL = dict(rtol=2e-4, atol=1e-6)
# 5 windows of 4 steps: episodes cross window edges, and the pool of 3
# clamps admissions (windows 3 and 4)
WINDOWS = 5
LOSS_KEYS = ("ml_loss", "rl_loss", "critic_loss", "entropy", "total")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_stream_world")
    conn, data = str(root / "connectivity"), str(root / "task")
    write_synthetic_connectivity(conn, SCANS, n_nodes=24, seed=0)
    make_synthetic_task(data, SCANS[:1], SCANS[1:], n_train=6, n_val=2,
                        connectivity_dir=conn)
    vocab = build_vocab(load_datasets(["train"], data), min_count=1)
    return conn, data, Tokenizer(vocab, encoding_length=L)


def items_of(world, split="train"):
    _conn, data, tok = world
    return expand_instructions(load_datasets([split], data), tok,
                               max_input=L)


def port_agent(world, split="train", seed=0, **kw):
    conn, data, _tok = world
    cfg = Config(**{**CFG, **kw}, connectivity_dir=conn, data_dir=data)
    feat = FeatureDB.synthetic(SCANS, conn, dim=DIM)
    depth = FeatureDB.synthetic(SCANS, conn, dim=DIM, salt=7)
    env = R2REnv(feat, items_of(world, split), batch_size=2,
                 connectivity_dir=conn, max_candidates=16, max_input=L,
                 depth_db=depth)
    return Seq2SeqAgent(cfg, env, feat, depth_db=depth, rng_seed=seed,
                        device="cpu")


def jax_agent(world, split="train", **kw):
    conn, _data, tok = world
    jfeat = JaxFeatureDB.synthetic(SCANS, conn, dim=DIM)
    jdepth = JaxFeatureDB.synthetic(SCANS, conn, dim=DIM, salt=7)
    jenv = JaxEnv(jfeat, items_of(world, split), batch_size=2,
                  connectivity_dir=conn, max_candidates=16, max_input=L,
                  depth_db=jdepth)
    return JaxAgent(JaxConfig(**{**CFG, **kw}, connectivity_dir=conn), jenv,
                    jfeat, depth_db=jdepth, vocab_size=len(tok), rng_seed=11)


def make_pair(world, split="train", **kw):
    """JAX and port agents over one split, the same weights."""
    jagent = jax_agent(world, split, **kw)
    agent = port_agent(world, split, **kw)
    agent.load_jax_params(jax.tree_util.tree_map(np.asarray, jagent.params))
    return jagent, agent


def port_grads(agent):
    return {name: (torch.zeros_like(p) if p.grad is None else p.grad)
            .numpy() for name, p in agent.policy.named_parameters()}


def taken_uids(records):
    uids = []
    for r in records:
        take = r["rec_take"] & (r["rec_uid"] >= 0)
        uids.extend(r["rec_uid"][take].tolist())
    return uids


def settle_all(agent, st):
    while st.inflight:
        agent._settle_stream_window(st)


# ---------------------------------------------------------------------
# (a) stream_returns
# ---------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(5))
def test_stream_returns_matches_jax(seed):
    """Random (S, W) grids with STOP, maxAction bookkeeping, dead and
    starved rows, and a window-edge bootstrap."""
    rng = np.random.default_rng(seed)
    S, W, gamma = 12, 6, 0.9
    rewards = rng.normal(size=(S, W)).astype(np.float32)
    values = rng.normal(size=(S, W)).astype(np.float32)
    real = rng.random((S, W)) < 0.7
    done = real & (rng.random((S, W)) < 0.3)
    trunc = ~real & (rng.random((S, W)) < 0.4)
    g_init = np.where(rng.random(W) < 0.5, rng.normal(size=W),
                      0.0).astype(np.float32)
    got = stream_returns(*(torch.from_numpy(x) for x in (
        rewards, values, done, trunc, real, g_init)), gamma)
    want = jax_stream_returns(*(jnp.asarray(x) for x in (
        rewards, values, done, trunc, real, g_init)), gamma)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------
# (b), (c) the windows against the JAX package
# ---------------------------------------------------------------------
@pytest.mark.parametrize("use_pallas", ["never", "always"])
def test_stream_windows_match_jax(world, use_pallas):
    jagent, agent = make_pair(world, **NO_DROPOUT, use_pallas=use_pallas,
                              stream_steps=4)
    jst, st = jagent._stream_host(), agent._stream_host()
    assert (st.geom.W, st.geom.S, st.geom.E) == (4, 4, 3)
    clamped = 0
    for window in range(WINDOWS):
        jagent.zero_grad()
        agent.zero_grad()
        jagent.device_rollout_stream(0.2, feedback="argmax", record=True)
        agent.device_rollout_stream(0.2, feedback="argmax", record=True)
        rec, jrec = st.records[-1], jst.records[-1]
        assert rec.keys() == jrec.keys()
        for key in jrec:
            np.testing.assert_array_equal(
                rec[key], jrec[key], err_msg=f"window {window} {key}")
        sent, flow = st.inflight[-1][0], st.inflight[-1][1].read()
        # the ledger is (D, 2) and the chunks sent[h][d], as in JAX
        clamped += sum(len(sent[h][0]) - int(flow["admitted"][0, h])
                       for h in (0, 1))
        for key, val in jst.inflight[-1][1].items():
            np.testing.assert_array_equal(flow[key], np.asarray(val),
                                          err_msg=f"window {window} {key}")
        np.testing.assert_allclose(float(agent.losses[-1]),
                                   float(jagent.losses[-1]), rtol=LOSS_RTOL)
        for key in LOSS_KEYS:
            np.testing.assert_allclose(
                float(agent.logs[key][-1]), float(jagent.logs[key][-1]),
                rtol=LOSS_RTOL, atol=1e-6, err_msg=f"window {window} {key}")
        assert int(agent._env_steps_log[-1]) == \
            int(jagent._env_steps_log[-1])
        if window == 0:
            ref = policy_state_dict_from_jax(
                jax.tree_util.tree_map(np.asarray, jagent._grad_accum))
            got = port_grads(agent)
            assert got.keys() == ref.keys()
            for name, grad in got.items():
                np.testing.assert_allclose(grad, ref[name], err_msg=name,
                                           **GRAD_TOL)
    # the small pool made every flow event happen: refills, admit clamps
    # (re-queued tails) and starved slots
    recs = st.records
    assert sum(r["rec_take"].sum() for r in recs) >= 12
    assert clamped > 0
    assert sum((~r["rec_real"] & ~r["rec_trunc"]).sum() for r in recs) > 0


def test_stream_consumes_each_episode_once(world):
    """Every take event names a staged episode, no episode is taken
    twice, the template is never taken, and the ledger reconciles:
    staged = taken + queued + pooled."""
    agent = port_agent(world, seed=1, stream_steps=7)
    st = agent._stream_host()
    for _ in range(8):
        agent.zero_grad()
        agent.device_rollout_stream(0.2, feedback="sample", record=True)
        agent.optim_step()
    uids = taken_uids(st.records)
    assert len(uids) == len(set(uids)) and len(uids) >= 20
    assert set(uids) <= set(st.staged)
    for r in st.records:
        assert not (r["rec_take"] & (r["rec_uid"] < 0)).any()
    settle_all(agent, st)
    fifo = {int(it["uid"]) for it in st.fifo}
    assert not set(uids) & fifo
    assert len(st.staged) == len(uids) + len(fifo) + int(
        st.leftover_settled.sum())
    assert np.isfinite([float(x) for x in agent.losses]).all()


# ---------------------------------------------------------------------
# (d) streamed evaluation
# ---------------------------------------------------------------------
def test_stream_eval_matches_episodic_and_jax(world):
    """The streamed test() at max_action=4 (heavy truncation under an
    untrained policy) gives the port's episodic test()'s trajectories and
    the JAX package's streamed ones, micro-steps included."""
    jagent, agent = make_pair(world, **NO_DROPOUT, max_action=4,
                              use_pallas="never")
    assert agent.use_stream_rollout() and jagent.use_stream_rollout()
    streamed = {r["instr_id"]: r["trajectory"] for r in agent.test()}
    jstreamed = {r["instr_id"]: r["trajectory"] for r in jagent.test()}
    agent.cfg = agent.cfg.replace(rollout_mode="episodic")
    episodic = {r["instr_id"]: r["trajectory"] for r in agent.test()}
    assert len(streamed) == agent.env.size()
    assert streamed.keys() == episodic.keys() == jstreamed.keys()
    for iid in episodic:
        assert streamed[iid] == episodic[iid], iid
        assert streamed[iid] == [tuple(x) for x in jstreamed[iid]], iid


# ---------------------------------------------------------------------
# (e) the sqrt lr rule
# ---------------------------------------------------------------------
def test_lr_scale_rule_sqrt_matches_jax(world):
    kw = dict(use_lr_scheduler=True, lr=1e-3, warm_steps=100,
              decay_start=400, decay_intervals=200, lr_scale_rule="sqrt")
    jagent, agent = make_pair(world, **kw)
    assert agent.applied_lr_schedule == pytest.approx(
        jagent.applied_lr_schedule)
    assert agent.applied_lr_schedule["lr"] > 1e-3
    opt = agent.optimizer
    assert opt.cfg.lr == agent.applied_lr_schedule["lr"]
    plain = port_agent(world, **{**kw, "lr_scale_rule": "none"})
    episodic = port_agent(world, **{**kw, "rollout_mode": "episodic"})
    assert plain.applied_lr_schedule["lr"] == 1e-3
    assert episodic.applied_lr_schedule["lr"] == 1e-3


# ---------------------------------------------------------------------
# (f) org/aug carries and the CLI
# ---------------------------------------------------------------------
def test_stream_env_swap_keeps_separate_carries(world):
    agent = port_agent(world)
    env_a = agent.env
    env_b = R2REnv(env_a.feature_db, items_of(world, "aug"), batch_size=2,
                   connectivity_dir=env_a.connectivity_dir,
                   max_candidates=16, max_input=L, depth_db=env_a.depth_db)
    for _ in range(2):
        agent.zero_grad()
        agent.env = env_a
        agent.accumulate_gradient("sample", ml_weight=0.2)
        agent.env = env_b
        agent.accumulate_gradient("sample", ml_weight=0.6)
        agent.optim_step()
    assert len(agent._stream_cache) == 2
    (ea, ha), (eb, hb) = agent._stream_cache.values()
    assert {id(ea), id(eb)} == {id(env_a), id(env_b)}
    assert ha is not hb and ha.carry is not hb.carry
    # each stream staged its own env's episodes
    for env, host in ((ea, ha), (eb, hb)):
        ids = {it["instr_id"] for it in env.data}
        assert {row["instr_id"] for row in host.staged.values()} <= ids
    assert agent.iter_count == 2
    assert np.isfinite([float(x) for x in agent.losses]).all()


def test_cli_trains_auglistener_under_stream(world, tmp_path, capsys):
    from dasa_tpu_torch.cli import main

    conn, data, _tok = world
    args = ["--device", "cpu", "--connectivity_dir", conn, "--data_dir",
            data, "--snap_dir", str(tmp_path / "snap"), "--log_dir",
            str(tmp_path / "log"), "--name", "cli", "--iters", "2",
            "--log_every", "2", "--val_every", "2", "--batchSize", "2",
            "--aug", "aug"]
    for key, val in CFG.items():
        if key != "batch_size":
            args += [f"--{key}", str(val)]
    main(args + ["--train", "auglistener"])
    assert (tmp_path / "snap" / "cli" / "state_dict" / "LAST_iter2").exists()
    out = capsys.readouterr().out
    assert "PROGRESS: 2/2" in out and "val_unseen" in out


@pytest.mark.parametrize("option", [
    dict(pred_back=True), dict(pred_pm=True, pm_type="v1"),
    dict(agent_type="advanced"), dict(agent_type="mt")])
def test_stream_aux_heads_raise(world, option):
    """The auxiliary loss terms' heads are ported (a stream agent with one
    of them was refused before): one window with the term gives a finite
    loss, and its log (back_loss, pm_loss or kl_loss) is finite and
    nonzero.  tests/test_torch_variants_stream.py holds the terms against
    the JAX package."""
    agent = port_agent(world, **option, stream_steps=4)
    agent.zero_grad()
    agent.device_rollout_stream(0.2, feedback="sample")
    key = ("back_loss" if "pred_back" in option else
           "kl_loss" if option.get("agent_type") == "mt" else "pm_loss")
    assert np.isfinite(float(agent.losses[-1]))
    value = float(agent.logs[key][-1])
    assert np.isfinite(value) and value != 0.0


# ---------------------------------------------------------------------
# (g) edge cases
# ---------------------------------------------------------------------
def test_stream_starved_window_is_finite(world):
    """No fresh episode, an empty pool and every slot dead: the loss and
    the gradients stay finite, no step runs, and every (step, slot) is
    starved."""
    agent = port_agent(world, stream_steps=4, stream_pool=4)
    st = agent._stream_host()
    geom = st.geom
    tpl = agent._stream_template_row()
    fresh = {f: torch.as_tensor(np.broadcast_to(
        tpl[f], (2, geom.E) + np.shape(tpl[f])).copy()) for f in tpl}
    loss, logs, _carry = agent._stream_window(
        "sample", True, geom, st.carry, fresh, torch.zeros(2,
                                                           dtype=torch.long),
        agent._rollout_generator(), 0.2, 1.0, 0.01)
    agent.zero_grad()
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    for name, grad in port_grads(agent).items():
        assert np.isfinite(grad).all(), name
    assert int(logs["env_steps"]) == 0
    for key in ("admitted", "consumed", "leftover"):
        assert int(logs[key].sum()) == 0, key
    assert int(logs["starved"]) == geom.S * geom.W


def test_stream_pool_larger_than_dataset(world):
    agent = port_agent(world, stream_pool=160)
    assert agent._stream_geom().E > agent.env.size()
    st = agent._stream_host()
    for _ in range(4):
        agent.zero_grad()
        agent.device_rollout_stream(0.2, feedback="sample", record=True)
        agent.optim_step()
        assert np.isfinite(float(agent.losses[-1]))
    settle_all(agent, st)
    uids = taken_uids(st.records)
    assert len(uids) == len(set(uids))
    fifo = {int(it["uid"]) for it in st.fifo}
    assert len(st.staged) == len(uids) + len(fifo) + int(
        st.leftover_settled.sum())
