"""The port's data parallel against the JAX package's 2-device mesh.

Two gloo ranks on the CPU, spawned from this file with
``torch.multiprocessing`` (``tests/_torch_dp_worker.py``, one spawn per
configuration, its cases sharing it), each write their arrays to
``tmp_path``; the JAX side runs here on the conftest's virtual devices
with ``make_mesh(n_data=2, devices=jax.devices()[:2])``.  The weights are
the JAX agent's, carried by ``policy_state_dict_from_jax``; every dropout
is 0 and both sides get the same env-drop noise.  At
tests/test_torch_train.py's tolerances (loss rtol 1e-4; gradients rtol
2e-4, atol 1e-6):

- the episodic teacher + fused argmax pair of a batch of 4 (2 rows a
  rank): each pass's loss, steps and A2C total, and the gradients that
  ``optim_step`` applies after its all-reduce, equal the JAX mesh agent's;
  the parameters after the step equal JAX's within the RMSprop step's
  rounding (atol 1e-5: a gradient that is rounding noise on both sides
  moves its weight by up to lr = 1e-4 times a ratio that noise decides);
- the host act / replay pair at D = 2 equals the port's single-device
  pair (the host rollout is held against JAX by
  tests/test_torch_host_rollout.py); only rank 0 writes a checkpoint, and
  a ``load`` gives every rank rank 0's weights; argmax ``test()`` holds
  every episode on both ranks, equal to one device's;
- recorded stream windows with argmax feedback: each rank's slot-time
  grids (``rec_action`` / ``rec_node`` / ``rec_take`` / ``rec_uid`` ...)
  equal its block of the JAX ``_stream_shard_map`` window's, the (D, 2)
  counters equal on both ranks, each uid taken once across the ranks, the
  losses and the summed gradients equal; the streamed ``test()`` equals
  one device's;
- two ``Pretrainer.train_step``s at D = 2 equal JAX's on a 2-device mesh
  (tests/test_torch_pretrain.py's limits), and only rank 0 saves;
- a batch the ranks do not divide (3 at D = 2): every rank runs all of it
  and steps without an all-reduce, equal to one device (the device pair
  at the tolerances above; two pretraining steps with dropout on, equal
  to the bit), as GSPMD's replication keeps the JAX mesh's math;
- the launcher's environment variables, and a one-rank gloo job in this
  process.
"""

import dataclasses
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_dp_worker
import dasa_tpu.models.policy as jax_policy
import dasa_tpu.pretrain.trainer as jax_trainer
from dasa_tpu.agents import Seq2SeqAgent as JaxAgent
from dasa_tpu.config import Config as JaxConfig
from dasa_tpu.data.features import FeatureDB as JaxFeatureDB
from dasa_tpu.env import R2REnv as JaxEnv
from dasa_tpu.parallel import make_mesh as jax_make_mesh
import dasa_tpu_torch.models.policy as port_policy
import dasa_tpu_torch.pretrain.trainer as port_trainer
from dasa_tpu_torch.agents import Seq2SeqAgent
from dasa_tpu_torch.config import Config
from dasa_tpu_torch.data.datasets import (
    expand_instructions,
    load_datasets,
    make_synthetic_task,
)
from dasa_tpu_torch.data.features import FeatureDB
from dasa_tpu_torch.env import R2REnv
from dasa_tpu_torch.parallel import distributed, make_mesh
from dasa_tpu_torch.pretrain import PretrainBatcher, generate_pretrain_records
from dasa_tpu_torch.testing import torch_threads, write_synthetic_connectivity
from dasa_tpu_torch.utils import Tokenizer, build_vocab, write_vocab
from dasa_tpu_torch.utils.jax_params import (
    policy_state_dict_from_jax,
    pretrain_state_dict_from_jax,
)

SCANS = ("synthA", "synthB")
DIM = 24
L = 24
B = 4          # two rows a rank
ODD_B = 3      # a batch the two ranks do not divide
CFG = dict(
    rnn_dim=32, wemb=16, aemb=8, critic_dim=32, angle_feat_size=8,
    feature_size=DIM, max_input=L, max_candidates=16, max_action=5,
    batch_size=B, d_enc_hidden_size=16, d_hidden_size=32, d_vl_layers=1,
    d_la_layers=1, encoder_type="Dic", include_vision=True,
    adain_type="channel", ab_type="a", a_type="sigmoid", use_shift=True,
    shift_kernel_size=5, consistent_drop=True, depth_drop=True,
    featdropout=0.3, ml_weight=0.2, use_pallas="always", dropout=0.0,
    d_dropout_ratio=0.0, d_hidden_dropout_prob=0.0, d_attn_dropout_prob=0.0)
# the stream windows: W = 4 slots a rank, S = 4 steps, a pool of 2 a rank
STREAM = dict(rollout_mode="stream", stream_steps=4, stream_pool=3,
              featdropout=0.0)
WINDOWS = 4
STREAM_LOGS = ("loss", "ml_loss", "rl_loss", "critic_loss", "entropy",
               "total")
NARROW = dict(hidden_size=64, num_attention_heads=2, intermediate_size=128)
LOSS_RTOL = 1e-4
GRAD_TOL = dict(rtol=2e-4, atol=1e-6)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
# pretraining (tests/test_torch_pretrain.py's narrow BERT, dropout 0)
PT_L = 20
PT_NARROW = dict(hidden_size=64, num_attention_heads=4,
                 intermediate_size=128, hidden_dropout_prob=0.0,
                 attention_probs_dropout_prob=0.0)
PT_DROPOUT = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
PT_CFG = dict(feature_size=DIM, angle_feat_size=8, max_input=PT_L,
              batch_size=B, d_la_layers=1, d_vl_layers=1, encoder_type="Dic",
              include_vision=True, d_hidden_dropout_prob=0.0,
              d_attn_dropout_prob=0.0, max_action=8, lr=1e-3, warm_steps=1,
              iters=10, weight_decay=0.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def narrow_bert():
    """The BERT 64 wide on both sides (tests/test_torch_train.py)."""
    with pytest.MonkeyPatch.context() as mp_:
        for mod in (jax_policy, port_policy):
            base = mod.bert_config_from
            mp_.setattr(mod, "bert_config_from",
                        lambda cfg, base=base: dataclasses.replace(
                            base(cfg), **NARROW))
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_parallel_world")
    conn, data = str(root / "connectivity"), str(root / "task")
    write_synthetic_connectivity(conn, SCANS, n_nodes=24, seed=0)
    make_synthetic_task(data, SCANS[:1], SCANS[1:], n_train=6, n_val=2,
                        connectivity_dir=conn)
    vocab = build_vocab(load_datasets(["train"], data), min_count=1)
    write_vocab(vocab, str(root / "vocab.txt"))
    return dict(conn=conn, data=data, vocab=str(root / "vocab.txt"),
                tok=Tokenizer(vocab, encoding_length=L))


def items_of(world, split="train", length=L):
    tok = Tokenizer(world["tok"].vocab, encoding_length=length) \
        if length != L else world["tok"]
    return expand_instructions(load_datasets([split], world["data"]), tok,
                               max_input=length)


def jax_agent(world, **kw):
    conn = world["conn"]
    jfeat = JaxFeatureDB.synthetic(SCANS, conn, dim=DIM)
    jdepth = JaxFeatureDB.synthetic(SCANS, conn, dim=DIM, salt=7)
    jenv = JaxEnv(jfeat, items_of(world), batch_size=B, connectivity_dir=conn,
                  max_candidates=16, max_input=L, depth_db=jdepth)
    return JaxAgent(JaxConfig(**{**CFG, **kw}, connectivity_dir=conn), jenv,
                    jfeat, depth_db=jdepth, vocab_size=len(world["tok"]),
                    rng_seed=11,
                    mesh=jax_make_mesh(n_data=2, devices=jax.devices()[:2]))


def port_agent(world, split="train", **kw):
    """One device's agent over ``split``, the same env as a rank's."""
    conn = world["conn"]
    feat = FeatureDB.synthetic(SCANS, conn, dim=DIM)
    depth = FeatureDB.synthetic(SCANS, conn, dim=DIM, salt=7)
    env = R2REnv(feat, items_of(world, split),
                 batch_size=kw.get("batch_size", B), connectivity_dir=conn,
                 max_candidates=16, max_input=L, depth_db=depth, name=split)
    cfg = Config(**{**CFG, **kw}, connectivity_dir=conn,
                 data_dir=world["data"])
    return Seq2SeqAgent(cfg, env, feat, depth_db=depth, device="cpu")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(kind: str, out, world, **spec):
    """Start ``kind`` on two gloo ranks; the returned function waits for
    them and gives their outputs, by rank (the JAX side runs meanwhile)."""
    spec = dict(kind=kind, out=str(out), port=free_port(), scans=SCANS,
                dim=DIM, conn=world["conn"], data=world["data"],
                vocab=world["vocab"], **spec)
    ctx = mp.start_processes(_torch_dp_worker.run, args=(spec,), nprocs=2,
                             start_method="spawn", join=False)

    def results() -> list:
        while not ctx.join():
            pass
        return [torch.load(os.path.join(out, f"rank{r}.pt"),
                           weights_only=False) for r in range(2)]

    return results


def save_weights(params, path) -> str:
    torch.save({k: torch.as_tensor(v) for k, v in policy_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)).items()}, path)
    return str(path)


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


def assert_state_close(got: dict, want: dict, **tol):
    assert got.keys() == want.keys()
    for name, val in want.items():
        np.testing.assert_allclose(np.asarray(got[name]), np.asarray(val),
                                   err_msg=name, **tol)


def assert_grads_match(got: dict, jax_grads):
    ref = policy_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_grads))
    assert_state_close({k: v.numpy() for k, v in got.items()}, ref,
                       **GRAD_TOL)


# ---------------------------------------------------------------------
# the episodic passes, the host pair, save / load and test()
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def episodic(world, narrow_bert, tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_episodic")
    jagent = jax_agent(world)
    weights = save_weights(jagent.params, out / "weights.pt")
    noise = noise_vector()
    ranks = spawn("episodic", out, world, cfg=CFG, narrow=NARROW,
                  weights=weights, noise=noise, odd_batch=ODD_B)
    g1, l1 = jax_pass(jagent, "teacher", 0.2, False, noise)
    g2, l2 = jax_pass(jagent, "argmax", 0.2, False, noise)
    jagent._grad_accum = jax.tree_util.tree_map(jnp.add, g1, g2)
    jagent.optim_step()
    # one device's host pair and its step, from the same weights
    host = port_agent(world, device_rollout="never")
    host.policy.load_state_dict(torch.load(weights))
    host.zero_grad()
    for feedback in ("teacher", "argmax"):
        host.rollout(train_ml=0.2, train_rl=True, feedback=feedback,
                     env_noise=torch.as_tensor(noise))
    host_grads = {n: p.grad.clone() for n, p in host.policy.named_parameters()
                  if p.grad is not None}
    host.optim_step()
    # one device's device pair at the batch the ranks do not divide
    odd = port_agent(world, batch_size=ODD_B)
    odd.policy.load_state_dict(torch.load(weights))
    odd.zero_grad()
    for feedback, train_rl in (("teacher", False), ("argmax", True)):
        odd.device_rollout(train_ml=0.2, train_rl=train_rl, feedback=feedback,
                           env_noise=torch.as_tensor(noise))
    odd_grads = {n: p.grad.clone() for n, p in odd.policy.named_parameters()
                 if p.grad is not None}
    odd.optim_step()
    ranks = ranks()
    # one device's argmax test() at rank 0's stepped weights
    single = port_agent(world, "val_unseen")
    single.policy.load_state_dict(ranks[0]["device"]["params"])
    test = {r["instr_id"]: r["trajectory"]
            for r in single.test(feedback="argmax")}
    return dict(out=out, ranks=ranks, jax_logs=(l1, l2),
                jax_grads=jax.tree_util.tree_map(jnp.add, g1, g2),
                jax_params=policy_state_dict_from_jax(
                    jax.tree_util.tree_map(np.asarray, jagent.params)),
                host=(host.losses, host_grads, host.policy.state_dict()),
                odd=(odd.losses, odd_grads, odd.policy.state_dict()),
                test=test)


def test_episodic_pair_matches_jax_mesh(episodic):
    l1, l2 = episodic["jax_logs"]
    for rank in episodic["ranks"]:
        run = rank["device"]
        np.testing.assert_allclose(run["losses"],
                                   [l1["loss"], l2["loss"]],
                                   rtol=LOSS_RTOL)
        assert run["env_steps"] == [int(l1["env_steps"]),
                                    int(l2["env_steps"])]
        assert run["total"][-1] == float(l2["total"])
        assert_grads_match(run["grads"], episodic["jax_grads"])


def test_episodic_update_matches_jax_mesh(episodic):
    r0, r1 = (r["device"]["params"] for r in episodic["ranks"])
    for name in r0:
        assert torch.equal(r0[name], r1[name]), name
    assert_state_close({k: v.numpy() for k, v in r0.items()},
                       episodic["jax_params"], **STEP_TOL)


def test_host_pair_matches_one_device(episodic):
    assert_pair_matches(episodic, "host")


def test_odd_batch_matches_one_device(episodic):
    """Every rank runs the whole batch of 3 and steps as one device."""
    assert_pair_matches(episodic, "odd")


def assert_pair_matches(episodic, mode):
    """Each rank's ``mode`` pair equals one device's: losses, the
    gradients applied and the stepped parameters."""
    losses, grads, params = episodic[mode]
    for rank in episodic["ranks"]:
        run = rank[mode]
        np.testing.assert_allclose(run["losses"], [float(x) for x in losses],
                                   rtol=LOSS_RTOL)
        for name, grad in grads.items():
            np.testing.assert_allclose(run["grads"][name].numpy(),
                                       grad.numpy(), err_msg=name,
                                       **GRAD_TOL)
        assert_state_close({k: v.numpy() for k, v in run["params"].items()},
                           {k: v.numpy() for k, v in params.items()},
                           **STEP_TOL)


def test_rank0_saves_and_load_replicates(episodic):
    out = episodic["out"]
    assert os.path.exists(out / "ckpt_rank0")
    assert not os.path.exists(out / "ckpt_rank1")
    saved = torch.load(out / "ckpt_rank0", weights_only=False)
    r0 = episodic["ranks"][0]
    for rank in episodic["ranks"]:
        for name, val in rank["loaded"].items():
            assert torch.equal(val, r0["device"]["params"][name]), name
    assert saved["decoder"]["epoch"] == 1


def test_argmax_test_gathers_every_rank(episodic):
    for rank in episodic["ranks"]:
        assert rank["test"] == episodic["test"]


# ---------------------------------------------------------------------
# the stream window
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def stream(world, narrow_bert, tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_stream")
    jagent = jax_agent(world, **STREAM)
    weights = save_weights(jagent.params, out / "weights.pt")
    ranks = spawn("stream", out, world, cfg={**CFG, **STREAM}, narrow=NARROW,
                  weights=weights, windows=WINDOWS, log_keys=STREAM_LOGS)
    jst = jagent._stream_host()
    windows = []
    for _ in range(WINDOWS):
        jagent.zero_grad()
        jagent.device_rollout_stream(0.2, feedback="argmax", record=True)
        windows.append({
            "rec": jst.records[-1],
            "flow": {k: np.asarray(v) for k, v in
                     jst.inflight[-1][1].items()},
            "logs": {k: float(jagent.logs[k][-1]) if k != "loss" else
                     float(jagent.losses[-1]) for k in STREAM_LOGS},
            "grads": jagent._grad_accum})
    single = port_agent(world, "val_unseen", **STREAM)
    single.policy.load_state_dict(torch.load(weights))
    test = {r["instr_id"]: r["trajectory"]
            for r in single.test(feedback="argmax")}
    return dict(ranks=ranks(), jax=windows, test=test,
                jax_geom=(jst.geom.B, jst.geom.W, jst.geom.S, jst.geom.E,
                          jst.geom.D))


def test_stream_windows_match_jax_shards(stream):
    B_, W, S, E, D = stream["jax_geom"]
    assert stream["ranks"][0]["geom"] == (B_, W, S, E, D) == (2, 4, 4, 2, 2)
    for d, rank in enumerate(stream["ranks"]):
        for w, (got, want) in enumerate(zip(rank["windows"], stream["jax"])):
            for key, ref in want["rec"].items():
                ref = np.asarray(ref)
                block = ref[..., d * W:(d + 1) * W]
                np.testing.assert_array_equal(
                    got["rec"][key], block, err_msg=f"rank {d} window {w} {key}")
            for key, ref in want["flow"].items():
                np.testing.assert_array_equal(got["flow"][key], ref,
                                              err_msg=f"window {w} {key}")
            for key in STREAM_LOGS:
                np.testing.assert_allclose(got["logs"][key],
                                           want["logs"][key], rtol=LOSS_RTOL,
                                           err_msg=f"window {w} {key}")
        assert_grads_match(rank["windows"][0]["grads"],
                           stream["jax"][0]["grads"])


def test_stream_takes_each_episode_once(stream):
    uids = []
    for rank in stream["ranks"]:
        for window in rank["windows"]:
            rec = window["rec"]
            uids += rec["rec_uid"][rec["rec_take"]
                                   & (rec["rec_uid"] >= 0)].tolist()
    assert len(uids) == len(set(uids)) > 0
    # the pool clamps admissions somewhere: a re-queue happened
    clamped = sum(n - int(w["flow"]["admitted"][d, h])
                  for w in stream["ranks"][0]["windows"]
                  for h, row in enumerate(w["sent"])
                  for d, n in enumerate(row))
    assert clamped >= 0


def test_streamed_test_gathers_every_rank(stream):
    for rank in stream["ranks"]:
        assert rank["test"] == stream["test"]


# ---------------------------------------------------------------------
# pretraining
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def pretrain_run(world, tmp_path_factory):
    """Two JAX mesh steps, the ranks' runs, and one device's two steps at
    the batch the ranks do not divide, dropout on."""
    out = tmp_path_factory.mktemp("dp_pretrain")
    with pytest.MonkeyPatch.context() as mp_:
        narrow = {mod: mod.bert_config_from
                  for mod in (jax_trainer, port_trainer)}
        mp_.setattr(jax_trainer, "bert_config_from",
                    lambda cfg: dataclasses.replace(
                        narrow[jax_trainer](cfg), **PT_NARROW))
        yield run_pretrain_pair(world, out, mp_, narrow[port_trainer])


def run_pretrain_pair(world, tmp_path, mp_, port_config_from):
    conn = world["conn"]
    tok = Tokenizer(world["tok"].vocab, encoding_length=PT_L)
    tok.add_word("<MASK>")
    env = R2REnv(FeatureDB.synthetic(SCANS, conn, dim=DIM),
                 expand_instructions(load_datasets(["train"], world["data"]),
                                     tok, max_input=PT_L),
                 batch_size=B, connectivity_dir=conn, max_input=PT_L,
                 backend="python")
    records = generate_pretrain_records(env, max_steps=8)
    batches = list(PretrainBatcher(records, B, len(tok),
                                   tok.word_to_index["<MASK>"],
                                   seed=2).epoch())[:2]
    torch.save(batches, tmp_path / "batches.pt")
    jpt = jax_trainer.Pretrainer(
        JaxConfig(**PT_CFG), JaxFeatureDB.synthetic(SCANS, conn, dim=DIM),
        len(tok), mesh=jax_make_mesh(n_data=2, devices=jax.devices()[:2]))
    state = pretrain_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jpt.params))
    torch.save({k: torch.as_tensor(v) for k, v in state.items()},
               tmp_path / "weights.pt")
    ranks = spawn("pretrain", tmp_path, world, cfg=PT_CFG, narrow=PT_NARROW,
                  weights=str(tmp_path / "weights.pt"),
                  batches=str(tmp_path / "batches.pt"), vocab_size=len(tok),
                  odd_batch=ODD_B, odd_dropout=PT_DROPOUT)
    rng = jax.random.PRNGKey(0)
    jsteps = [jpt.train_step(b, jax.random.fold_in(rng, i))
              for i, b in enumerate(batches)]
    ref = pretrain_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jpt.params))
    # one device at the batch of 3, the BERT narrowed with dropout on
    mp_.setattr(port_trainer, "bert_config_from",
                lambda cfg: dataclasses.replace(port_config_from(cfg),
                                                **{**PT_NARROW,
                                                   **PT_DROPOUT}))
    one = port_trainer.Pretrainer(Config(**{**PT_CFG, "batch_size": ODD_B}),
                                  FeatureDB.synthetic(SCANS, conn, dim=DIM),
                                  len(tok), device="cpu")
    one.model.load_state_dict(torch.load(tmp_path / "weights.pt"))
    odd = [one.train_step({k: np.asarray(v)[:ODD_B] for k, v in b.items()})
           for b in batches]
    return dict(out=tmp_path, ranks=ranks(), jax_steps=jsteps, ref=ref,
                state=state, odd=(odd, one.model.state_dict()))


def test_pretrain_steps_match_jax_mesh(pretrain_run):
    tmp_path, state, ref = (pretrain_run[k] for k in ("out", "state", "ref"))
    assert os.path.exists(tmp_path / "pretrain_rank0")
    assert not os.path.exists(tmp_path / "pretrain_rank1")
    for rank in pretrain_run["ranks"]:
        for (loss, aux), (jloss, jaux) in zip(rank["steps"],
                                              pretrain_run["jax_steps"]):
            np.testing.assert_allclose(loss, jloss, rtol=1e-4, atol=1e-5)
            assert aux.keys() == jaux.keys()
            for key in aux:
                np.testing.assert_allclose(aux[key], jaux[key], atol=1e-6,
                                           err_msg=key)
        moved = 0
        for key, val in ref.items():
            got = rank["params"][key].numpy()
            if key.endswith(".key.bias"):
                # rounding noise on both sides, Adam-scaled: held to the
                # step's rate (tests/test_torch_pretrain.py)
                assert np.abs(got - state[key]).max() <= 2 * PT_CFG["lr"]
                continue
            np.testing.assert_allclose(got, val, rtol=1e-4, atol=1e-6,
                                       err_msg=key)
            moved += not np.array_equal(got, state[key])
        assert moved > len(ref) // 2


def test_pretrain_odd_batch_matches_one_device(pretrain_run):
    """Every rank steps the whole batch of 3, drawing one device's
    dropout masks: its losses and weights equal one device's to the bit."""
    steps, params = pretrain_run["odd"]
    moved = 0
    for rank in pretrain_run["ranks"]:
        assert rank["odd_steps"] == steps
        for key, val in params.items():
            assert torch.equal(rank["odd_params"][key], val), key
            moved += not np.array_equal(val.numpy(),
                                        pretrain_run["state"][key])
    assert moved > 0


# ---------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------
LAUNCH_VARS = (distributed.WORLD_VARS + distributed.RANK_VARS
               + distributed.LOCAL_RANK_VARS + distributed.LOCAL_SIZE_VARS
               + ("COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT"))


@pytest.mark.parametrize("env,want", [
    ({}, (None, None, None, None, None)),
    ({"COORDINATOR_ADDRESS": "h:1", "NUM_PROCESSES": "4", "PROCESS_ID": "2"},
     (4, 2, "h:1", None, None)),
    ({"OMPI_COMM_WORLD_SIZE": "8", "OMPI_COMM_WORLD_RANK": "5",
      "OMPI_COMM_WORLD_LOCAL_RANK": "1", "OMPI_COMM_WORLD_LOCAL_SIZE": "4",
      "COORDINATOR_ADDRESS": "h:2"}, (8, 5, "h:2", 1, 4)),
    ({"SLURM_NTASKS": "2", "SLURM_PROCID": "1", "SLURM_LOCALID": "0"},
     (2, 1, None, 0, None)),
    ({"WORLD_SIZE": "2", "RANK": "1", "LOCAL_RANK": "1",
      "LOCAL_WORLD_SIZE": "2", "MASTER_ADDR": "m", "MASTER_PORT": "7"},
     (2, 1, "m:7", 1, 2)),
])
def test_launcher_variables(monkeypatch, env, want):
    for name in LAUNCH_VARS:
        monkeypatch.delenv(name, raising=False)
    for name, val in env.items():
        monkeypatch.setenv(name, val)
    assert distributed.launch_config() == want


def test_one_rank_jobs(world, monkeypatch, capsys):
    """Without launcher variables: no process group, a one-rank mesh, and
    ``make_agent`` takes ``data_parallel``.  With a coordinator and one
    process: a one-rank gloo job, its collectives the identity."""
    from dasa_tpu_torch.train.trainer import World, make_agent

    for name in LAUNCH_VARS:
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize() is None
    assert distributed.world_size() == 1 and distributed.is_primary()
    cfg = Config(**{**CFG, "batch_size": 2}, data_parallel=True,
                 connectivity_dir=world["conn"], data_dir=world["data"],
                 vocab_path=world["vocab"])
    agent = make_agent(cfg, World(cfg), device="cpu")
    assert agent.mesh is not None and agent.mesh.n_data == 1
    with pytest.raises(ValueError, match="n_data 2"):
        make_mesh(n_data=2)
    monkeypatch.setenv("COORDINATOR_ADDRESS", f"localhost:{free_port()}")
    monkeypatch.setenv("NUM_PROCESSES", "1")
    monkeypatch.setenv("PROCESS_ID", "0")
    try:
        assert distributed.initialize() == "gloo"
        assert "backend gloo" in capsys.readouterr().out
        mesh = make_mesh()
        assert (mesh.n_data, mesh.rank) == (1, 0)
        x = torch.arange(4.0)
        assert torch.equal(mesh.allsum(x), x)
        assert torch.equal(mesh.all_gather(x[None]), x[None])
        assert mesh.shard_batch({"a": np.arange(4)})["a"].tolist() == [0, 1,
                                                                      2, 3]
    finally:
        distributed.shutdown()
    assert distributed.world_size() == 1


@pytest.mark.parametrize("cards,local,asked,want", [
    (0, 2, None, "gloo"),          # the CPU
    (1, 1, None, "nccl"),
    (1, None, None, "nccl"),       # no local size given
    (4, 2, None, "nccl"),
    (1, 2, "gloo", "gloo"),        # asked for: two ranks share the card
    (1, 2, None, "raise"),         # more ranks on the host than cards
])
def test_backend_choice(monkeypatch, cards, local, asked, want):
    """NCCL on a machine with cards, a card a rank; gloo on the CPU or when
    asked for; never gloo by itself beside a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if want == "raise":
        with pytest.raises(RuntimeError, match="backend='gloo'"):
            distributed.choose_backend(local, asked)
    else:
        assert distributed.choose_backend(local, asked) == want
