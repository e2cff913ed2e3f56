"""selfTrain back-translation on the port's episodic device path against
the JAX package.

On a synthetic 2-scan world, the listener of tests/test_torch_train.py
(Dic / channel AdaIN / shift 5) and a speaker carry the same weights on
both sides, in f32 on the CPU, with dropout 0 and the same env-drop noise.
One selfTrain accumulate (a teacher-ML pass and a sampled A2C pass, each
on a batch the speaker relabels first) must give JAX's relabelled
instructions exactly, the teacher pass's loss and the loss of the sampled
episode (replayed by the JAX package, whose sampler draws differently)
at tests/test_device_env.py:142-145's tolerances, and the sum of both
passes' gradients; the speaker's parameters get no gradient and stay
where they were.  Under stream the same accumulate falls back to the host
act/replay pair, as the JAX agent does, and is held to the JAX fallback.
Then the README's ``--train auglistener --selfTrain`` command runs
through the CLI.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dasa_tpu.models.policy as jax_policy
from dasa_tpu.agents import Seq2SeqAgent as JaxAgent
from dasa_tpu.agents.speaker import SpeakerAgent as JaxSpeaker
from dasa_tpu.config import Config as JaxConfig
from dasa_tpu.data.features import FeatureDB as JaxFeatureDB
from dasa_tpu.env import R2REnv as JaxEnv
from dasa_tpu.utils import Tokenizer as JaxTokenizer
import dasa_tpu_torch.models.policy as port_policy
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
from dasa_tpu_torch.testing import torch_threads, write_synthetic_connectivity
from dasa_tpu_torch.utils import Tokenizer, build_vocab
from dasa_tpu_torch.utils.jax_params import policy_state_dict_from_jax

SCANS = ("synthA", "synthB")
DIM = 24
L = 24
B = 2
# tests/test_torch_train.py's listener, its speaker at the same rnn / wemb
CFG = dict(
    rnn_dim=32, wemb=16, aemb=8, critic_dim=32, angle_feat_size=8,
    feature_size=DIM, max_input=L, max_decode=L, max_candidates=16,
    max_action=5, batch_size=B, d_enc_hidden_size=16, d_hidden_size=32,
    d_vl_layers=1, d_la_layers=1, encoder_type="Dic", include_vision=True,
    adain_type="channel", ab_type="a", a_type="sigmoid", use_shift=True,
    shift_kernel_size=5, consistent_drop=True, depth_drop=True,
    featdropout=0.3, ml_weight=0.2, self_train=True)
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
    root = tmp_path_factory.mktemp("torch_selftrain_world")
    conn, data = str(root / "connectivity"), str(root / "task")
    write_synthetic_connectivity(conn, SCANS, n_nodes=24, seed=0)
    make_synthetic_task(data, SCANS[:1], SCANS[1:], n_train=6, n_val=2,
                        connectivity_dir=conn)
    vocab = build_vocab(load_datasets(["train"], data), min_count=1)
    return conn, data, vocab


def port_pair(world, **kw):
    """The port's listener and speaker over the aug split, on the CPU."""
    conn, data, vocab = world
    tok = Tokenizer(vocab, encoding_length=L)
    items = expand_instructions(load_datasets(["aug"], data), tok,
                                max_input=L)
    cfg = Config(**{**CFG, **kw}, connectivity_dir=conn, data_dir=data)
    feat = FeatureDB.synthetic(SCANS, conn, dim=DIM)
    depth = FeatureDB.synthetic(SCANS, conn, dim=DIM, salt=7)
    env = R2REnv(feat, items, batch_size=B, connectivity_dir=conn,
                 max_candidates=16, max_input=L, depth_db=depth,
                 backend="python")
    agent = Seq2SeqAgent(cfg, env, feat, depth_db=depth, device="cpu")
    speaker = SpeakerAgent(cfg, env, feat, vocab_size=len(tok), tok=tok,
                           device="cpu")
    return agent, speaker


def jax_pair(world, **kw):
    conn, data, vocab = world
    tok = JaxTokenizer(vocab, encoding_length=L)
    items = expand_instructions(load_datasets(["aug"], data),
                                Tokenizer(vocab, encoding_length=L),
                                max_input=L)
    cfg = JaxConfig(**CFG, **NO_DROPOUT, use_pallas="always",
                    connectivity_dir=conn, **kw)
    feat = JaxFeatureDB.synthetic(SCANS, conn, dim=DIM)
    depth = JaxFeatureDB.synthetic(SCANS, conn, dim=DIM, salt=7)
    env = JaxEnv(feat, items, batch_size=B, connectivity_dir=conn,
                 max_candidates=16, max_input=L, depth_db=depth,
                 backend="python")
    agent = JaxAgent(cfg, env, feat, depth_db=depth, vocab_size=len(tok),
                     rng_seed=11)
    speaker = JaxSpeaker(cfg, env, feat, vocab_size=len(tok), tok=tok,
                         rng_seed=5)
    return agent, speaker


def noise_vector(seed=3):
    keep = np.random.default_rng(seed).random(DIM) > 0.3
    return (keep / 0.7).astype(np.float32)


def port_grads(agent):
    return {name: (torch.zeros_like(p) if p.grad is None else p.grad)
            .numpy() for name, p in agent.policy.named_parameters()}


def jnp_tree(tree):
    return {k: jnp.asarray(v.numpy().astype(np.int32)
                           if v.dtype == torch.int64 else v.numpy())
            for k, v in tree.items()}


def test_selftrain_accumulate_matches_jax(world):
    jagent, jspeaker = jax_pair(world)
    agent, speaker = port_pair(world, **NO_DROPOUT, use_pallas="always")
    agent.load_jax_params(jax.tree_util.tree_map(np.asarray, jagent.params))
    speaker.load_jax_params(jax.tree_util.tree_map(np.asarray,
                                                   jspeaker.params))
    noise = noise_vector()
    # the JAX agent draws its env-drop noise here; both sides take this one
    jagent._noise_fn = lambda: (lambda _rng: jnp.asarray(noise))
    originals = {it["instr_id"]: np.asarray(it["instr_encoding"]).copy()
                 for it in agent.env.data}
    speaker_before = {k: v.clone()
                      for k, v in speaker.model.state_dict().items()}
    listener_before = {k: v.clone()
                       for k, v in agent.policy.state_dict().items()}
    replaced = 0

    # the teacher-ML pass on a relabelled batch
    args = list(jagent._device_rollout_args("teacher", 0.2, False,
                                            speaker=jspeaker))
    jgrads, jlogs = jagent._device_grad_fn("teacher", True)(
        jagent.params, jagent.tables, jagent._dev_env.arrays(), *args)
    agent.zero_grad()
    agent.device_rollout(train_ml=0.2, train_rl=False, feedback="teacher",
                         env_noise=torch.from_numpy(noise), speaker=speaker)
    np.testing.assert_array_equal(agent.env._static["instr"],
                                  np.asarray(args[4]))
    replaced += sum(not np.array_equal(it["instr_encoding"],
                                       originals[it["instr_id"]])
                    for it in agent.env.batch)
    np.testing.assert_allclose(float(agent.losses[-1]), float(jlogs["loss"]),
                               rtol=LOSS_RTOL)

    # the sampled A2C pass on the next relabelled batch; the JAX package
    # replays the episode the port sampled
    args = list(jagent._device_rollout_args("sample", None, True,
                                            speaker=jspeaker))
    record = {}
    agent.device_rollout(train_ml=None, train_rl=True, feedback="sample",
                         env_noise=torch.from_numpy(noise), speaker=speaker,
                         record=record)
    np.testing.assert_array_equal(record["instr"].numpy(),
                                  np.asarray(args[4]))
    replaced += sum(not np.array_equal(it["instr_encoding"],
                                       originals[it["instr_id"]])
                    for it in agent.env.batch)
    n_steps = record["rewards"].shape[0]
    rgrads, rlogs = jagent._grad_fn(True, n_steps)(
        jagent.params, jagent.tables, args[4], args[5], args[6],
        jnp_tree(record["stacked"]), jnp_tree(record["final_sobs"]),
        jnp.asarray(record["rewards"].numpy()),
        jnp.asarray(record["rl_masks"].numpy()),
        jnp.asarray(record["final_ended"].numpy()), jnp.zeros(B),
        jax.random.PRNGKey(0), jnp.asarray(noise), jnp.float32(0.0),
        jnp.float32(1.0), jnp.float32(0.01))
    np.testing.assert_allclose(float(agent.losses[-1]), float(rlogs["loss"]),
                               rtol=LOSS_RTOL)
    total = jax.tree_util.tree_map(lambda a, b: np.asarray(a) + np.asarray(b),
                                   jgrads, rgrads)
    ref = policy_state_dict_from_jax(total)
    got = port_grads(agent)
    assert got.keys() == ref.keys()
    for name, grad in got.items():
        np.testing.assert_allclose(grad, ref[name], err_msg=name, **GRAD_TOL)
    # the speaker's words replaced instructions; env.data kept its own
    assert replaced
    for item in agent.env.data:
        np.testing.assert_array_equal(item["instr_encoding"],
                                      originals[item["instr_id"]])

    # the speaker decodes under no_grad: no gradient, and the update moves
    # the listener only
    assert all(p.grad is None for p in speaker.model.parameters())
    agent.optim_step()
    for key, val in speaker.model.state_dict().items():
        torch.testing.assert_close(val, speaker_before[key], atol=0, rtol=0)
    moved = [k for k, v in agent.policy.state_dict().items()
             if not torch.equal(v, listener_before[k])]
    assert any(k.startswith("decoder.") for k in moved)


def capture_replays(agent):
    """Keep every replay that ``agent._run_replays`` runs."""
    run, kept = agent._run_replays, []

    def keep(replays):
        kept.extend(list(replays))
        return run(replays)

    agent._run_replays = keep
    return kept


def test_stream_selftrain_raises(world):
    """selfTrain under rollout_mode=stream raises nothing: as in the JAX
    agent (seq2seq.py:1924-1932), the accumulate falls back to the host
    act/replay pair, a teacher-ML rollout and a sampled A2C rollout, each
    on a relabelled batch.  Against the JAX fallback: the relabelled
    instructions and the teacher pass exactly; the JAX package replays
    the episode the port sampled; the sum of both passes' gradients."""
    jagent, jspeaker = jax_pair(world, rollout_mode="stream")
    agent, speaker = port_pair(world, **NO_DROPOUT, use_pallas="always",
                               rollout_mode="stream")
    assert agent.use_stream_rollout() and jagent.use_stream_rollout()
    agent.load_jax_params(jax.tree_util.tree_map(np.asarray, jagent.params))
    speaker.load_jax_params(jax.tree_util.tree_map(np.asarray,
                                                   jspeaker.params))
    noise = noise_vector()
    jagent._noise_fn = lambda: (lambda _rng: jnp.asarray(noise))
    agent._noise_fn = lambda _gen: torch.from_numpy(noise)
    jreplays, replays = capture_replays(jagent), capture_replays(agent)
    originals = {it["instr_id"]: np.asarray(it["instr_encoding"]).copy()
                 for it in agent.env.data}
    speaker_before = {k: v.clone()
                      for k, v in speaker.model.state_dict().items()}

    jagent.accumulate_gradient("sample", speaker=jspeaker)
    agent.zero_grad()
    agent.accumulate_gradient("sample", speaker=speaker)
    assert len(replays) == len(jreplays) == 2
    for rep, jrep in zip(replays, jreplays):
        np.testing.assert_array_equal(rep["instr"].numpy(),
                                      np.asarray(jrep["args"][0]))
    teacher = jreplays[0]["args"][3]
    for key, val in replays[0]["stacked"].items():
        np.testing.assert_array_equal(val, np.asarray(teacher[key]),
                                      err_msg=key)
    np.testing.assert_allclose(float(agent.losses[0]),
                               float(jagent.losses[0]), rtol=LOSS_RTOL)
    # the speaker's words replaced the batch's instructions
    assert any(not np.array_equal(it["instr_encoding"],
                                  originals[it["instr_id"]])
               for it in agent.env.batch)

    # the JAX teacher replay plus the JAX replay of the port's sample
    tgrads, _ = jagent._grad_fn(True, jreplays[0]["n_steps"])(
        jagent.params, jagent.tables,
        *jagent._put_replay_args(jreplays[0]["args"]))
    rep = replays[1]
    rgrads, rlogs = jagent._grad_fn(True, rep["rewards"].shape[0])(
        jagent.params, jagent.tables, jnp.asarray(rep["instr"].numpy(),
                                                  jnp.int32),
        jnp.asarray(rep["valid"].numpy()),
        jnp.asarray(rep["seq_len"].numpy(), jnp.int32),
        {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
         for k, v in rep["stacked"].items()},
        {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
         for k, v in rep["final_sobs"].items()},
        jnp.asarray(rep["rewards"]), jnp.asarray(rep["rl_masks"]),
        jnp.asarray(rep["final_ended"]), jnp.zeros(B),
        jax.random.PRNGKey(0), jnp.asarray(noise), jnp.float32(0.0),
        jnp.float32(1.0), jnp.float32(0.01))
    np.testing.assert_allclose(float(agent.losses[1]), float(rlogs["loss"]),
                               rtol=LOSS_RTOL)
    ref = policy_state_dict_from_jax(jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) + np.asarray(b), tgrads, rgrads))
    for name, grad in port_grads(agent).items():
        np.testing.assert_allclose(grad, ref[name], err_msg=name, **GRAD_TOL)
    assert all(p.grad is None for p in speaker.model.parameters())
    agent.optim_step()
    for key, val in speaker.model.state_dict().items():
        torch.testing.assert_close(val, speaker_before[key], atol=0, rtol=0)


def test_cli_runs_the_readme_selftrain_command(world, tmp_path, capsys):
    """``--train auglistener --accumulateGrad --selfTrain --aug aug
    --feedback sample`` with a speaker checkpoint written by the port."""
    from dasa_tpu_torch.cli import main
    from dasa_tpu_torch.train.trainer import World, make_speaker

    conn, data, _vocab = world
    cfg = Config(**CFG, aug="aug", connectivity_dir=conn, data_dir=data)
    ckpt = str(tmp_path / "speaker" / "best_val_unseen_bleu")
    make_speaker(cfg, World(cfg), device="cpu").save(0, ckpt)
    args = ["--device", "cpu", "--connectivity_dir", conn, "--data_dir",
            data, "--snap_dir", str(tmp_path / "snap"), "--log_dir",
            str(tmp_path / "log"), "--name", "st", "--iters", "2",
            "--log_every", "2", "--val_every", "100", "--batchSize", str(B),
            "--train", "auglistener", "--accumulateGrad", "--selfTrain",
            "--aug", "aug", "--feedback", "sample", "--speaker", ckpt]
    for key, val in CFG.items():
        if key not in ("batch_size", "self_train"):
            args += [f"--{key}", str(val)]
    main(args)
    assert (tmp_path / "snap" / "st" / "state_dict" / "LAST_iter2").exists()
    assert '"self_train": true' in capsys.readouterr().out
