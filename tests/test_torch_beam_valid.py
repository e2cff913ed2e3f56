"""The port's search validation, simple agents and their CLI modes
against the JAX package.

On a synthetic 2-scan world, both packages' ``beam_valid`` run with the
same listener and speaker weights (the Dic / channel-AdaIN / shift-5
listener of tests/test_torch_train.py, a speaker at the same tiny
widths), in f32 on the CPU, every dropout rate 0, the JAX envs on the
Python engine: Dijkstra search, two candidates with ``param_search``,
and state-factored search, one val split each, must give JAX's summaries
and logs exactly.  ``eval_simple_agents`` must give JAX's summaries.
Then ``--train beamvalid``, ``validlistener --beam``, ``validlistener
--submit`` and ``--train simpleagents`` run through the CLI.
"""

import jax
import numpy as np
import pytest

import dasa_tpu.agents.speaker as jax_speaker_module
from dasa_tpu.agents.simple import eval_simple_agents as jax_simple_agents
from dasa_tpu.agents.speaker import SpeakerAgent as JaxSpeaker
from dasa_tpu.config import Config as JaxConfig
from dasa_tpu.data.features import FeatureDB as JaxFeatureDB
from dasa_tpu.env import R2REnv as JaxEnv
from dasa_tpu.train import trainer as jax_trainer
from dasa_tpu.train.evaluation import Evaluation as JaxEvaluation
from dasa_tpu_torch.agents.simple import eval_simple_agents
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
from dasa_tpu_torch.train.evaluation import Evaluation
from dasa_tpu_torch.utils import Tokenizer, build_vocab

SCANS = ("synthA", "synthB")
DIM = 24
L = 24
B = 2
CFG = dict(
    rnn_dim=32, wemb=16, aemb=8, critic_dim=32, angle_feat_size=8,
    feature_size=DIM, max_input=L, max_decode=L, max_candidates=16,
    max_action=5, batch_size=B, d_enc_hidden_size=16, d_hidden_size=32,
    d_vl_layers=1, d_la_layers=1, encoder_type="Dic", include_vision=True,
    adain_type="channel", ab_type="a", a_type="sigmoid", use_shift=True,
    shift_kernel_size=5, dropout=0.0, featdropout=0.0, d_dropout_ratio=0.0,
    d_hidden_dropout_prob=0.0, d_attn_dropout_prob=0.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_beam_valid_world")
    conn, data = str(root / "connectivity"), str(root / "task")
    write_synthetic_connectivity(conn, SCANS, n_nodes=24, seed=0)
    # one path (three instructions) a val split: two search batches
    make_synthetic_task(data, SCANS[:1], SCANS[1:], n_train=6, n_val=1,
                        connectivity_dir=conn)
    vocab = build_vocab(load_datasets(["train"], data), min_count=1)
    return conn, data, vocab


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


@pytest.fixture(scope="module")
def split_worlds(world, tmp_path_factory):
    """Per val split, built once: both packages' worlds of that split and
    the same listener and speaker weights on each side."""
    conn, data, _vocab = world
    base = dict(**CFG, use_pallas="always", connectivity_dir=conn,
                data_dir=data,
                log_dir=str(tmp_path_factory.mktemp("beam_valid_log")))
    built = {}

    def get(split):
        if split not in built:
            jcfg = JaxConfig(**base)
            jworld = JaxPythonWorld(jcfg, val_splits=(split,))
            jagent = jax_trainer.make_agent(jcfg, jworld)
            jspeaker = JaxSpeaker(jcfg, jworld.envs["train"],
                                  jworld.feature_db,
                                  vocab_size=len(jworld.tok), tok=jworld.tok)
            cfg = Config(**base)
            pworld = trainer.World(cfg, val_splits=(split,))
            agent = trainer.make_agent(cfg, pworld, device="cpu")
            speaker = trainer.make_speaker(cfg, pworld, device="cpu")
            agent.load_jax_params(jax.tree_util.tree_map(np.asarray,
                                                         jagent.params))
            speaker.load_jax_params(jax.tree_util.tree_map(
                np.asarray, jspeaker.params))
            built[split] = (base, (jworld, jagent, jspeaker),
                            (pworld, agent, speaker))
        return built[split]
    return get


@pytest.mark.parametrize("split,kw", [
    ("val_unseen", dict(candidates=1)),
    ("val_seen", dict(candidates=2, param_search=True)),
    ("val_unseen", dict(candidates=2, search_type="state_factored",
                        max_expansions=30))])
def test_beam_valid_matches_jax(split_worlds, monkeypatch, split, kw):
    """beam_valid over one val split: the summary, or the param_search
    logs (every alpha in 0..1 by 0.05, both averaging choices) and the
    best setting."""
    base, (jworld, jagent, jspeaker), (pworld, agent, speaker) = \
        split_worlds(split)
    monkeypatch.setattr(jax_trainer, "make_agent", lambda *a, **k: jagent)
    monkeypatch.setattr(jax_speaker_module, "SpeakerAgent",
                        lambda *a, **k: jspeaker)
    want = jax_trainer.beam_valid(JaxConfig(**base, **kw), jworld)
    got = trainer.beam_valid(Config(**base, **kw), pworld, agent=agent,
                             speaker=speaker)
    assert got == want
    assert set(got) == {split}


def test_simple_agents_match_jax(world):
    """Stop, Random (random.Random(seed), as in JAX) and Shortest over
    both val splits: the same summaries; Shortest succeeds everywhere."""
    conn, data, vocab = world
    tok = Tokenizer(vocab, encoding_length=L)
    feat = FeatureDB.synthetic(SCANS, conn, dim=DIM)
    jfeat = JaxFeatureDB.synthetic(SCANS, conn, dim=DIM)
    for split in ("val_seen", "val_unseen"):
        raw = load_datasets([split], data)
        items = expand_instructions(raw, tok, max_input=L)
        env = R2REnv(feat, items, batch_size=B, connectivity_dir=conn,
                     max_candidates=16, max_input=L)
        jenv = JaxEnv(jfeat, items, batch_size=B, connectivity_dir=conn,
                      max_candidates=16, max_input=L, backend="python")
        got = eval_simple_agents(env, Evaluation(raw, conn, splits=[split]),
                                 episode_len=5)
        want = jax_simple_agents(
            jenv, JaxEvaluation(raw, conn, splits=[split]), episode_len=5)
        assert got == want
        assert got["Shortest"]["success_rate"] == 1.0


@pytest.mark.parametrize("mode", [
    ["--train", "beamvalid"],
    ["--train", "validlistener", "--beam", "--candidates", "2",
     "--param_search"],
    ["--train", "validlistener", "--submit"],
    ["--train", "simpleagents"]])
def test_cli_search_and_simple_modes(world, tmp_path, capsys, mode):
    """python -m dasa_tpu_torch.cli --device cpu for each mode."""
    from dasa_tpu_torch.cli import main

    conn, data, _vocab = world
    args = ["--device", "cpu", "--connectivity_dir", conn, "--data_dir",
            data, "--log_dir", str(tmp_path / "log"), "--name", "cli",
            "--batchSize", str(B)]
    for key, val in CFG.items():
        if key != "batch_size":
            args += [f"--{key}", str(val)]
    main(args + mode)
    out = capsys.readouterr().out
    if "--param_search" in mode:
        assert "val_seen: best avg_speaker=" in out
    elif "simpleagents" in mode:
        assert "val_unseen Shortest: " in out and "success_rate: 1.0000" \
            in out
    else:
        assert "Env name: val_seen" in out and "Env name: val_unseen" in out
    if "--submit" in mode:
        for split in ("val_seen", "val_unseen"):
            assert (tmp_path / "log" / "cli" / f"submit_{split}.json") \
                .exists()
