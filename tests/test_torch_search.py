"""The port's search inference and simple agents against the JAX package.

On a synthetic 2-scan world, the JAX ``Seq2SeqAgent`` and ``SpeakerAgent``
and the port's carry the same weights (the Dic / channel-AdaIN / shift-5
listener of tests/test_torch_train.py, a speaker at the same tiny widths),
in f32 on the CPU, every dropout rate 0, the JAX envs on the Python engine
(``backend="python"``).  Dijkstra and state-factored search must find
JAX's exploration paths, trajectories and actions exactly, with listener
and speaker scores at tests/test_ops.py's f32 tolerances (rtol 1e-4,
atol 1e-5), and ``cal_score`` must be JAX's.  The port's listener steps
route the top BiLSTM through K1's plain version under ``always`` (the CPU
path of the kernel route).  ``beam_valid``, the simple agents and the CLI
modes are held in tests/test_torch_beam_valid.py.
"""

import jax
import numpy as np
import pytest

from dasa_tpu.agents import Seq2SeqAgent as JaxAgent
from dasa_tpu.agents import search as jax_search
from dasa_tpu.agents.speaker import SpeakerAgent as JaxSpeaker
from dasa_tpu.config import Config as JaxConfig
from dasa_tpu.data.features import FeatureDB as JaxFeatureDB
from dasa_tpu.env import R2REnv as JaxEnv
from dasa_tpu.utils import Tokenizer as JaxTokenizer
from dasa_tpu_torch.agents import Seq2SeqAgent, search
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
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_search_world")
    conn, data = str(root / "connectivity"), str(root / "task")
    write_synthetic_connectivity(conn, SCANS, n_nodes=24, seed=0)
    make_synthetic_task(data, SCANS[:1], SCANS[1:], n_train=6, n_val=3,
                        connectivity_dir=conn)
    vocab = build_vocab(load_datasets(["train"], data), min_count=1)
    return conn, data, vocab


def make_pair(world, split="val_unseen", use_pallas="always"):
    """JAX and port listeners and speakers over one split, same
    weights."""
    conn, data, vocab = world
    tok = Tokenizer(vocab, encoding_length=L)
    items = expand_instructions(load_datasets([split], data), tok,
                                max_input=L)
    kw = {**CFG, "use_pallas": use_pallas}
    jfeat = JaxFeatureDB.synthetic(SCANS, conn, dim=DIM)
    jdepth = JaxFeatureDB.synthetic(SCANS, conn, dim=DIM, salt=7)
    jenv = JaxEnv(jfeat, items, batch_size=B, connectivity_dir=conn,
                  max_candidates=16, max_input=L, depth_db=jdepth,
                  backend="python")
    jcfg = JaxConfig(**kw, connectivity_dir=conn)
    jagent = JaxAgent(jcfg, jenv, jfeat, depth_db=jdepth,
                      vocab_size=len(tok), rng_seed=11)
    jspeaker = JaxSpeaker(jcfg, jenv, jfeat, vocab_size=len(tok),
                          tok=JaxTokenizer(vocab, encoding_length=L),
                          rng_seed=5)
    cfg = Config(**kw, connectivity_dir=conn, data_dir=data)
    feat = FeatureDB.synthetic(SCANS, conn, dim=DIM)
    depth = FeatureDB.synthetic(SCANS, conn, dim=DIM, salt=7)
    env = R2REnv(feat, items, batch_size=B, connectivity_dir=conn,
                 max_candidates=16, max_input=L, depth_db=depth)
    agent = Seq2SeqAgent(cfg, env, feat, depth_db=depth, device="cpu")
    speaker = SpeakerAgent(cfg, env, feat, vocab_size=len(tok), tok=tok,
                           device="cpu")
    load_weights(agent, speaker, jagent, jspeaker)
    return (jagent, jspeaker), (agent, speaker)


def load_weights(agent, speaker, jagent, jspeaker):
    agent.load_jax_params(jax.tree_util.tree_map(np.asarray, jagent.params))
    speaker.load_jax_params(jax.tree_util.tree_map(np.asarray,
                                                   jspeaker.params))


def assert_results_match(got, want, speaker_scores):
    """Per episode: the exploration path and every path's trajectory and
    actions exactly; its listener (and speaker) scores within TOL."""
    assert [r["instr_id"] for r in got] == [r["instr_id"] for r in want]
    for res, jres in zip(got, want):
        assert res["dijk_path"] == jres["dijk_path"], res["instr_id"]
        key = lambda p: (p["trajectory"], p["action"])  # noqa: E731
        paths = sorted(res["paths"], key=key)
        jpaths = sorted(jres["paths"], key=key)
        assert [key(p) for p in paths] == [key(p) for p in jpaths]
        for p, jp in zip(paths, jpaths):
            assert p["listener_actions"] == jp["listener_actions"]
            np.testing.assert_allclose(p["listener_scores"],
                                       jp["listener_scores"], **TOL)
            if speaker_scores:
                # a per-word score of the instruction given the path
                assert len(p["speaker_scores"]) == L - 1
                np.testing.assert_allclose(p["speaker_scores"],
                                           jp["speaker_scores"], **TOL)
            else:
                assert p["records"] == jp["records"]


@pytest.fixture(scope="module")
def pair(world):
    """The ``always`` pair of the search tests, built once: the JAX
    agent's compiled step and speaker scores serve every test."""
    return make_pair(world)


def reset_both(jagent, agent):
    jagent.env.reset_epoch()
    agent.env.reset_epoch()


@pytest.mark.parametrize("use_pallas", ["never", "always"])
def test_dijkstra_search_matches_jax(world, pair, use_pallas):
    """Two candidates a batch, then the speaker's rescoring of the next
    batch's paths, one path a call."""
    (jagent, jspeaker), (agent, speaker) = (
        pair if use_pallas == "always"
        else make_pair(world, use_pallas=use_pallas))
    reset_both(jagent, agent)
    want = jax_search.dijkstra_search(jagent, n_candidates=2,
                                      max_expansions=60)
    got = search.dijkstra_search(agent, n_candidates=2, max_expansions=60)
    assert_results_match(got, want, speaker_scores=False)
    for res in got:
        assert 1 <= len(res["paths"]) <= 2
        assert res["dijk_path"][-1] == res["dijk_path"][0]
    want = jax_search.beam_search(jagent, jspeaker, n_candidates=2)
    got = search.beam_search(agent, speaker, n_candidates=2)
    assert_results_match(got, want, speaker_scores=True)


def test_state_factored_search_matches_jax(pair):
    """Two completions a batch, three successors a round, rescored; the
    exploration path is a walk on the scan graph."""
    (jagent, jspeaker), (agent, speaker) = pair
    reset_both(jagent, agent)
    want = jax_search._speaker_rescore(jax_search.state_factored_search(
        jagent, 2, 3, max_expansions=40), jspeaker)
    got = search._speaker_rescore(search.state_factored_search(
        agent, 2, 3, max_expansions=40), speaker)
    assert_results_match(got, want, speaker_scores=True)
    g = agent.env.graphs[SCANS[1]]
    adj = g.nav_adjacency()
    for res in got:
        walk = res["dijk_path"]
        assert all(a == b or adj[g.id2ix[a], g.id2ix[b]]
                   for a, b in zip(walk, walk[1:]))


def test_state_factored_budget_exhaust_warns(pair):
    """A budget too small to reach the completions emits best-effort
    paths, with a warning, as the JAX search does."""
    _jax, (agent, _speaker) = pair
    with pytest.warns(UserWarning, match="exhausted max_expansions"):
        results = search.state_factored_search(agent, completion_size=3,
                                               successor_size=1,
                                               max_expansions=1)
    assert all(len(res["paths"]) >= 1 for res in results)


@pytest.mark.parametrize("alpha,avg_speaker,avg_listener", [
    (0.0, False, False), (0.3, True, False), (0.5, True, True),
    (1.0, False, True)])
def test_cal_score_matches_jax(alpha, avg_speaker, avg_listener):
    rng = np.random.default_rng(0)
    for n_sp in (0, 3):
        path = {"speaker_scores": -rng.random(n_sp).astype(np.float32),
                "listener_scores": list(-rng.random(4))}
        assert search.cal_score(path, alpha, avg_speaker, avg_listener) == \
            jax_search.cal_score(path, alpha, avg_speaker, avg_listener)
