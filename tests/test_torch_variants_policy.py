"""Whole variant policies and the variant agent's pieces against the JAX
package.

Per configuration of ``chip_smoke.py``'s phase 16, at test widths: one
policy step (the new decoder state, the logits, the value, the aux
outputs), and the port's ``state_dict`` carried back onto the flax params
through ``dasa_tpu/utils/torch_import.py``'s translators, exactly.  Then
the progress observation and the candidates' view index against the JAX
env and ``make_step_inputs``, Dijkstra search with the double agent (its
two decoder streams packed in one state) against the JAX search, the
host teacher pass against the device one with the auxiliary terms, and
the CLI with the variant flags.

Tolerance: rtol and atol 1e-4 where the 768-wide BERT stack is in the
path (tests/test_torch_models.py's reason); atol 1e-5 for gradients.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasa_tpu.agents import Seq2SeqAgent as JaxAgent
from dasa_tpu.agents import search as jax_search
from dasa_tpu.agents.seq2seq import make_step_inputs as jax_step_inputs
from dasa_tpu.config import Config as JaxConfig
from dasa_tpu.data.features import FeatureDB as JaxFeatureDB
from dasa_tpu.env import R2REnv as JaxEnv
from dasa_tpu.models import DasaPolicy as JaxPolicy
from dasa_tpu.models import StepInputs as JaxInputs
from dasa_tpu.models.policy import DecoderState as JaxState
from dasa_tpu.utils import torch_import
from dasa_tpu_torch.agents import Seq2SeqAgent, search
from dasa_tpu_torch.agents.seq2seq import make_step_inputs
from dasa_tpu_torch.config import Config
from dasa_tpu_torch.data.datasets import (
    expand_instructions,
    load_datasets,
    make_synthetic_task,
)
from dasa_tpu_torch.data.features import FeatureDB
from dasa_tpu_torch.env import R2REnv
from dasa_tpu_torch.env.device_env import (
    DeviceEnvTables,
    device_obs,
    device_transition,
    episode_inputs,
)
from dasa_tpu_torch.models import layers as tlayers
from dasa_tpu_torch.models.policy import (
    DasaPolicy,
    DecoderState,
    StepInputs,
    decoder_state_width,
)
from dasa_tpu_torch.testing import torch_threads, write_synthetic_connectivity
from dasa_tpu_torch.utils import Tokenizer, build_vocab
from dasa_tpu_torch.utils.jax_params import policy_state_dict_from_jax

GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
BERT_TOL = dict(rtol=1e-4, atol=1e-4)
# chip_smoke.py's phase 16 configurations, at test widths
CONFIGS = {
    "battn_heads": dict(adain_type="channel", ab_type="a", a_type="sigmoid",
                        use_shift=True, shift_kernel_size=5, pred_back=True,
                        pred_pm=True, pm_type="att_hid",
                        decoder_type="dyrelu", use_pallas="always"),
    "gumbel_uni_ctxv": dict(adain_type="channel", ab_type="ab",
                            a_type="gumbel_sigmoid", pred_back=True,
                            back_input="cur", pred_pm=True,
                            pm_type="plain_att", d_bidirectional=False,
                            ctx_v=True),
    "double": dict(agent_type="double", adain_type="coco_channel",
                   ab_type="ab", a_type="sigmoid"),
    "advanced": dict(agent_type="advanced", adain_type="meanchannel"),
    "kvmem": dict(agent_type="kvmem", adain_type="rgb_meanchannel",
                  pred_back=True),
    "new": dict(agent_type="new", adain_type="depth_stat_channel"),
    "mutan": dict(agent_type="mutan", adain_type="rgb_stat_channel"),
    "mt": dict(agent_type="mt", adain_type="rgb_channel", ab_type="a",
               a_type="sigmoid", use_pallas="always"),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def ragged_mask(b, t):
    """True = valid; row j keeps its first t - j tokens."""
    return np.arange(t)[None, :] < (t - np.arange(b))[:, None]


def close(got, ref, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(ref, np.float32), **tol)


BASE = dict(encoder_type="Dic", include_vision=True, angle_feat_size=8,
            feature_size=24, max_input=12, d_enc_hidden_size=16,
            d_hidden_size=32, critic_dim=32, aemb=8, d_vl_layers=1,
            d_la_layers=1, max_candidates=6)


def flax_path(name: str) -> str:
    """A port module name as its flax path (the inverse of
    ``policy_state_dict_from_jax``'s renames)."""
    name = re.sub(r"list_linear_(hv|hq)\.(\d+)", r"linear_\1_\2", name)
    name = re.sub(r"(_fc_(?:content|style|fuse))\.0(?=\.|$)", r"\1.Dense_0",
                  name)
    name = re.sub(r"(_fc_(?:content|style|fuse))\.2(?=\.|$)", r"\1.Dense_1",
                  name)
    name = re.sub(r"(^|\.)embedding\.0$", r"\1embedding", name)
    name = re.sub(r"^critic\.state2value\.0$", "critic.Dense_0", name)
    name = re.sub(r"^critic\.state2value\.3$", "critic.Dense_1", name)
    return name.replace(".", "/")


def translate_port(policy: torch.nn.Module) -> dict:
    """The port policy's state_dict (BERT aside: translate_dic_model
    carries it) as flax paths, through torch_import's translators."""
    state = {k: v.numpy() for k, v in policy.state_dict().items()}
    out = {}
    for name, sub in policy.named_modules():
        path = flax_path(name)
        if name.startswith("encoder.bert"):
            continue
        if isinstance(sub, torch.nn.Linear):
            out.update(torch_import.translate_linear(state, name, path))
        elif isinstance(sub, (tlayers.LSTM, tlayers.BiLSTM)):
            out.update(torch_import.translate_lstm(
                state, name, path, isinstance(sub, tlayers.BiLSTM)))
        elif isinstance(sub, tlayers.LstmCell):
            out.update(torch_import.translate_lstm_cell(state, name, path))
    for name in state:
        if name.rsplit(".", 1)[-1] in ("a_csb", "b_csb", "kv",
                                       "v_stop_feat"):
            out[tuple(flax_path(name).split("/"))] = state[name]
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_policy_step_and_round_trip_match_jax(name):
    """One policy step of each phase-16 configuration (is_test, as the
    evaluation and the search run it): the new decoder state, the logits,
    the value and the aux outputs.  Then the port's state_dict through
    torch_import's translators gives back every flax leaf (BERT aside)
    exactly, with no path unmatched."""
    kw = dict(CONFIGS[name], use_pallas="never")
    tkw = CONFIGS[name]
    rng = np.random.default_rng(0)
    jcfg = JaxConfig(**BASE, **kw)
    b, k, length, f_all = 2, 6, 12, jcfg.feature_all_size
    arrs = [np.abs(rand(rng, *s)) for s in ((b, 8), (b, 36, f_all),
                                            (b, 36, f_all), (b, k, f_all),
                                            (b, k, f_all))]
    cand_n = np.array([3, 5])
    mask = np.arange(k)[None] > cand_n[:, None]
    cidx = np.where(np.arange(k)[None] >= cand_n[:, None], 36,
                    rng.integers(0, 36, (b, k)))
    jin = JaxInputs(*[jnp.asarray(a) for a in arrs], jnp.asarray(mask),
                    jnp.asarray(cidx, jnp.int32))
    instr = rng.integers(1, 100, (b, length))
    valid = ragged_mask(b, length)
    seq = valid.sum(1)
    jtext = (jnp.asarray(instr, jnp.int32), jnp.asarray(valid),
             jnp.asarray(seq, jnp.int32))
    jpol = JaxPolicy(jcfg, vocab_size=0)
    params = jpol.init({"params": jax.random.PRNGKey(0),
                        "dropout": jax.random.PRNGKey(1)}, *jtext, jin)
    tpol = DasaPolicy(Config(**BASE, **tkw)).eval()
    tree = jax.tree_util.tree_map(np.asarray, params)
    tpol.load_state_dict({k_: torch.from_numpy(v) for k_, v in
                          policy_state_dict_from_jax(tree).items()})
    width = decoder_state_width(tpol.cfg)
    state = rand(rng, 3, b, width)
    first = np.array([False, True])

    cached = jpol.apply(params, *jtext, method=JaxPolicy.encode_text)
    j_state, j_logit, j_value, j_aux = jpol.apply(
        params, cached, *jtext[1:], jin, JaxState(*map(jnp.asarray, state)),
        jnp.asarray(first), method=JaxPolicy.policy_step)
    tin = StepInputs(*[torch.from_numpy(a) for a in arrs],
                     torch.from_numpy(mask), torch.from_numpy(cidx).long())
    ttext = (torch.from_numpy(instr).long(), torch.from_numpy(valid),
             torch.from_numpy(seq))
    with torch.no_grad():
        t_cached = tpol.encode_text(*ttext)
        t_state, t_logit, t_value, t_aux = tpol.policy_step(
            t_cached, *ttext[1:], tin,
            DecoderState(*map(torch.from_numpy, state)),
            torch.from_numpy(first))
    assert sorted(t_aux) == sorted(j_aux)
    for got, ref in [*zip(t_state, j_state), (t_logit, j_logit),
                     (t_value, j_value),
                     *((t_aux[key], j_aux[key]) for key in j_aux)]:
        close(got, ref, BERT_TOL)

    translated = {path: val for path, val in translate_port(tpol).items()}
    new, missed = torch_import.apply_translated(tree["params"], translated,
                                                strict=True)
    assert not missed
    leaves = jax.tree_util.tree_flatten_with_path(tree["params"])[0]
    covered = {tuple(p.key for p in path) for path, _ in leaves}
    covered = {p for p in covered if p[:2] != ("encoder", "bert")}
    assert covered == set(translated)
    for path in covered:
        got, want = new, tree["params"]
        for p in path:
            got, want = got[p], want[p]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                   err_msg="/".join(path))


# ---------------------------------------------------------------------
# the agent
# ---------------------------------------------------------------------
SCANS = ("synthA", "synthB")
DIM = 24
L = 24
AGENT_CFG = dict(
    rnn_dim=32, wemb=16, aemb=8, critic_dim=32, angle_feat_size=8,
    feature_size=DIM, max_input=L, max_candidates=16, max_action=5,
    batch_size=2, d_enc_hidden_size=16, d_hidden_size=32, d_vl_layers=1,
    d_la_layers=1, encoder_type="Dic", include_vision=True,
    consistent_drop=True, depth_drop=True, featdropout=0.3, ml_weight=0.2,
    dropout=0.0, d_dropout_ratio=0.0, d_hidden_dropout_prob=0.0,
    d_attn_dropout_prob=0.0)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_variants_world")
    conn, data = str(root / "connectivity"), str(root / "task")
    write_synthetic_connectivity(conn, SCANS, n_nodes=24, seed=0)
    make_synthetic_task(data, SCANS[:1], SCANS[1:], n_train=6, n_val=2,
                        connectivity_dir=conn)
    vocab = build_vocab(load_datasets(["train"], data), min_count=1)
    return conn, data, Tokenizer(vocab, encoding_length=L)


def items_of(world):
    _conn, data, tok = world
    return expand_instructions(load_datasets(["train"], data), tok,
                               max_input=L)


def port_agent(world, **kw):
    conn, data, _tok = world
    feat = FeatureDB.synthetic(SCANS, conn, dim=DIM)
    depth = FeatureDB.synthetic(SCANS, conn, dim=DIM, salt=7)
    env = R2REnv(feat, items_of(world), batch_size=2, connectivity_dir=conn,
                 max_candidates=16, max_input=L, depth_db=depth,
                 backend="python")
    return Seq2SeqAgent(Config(**{**AGENT_CFG, **kw}, connectivity_dir=conn,
                               data_dir=data), env, feat, depth_db=depth,
                        device="cpu")


def test_progress_and_candidate_index_match_jax(world):
    """The progress observation (1 - distance / total) of the host env
    along a teacher walk and of the device observation, and the
    candidates' view index of make_step_inputs, against the JAX env and
    make_step_inputs."""
    conn, _data, _tok = world
    jfeat = JaxFeatureDB.synthetic(SCANS, conn, dim=DIM)
    jenv = JaxEnv(jfeat, items_of(world), batch_size=2, connectivity_dir=conn,
                  max_candidates=16, max_input=L, backend="python")
    agent = port_agent(world)
    env = agent.env
    jobs, obs = jenv.reset(), env.reset()
    dev = DeviceEnvTables.build(env, 16, "cpu")
    ep = {k: torch.as_tensor(v) for k, v in
          episode_inputs(env, dev).items()}
    goal = ep["goal"]
    total = dev.dist[ep["node0"], goal - dev.node_base[goal]]
    node, view = ep["node0"], ep["view0"]
    for _ in range(4):
        np.testing.assert_allclose(obs.progress, jobs.progress, rtol=1e-6)
        sobs = device_obs(dev.arrays(), node, view, goal, ep["start"], total,
                          16)
        np.testing.assert_allclose(sobs["progress"].numpy(), obs.progress,
                                   rtol=1e-5, atol=1e-6)
        inputs = make_step_inputs(agent.cfg, agent.tables, sobs)
        jsobs = {k: jnp.asarray(v.numpy()) for k, v in sobs.items()}
        jin = jax_step_inputs(JaxConfig(**AGENT_CFG), (
            jnp.asarray(agent.feat_table.numpy()),
            jnp.asarray(agent.dfeat_table.numpy()),
            jnp.asarray(agent.angle_table.numpy())), jsobs)
        np.testing.assert_array_equal(inputs.cand_idx.numpy(),
                                      np.asarray(jin.cand_idx))
        action = np.where(obs.teacher >= obs.cand_n, -1, obs.teacher)
        trajs = [[t] for t in env.state_tuples()]
        obs = env.step(action, trajs)
        jobs = jenv.step(action, [[t] for t in jenv.state_tuples()])
        node, view, _stop = device_transition(
            dev.arrays(), node, view, sobs["teacher"],
            torch.zeros_like(node, dtype=torch.bool))


def test_double_agent_search_matches_jax(world):
    """Dijkstra search runs the double agent through policy_step
    unchanged: the frontier's decoder states are 2 x d_hidden_size wide,
    and the paths, actions and listener scores equal the JAX search's
    (weights carried across)."""
    conn, _data, tok = world
    kw = {**AGENT_CFG, **CONFIGS["double"]}
    jfeat = JaxFeatureDB.synthetic(SCANS, conn, dim=DIM)
    jdepth = JaxFeatureDB.synthetic(SCANS, conn, dim=DIM, salt=7)
    jenv = JaxEnv(jfeat, items_of(world), batch_size=2,
                  connectivity_dir=conn, max_candidates=16, max_input=L,
                  depth_db=jdepth, backend="python")
    jagent = JaxAgent(JaxConfig(**kw, connectivity_dir=conn), jenv, jfeat,
                      depth_db=jdepth, vocab_size=len(tok), rng_seed=11)
    agent = port_agent(world, **CONFIGS["double"])
    agent.load_jax_params(jax.tree_util.tree_map(np.asarray, jagent.params))
    assert decoder_state_width(agent.cfg) == 2 * AGENT_CFG["d_hidden_size"]
    jenv.reset_epoch()
    agent.env.reset_epoch()
    want = jax_search.dijkstra_search(jagent, n_candidates=2,
                                      max_expansions=40)
    got = search.dijkstra_search(agent, n_candidates=2, max_expansions=40)
    assert [r["instr_id"] for r in got] == [r["instr_id"] for r in want]
    for res, jres in zip(got, want):
        assert res["dijk_path"] == jres["dijk_path"]
        key = lambda p: (p["trajectory"], p["action"])  # noqa: E731
        paths = sorted(res["paths"], key=key)
        jpaths = sorted(jres["paths"], key=key)
        assert [key(p) for p in paths] == [key(p) for p in jpaths]
        for p, jp in zip(paths, jpaths):
            np.testing.assert_allclose(p["listener_scores"],
                                       jp["listener_scores"], **BERT_TOL)


def test_host_teacher_pass_matches_device_pass(world):
    """The host act/replay teacher pass (``device_rollout="never"``: the
    progress target from the env's episode-start observation, the replay
    through ``_run_replays``) against the device teacher pass on the same
    batch, with the back, progress-monitor and DyReLU heads: the loss,
    the auxiliary logs and the gradients."""
    cfg = CONFIGS["battn_heads"]
    noise = torch.from_numpy(
        (np.random.default_rng(3).random(DIM) > 0.3) / 0.7).float()
    out = []
    for never in (False, True):
        agent = port_agent(world, **cfg,
                           device_rollout="never" if never else "auto",
                           fuse_passes="never")
        agent.env.reset_epoch()
        agent.zero_grad()
        if never:
            agent.rollout(train_ml=1.0, train_rl=False, feedback="teacher",
                          env_noise=noise)
        else:
            agent.device_rollout(train_ml=1.0, train_rl=False,
                                 feedback="teacher", env_noise=noise)
        grads = {n: p.grad.clone() for n, p in
                 agent.policy.named_parameters() if p.grad is not None}
        logs = {k: float(v[-1]) for k, v in agent.logs.items()}
        out.append((float(agent.losses[-1]), logs, grads))
    (la, ga_logs, ga), (lb, gb_logs, gb) = out
    np.testing.assert_allclose(lb, la, rtol=1e-5)
    for key in ("ml_loss", "back_loss", "pm_loss"):
        assert ga_logs[key] != 0.0
        np.testing.assert_allclose(gb_logs[key], ga_logs[key], rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    assert ga.keys() == gb.keys()
    for name in ga:
        close(gb[name], ga[name].numpy(), GRAD_TOL)


def test_cli_trains_a_variant_on_cpu(world, tmp_path, capsys):
    """python -m dasa_tpu_torch.cli --train listener with the variant
    flags (--agent_type, --adaIn_type, --pred_back, --pred_pm, --pm_type,
    --d_bidirectional, --ctx_v) reaching the agent: two iterations and a
    validation."""
    from dasa_tpu_torch.cli import main

    conn, data, _tok = world
    args = ["--device", "cpu", "--connectivity_dir", conn, "--data_dir",
            data, "--snap_dir", str(tmp_path / "snap"), "--log_dir",
            str(tmp_path / "log"), "--name", "cli", "--iters", "2",
            "--log_every", "2", "--val_every", "2", "--batchSize", "2",
            "--train", "listener", "--agent_type", "advanced",
            "--adaIn_type", "rgb_stat_channel", "--pred_back",
            "--d_bidirectional", "0", "--ctx_v"]
    for key, val in AGENT_CFG.items():
        if key != "batch_size":
            args += [f"--{key}", str(val)]
    main(args)
    assert "PROGRESS: 2/2" in capsys.readouterr().out
