"""Whole policies and agents of the encoder zoo against the JAX package.

Every ``encoder_type`` (EncoderLSTM twice, B/CEncoder, Transformer, Gpt,
BertImg, BertAdd, BertMix) and ``agent_type="mcatt"``, at test widths
(the BERT narrowed to 64 wide, 2 heads, on both sides): the first-step
``forward`` and one ``policy_step`` (the new decoder state, the logits,
the value), and the port's ``state_dict`` carried back onto the flax
params through ``dasa_tpu/utils/torch_import.py``'s translators wherever
one exists.  Then, on a synthetic world: argmax ``test()`` of EncoderLSTM
and BertImg (equal trajectories), Dijkstra search of EncoderLSTM and
mcatt (equal paths and scores), HugAdd and BertAdd pretraining files
grafted as JAX's ``load_pretrained_encoder`` grafts them, the JAX
listener files of EncoderLSTM and BertAdd read by ``Seq2SeqAgent.load``,
the CLI's ``--train listener`` at the default encoder and its NDH modes
over dialogs the test writes, and the LSTM entry points' row chunks above
64 rows.

Tolerance: rtol 1e-5, atol 1e-6 for the policy outputs, except where
stated beside a case; grafts and loads exactly.
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasa_tpu.agents import Seq2SeqAgent as JaxAgent
from dasa_tpu.agents import search as jax_search
from dasa_tpu.config import Config as JaxConfig
from dasa_tpu.data.features import FeatureDB as JaxFeatureDB
from dasa_tpu.env import R2REnv as JaxEnv
from dasa_tpu.models import DasaPolicy as JaxPolicy
from dasa_tpu.models import StepInputs as JaxInputs
from dasa_tpu.models import policy as jax_policy
from dasa_tpu.models.policy import DecoderState as JaxState
from dasa_tpu.utils import pretrain_load as jax_pretrain_load
from dasa_tpu.utils import torch_import
from dasa_tpu_torch.agents import Seq2SeqAgent, search
from dasa_tpu_torch.config import Config
from dasa_tpu_torch.data.datasets import (
    expand_instructions,
    load_datasets,
    make_synthetic_task,
)
from dasa_tpu_torch.data.features import FeatureDB
from dasa_tpu_torch.env import R2REnv
from dasa_tpu_torch.models import layers as tlayers
from dasa_tpu_torch.models import policy as port_policy
from dasa_tpu_torch.models.policy import (
    DasaPolicy,
    DecoderState,
    StepInputs,
    decoder_state_width,
)
from dasa_tpu_torch.ops.lstm import (
    bilstm_scan_fn,
    bilstm_scan_ref,
    lstm_scan_fn,
    lstm_scan_ref,
)
from dasa_tpu_torch.testing import torch_threads, write_synthetic_connectivity
from dasa_tpu_torch.utils import Tokenizer, build_vocab
from dasa_tpu_torch.utils.jax_params import policy_state_dict_from_jax
from dasa_tpu_torch.utils.pretrain_load import load_pretrained_encoder

TOL = dict(rtol=1e-5, atol=1e-6)
NARROW = dict(hidden_size=64, num_attention_heads=2, intermediate_size=128)
BASE = dict(angle_feat_size=8, feature_size=24, max_input=12, rnn_dim=32,
            wemb=16, aemb=8, critic_dim=32, d_enc_hidden_size=16,
            d_hidden_size=32, d_la_layers=2, d_vl_layers=1, legacy_width=32,
            legacy_heads=2, legacy_layers=1, max_candidates=6,
            mcan_hidden_size=64, mcan_heads=2, mcan_layers=1,
            mcan_flat_mlp_size=32)
VISION = dict(include_vision=True, adain_type="channel", ab_type="a",
              a_type="sigmoid", use_shift=True, shift_kernel_size=5)
CONFIGS = {
    "EncoderLSTM": dict(),
    "EncoderLSTM-uni-max-zero": dict(bidir=False, sub_out="max",
                                     zero_init=True, adain_type="channel",
                                     ab_type="a", a_type="sigmoid"),
    "BEncoder": dict(encoder_type="BEncoder", d_bert_n_layers=2),
    "CEncoder": dict(encoder_type="CEncoder", update_bert=True),
    "Transformer": dict(encoder_type="Transformer"),
    "Gpt": dict(encoder_type="Gpt"),
    "BertImg": dict(encoder_type="BertImg", **VISION),
    "BertAdd": dict(encoder_type="BertAdd", **VISION),
    "BertMix": dict(encoder_type="BertMix", **VISION),
    "mcatt": dict(encoder_type="Dic", include_vision=True,
                  agent_type="mcatt"),
}
VOCAB = 100


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(autouse=True, scope="module")
def narrow_bert():
    """The narrow BERT on both sides for the whole module (flax re-reads
    it at every apply, and the shared pairs are built once)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_policy, port_policy):
            base = mod.bert_config_from
            mp.setattr(mod, "bert_config_from",
                       lambda cfg, base=base: dataclasses.replace(
                           base(cfg), **NARROW))
        yield


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def ragged_mask(b, t):
    """True = valid; row j keeps its first t - 3j tokens."""
    return np.arange(t)[None, :] < (t - 3 * np.arange(b))[:, None]


def close(got, ref, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(ref, np.float32), **tol)


def flax_path(name: str) -> str:
    """A port module name as its flax path (the inverse of
    ``policy_state_dict_from_jax``'s renames)."""
    for port, flax in ((r"layers", "layer"), (r"text_layers", "text"),
                       (r"add_layers", "add")):
        name = re.sub(rf"(^|\.){port}\.(\d+)", rf"\g<1>{flax}_\2", name)
    name = re.sub(r"(^|\.)(lalayer|addlayer|vlayer|sa_x|sa_y|sga_x|sga_y)"
                  r"\.(\d+)", r"\1\2_\3", name)
    name = re.sub(r"ffn\.0$", "ffn.Dense_0", name)
    name = re.sub(r"ffn\.2$", "ffn.Dense_1", name)
    name = re.sub(r"attflat_lang\.mlp\.0$", "attflat_lang.Dense_0", name)
    name = re.sub(r"attflat_lang\.mlp\.2$", "attflat_lang.Dense_1", name)
    name = re.sub(r"attflat_lang\.linear_merge$", "attflat_lang.Dense_2",
                  name)
    name = re.sub(r"(_fc_(?:content|style|fuse))\.0(?=\.|$)", r"\1.Dense_0",
                  name)
    name = re.sub(r"(_fc_(?:content|style|fuse))\.2(?=\.|$)", r"\1.Dense_1",
                  name)
    name = re.sub(r"^decoder\.embedding\.0$", "decoder.embedding", name)
    name = re.sub(r"^critic\.state2value\.0$", "critic.Dense_0", name)
    name = re.sub(r"^critic\.state2value\.3$", "critic.Dense_1", name)
    return name.replace(".", "/")


def translate_port(policy: torch.nn.Module):
    """The port policy's state_dict as flax paths, through torch_import's
    translators (Linear, LSTM, LSTMCell; the raw a_csb / b_csb); returns
    (translated, the flax paths of the leaves no translator covers: an
    Embedding's table, a LayerNorm's scale and bias)."""
    state = {k: v.numpy() for k, v in policy.state_dict().items()}
    out, untranslated = {}, set()
    for name, sub in policy.named_modules():
        path = flax_path(name)
        if isinstance(sub, torch.nn.Linear):
            out.update(torch_import.translate_linear(state, name, path))
        elif isinstance(sub, (tlayers.LSTM, tlayers.BiLSTM)):
            out.update(torch_import.translate_lstm(
                state, name, path, isinstance(sub, tlayers.BiLSTM)))
        elif isinstance(sub, tlayers.LstmCell):
            out.update(torch_import.translate_lstm_cell(state, name, path))
        elif isinstance(sub, (torch.nn.Embedding, torch.nn.LayerNorm)):
            untranslated.add(tuple(path.split("/")))
    for name in state:
        if name.rsplit(".", 1)[-1] in ("a_csb", "b_csb"):
            out[tuple(flax_path(name).split("/"))] = state[name]
    return out, untranslated


def bert_add_reference_names(state):
    """The port BertAddEncoder's state_dict under the r2rmodel
    BertAddEncoder's torch names (the BertAdd pretrain family's)."""
    out = {}
    for key, val in state.items():
        if not key.startswith("encoder."):
            continue
        key = key[len("encoder."):]
        for port, ref in (("embeddings.", "bert.embeddings."),
                          ("text_layers.", "bert.encoder.layer."),
                          ("add_layers.", "addlayer.layer."),
                          ("tail.lstm.", "lstm."),
                          ("tail.encoder2decoder_", "encoder_lstm2decoder_")):
            if key.startswith(port):
                key = ref + key[len(port):]
        out[key] = val
    return out


def policy_pair(name, **extra):
    kw = {**BASE, **CONFIGS[name], "use_pallas": "never", **extra}
    jpol = JaxPolicy(JaxConfig(**kw), vocab_size=VOCAB)
    tpol = DasaPolicy(Config(**kw), vocab_size=VOCAB).eval()
    return jpol, tpol


@pytest.mark.parametrize("name", list(CONFIGS))
def test_policy_step_and_round_trip_match_jax(name):
    """forward (the first step of fresh episodes) and one policy_step
    (is_test, as evaluation and search run it): the decoder state, the
    logits and the value.  Then the port's state_dict through
    torch_import's translators gives back every flax leaf a translator
    covers exactly, and for BertAdd / BertMix the family translator of
    the whole encoder (``translate_bert_add_encoder``) does too."""
    jpol, tpol = policy_pair(name)
    rng = np.random.default_rng(0)
    b, k, length, f_all = 3, 6, 12, tpol.cfg.feature_all_size
    arrs = [np.abs(rand(rng, *s)) for s in ((b, 8), (b, 36, f_all),
                                            (b, 36, f_all), (b, k, f_all),
                                            (b, k, f_all))]
    cand_n = np.array([3, 5, 2])
    mask = np.arange(k)[None] > cand_n[:, None]
    jin = JaxInputs(*map(jnp.asarray, arrs), jnp.asarray(mask))
    instr = rng.integers(1, VOCAB, (b, length))
    valid = ragged_mask(b, length)
    jtext = (jnp.asarray(instr, jnp.int32), jnp.asarray(valid),
             jnp.asarray(valid.sum(1), jnp.int32))
    params = jpol.init({"params": jax.random.PRNGKey(0),
                        "dropout": jax.random.PRNGKey(1)}, *jtext, jin)
    tree = jax.tree_util.tree_map(np.asarray, params)
    tpol.load_state_dict({k_: torch.from_numpy(v) for k_, v in
                          policy_state_dict_from_jax(tree).items()})
    width = decoder_state_width(tpol.cfg)
    want_width = {"mcatt": 64}.get(name, 32)
    assert width == want_width
    state = rand(rng, 3, b, width)
    first = np.array([False, True, False])
    tin = StepInputs(*map(torch.from_numpy, arrs), torch.from_numpy(mask))
    ttext = (torch.from_numpy(instr), torch.from_numpy(valid),
             torch.from_numpy(valid.sum(1)))
    cached = jpol.apply(params, *jtext, method=JaxPolicy.encode_text)
    j_out = jpol.apply(params, cached, *jtext[1:], jin,
                       JaxState(*map(jnp.asarray, state)), jnp.asarray(first),
                       method=JaxPolicy.policy_step)
    with torch.no_grad():
        for got, ref in zip(tpol(*ttext, tin), jpol.apply(params, *jtext,
                                                          jin)):
            close(got, ref)
        t_cached = tpol.encode_text(*ttext)
        assert t_cached.keys() == cached.keys()
        t_out = tpol.policy_step(t_cached, *ttext[1:], tin,
                                 DecoderState(*map(torch.from_numpy, state)),
                                 torch.from_numpy(first))
    for got, ref in [*zip(t_out[0], j_out[0]), *zip(t_out[1:3], j_out[1:3])]:
        close(got, ref)

    translated, untranslated = translate_port(tpol)
    new, missed = torch_import.apply_translated(tree["params"], translated,
                                                strict=True)
    assert not missed
    leaves = jax.tree_util.tree_flatten_with_path(tree["params"])[0]
    paths = {tuple(p.key for p in path) for path, _ in leaves}
    covered = {p for p in paths if p[:-1] not in untranslated}
    assert covered == set(translated)
    for path in covered:
        got, want = new, tree["params"]
        for p in path:
            got, want = got[p], want[p]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                   err_msg="/".join(path))
    if name in ("BertAdd", "BertMix"):
        ref_state = bert_add_reference_names(
            {k_: v.numpy() for k_, v in tpol.state_dict().items()})
        enc = torch_import.translate_bert_add_encoder(ref_state)
        enc_paths = {p[1:] for p in paths if p[0] == "encoder"}
        assert set(enc) == enc_paths
        for path, val in enc.items():
            want = tree["params"]["encoder"]
            for p in path:
                want = want[p]
            np.testing.assert_allclose(val, want, rtol=1e-6, atol=1e-7,
                                       err_msg="/".join(path))


@pytest.mark.parametrize("dirs", [2, 1])
def test_lstm_row_chunks_match_one_call(dirs):
    """Above 64 rows the LSTM entry points (both directions, one
    direction) run near-equal chunks (130 rows: three of 44 / 43 / 43):
    outputs and gradients equal one plain call over all rows."""
    rng = np.random.default_rng(1)
    t, b, h = 5, 130, 8
    mask = torch.from_numpy(np.stack([ragged_mask(b, t).T] * 2)).float()
    leaves = [torch.from_numpy(rand(rng, 2, t, b, 4 * h)),
              torch.from_numpy(rand(rng, 2, b, h, scale=0.1)),
              torch.from_numpy(rand(rng, 2, b, h, scale=0.1)),
              torch.from_numpy(rand(rng, 2, h, 4 * h, scale=0.3))]
    if dirs == 1:
        mask, leaves = mask[0], [x[0] for x in leaves]
        fns = (lambda xw, h0, c0, w: lstm_scan_fn(xw, mask, h0, c0, w),
               lambda xw, h0, c0, w: lstm_scan_ref(xw, mask, h0, c0, w))
    else:
        fns = (lambda xw, h0, c0, w: bilstm_scan_fn(xw, mask, h0, c0,
                                                    (w[0], w[1])),
               lambda xw, h0, c0, w: bilstm_scan_ref(xw, mask, h0, c0,
                                                     w)[:2])
    outs = []
    for fn in fns:
        xs = [x.clone().requires_grad_() for x in leaves]
        h_seq, c_seq = fn(*xs)
        (h_seq.sum() + (c_seq[..., -1, :, :] ** 2).sum()).backward()
        outs.append([h_seq, c_seq, *(x.grad for x in xs)])
    for got, ref in zip(*outs):
        close(got, ref.detach().numpy(), dict(rtol=1e-5, atol=1e-5))


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
    d_la_layers=1, dropout=0.0, d_dropout_ratio=0.0,
    d_hidden_dropout_prob=0.0, d_attn_dropout_prob=0.0)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_encoders_policy_world")
    conn, data = str(root / "connectivity"), str(root / "task")
    write_synthetic_connectivity(conn, SCANS, n_nodes=24, seed=0)
    make_synthetic_task(data, SCANS[:1], SCANS[1:], n_train=6, n_val=3,
                        connectivity_dir=conn)
    vocab = build_vocab(load_datasets(["train"], data), min_count=1)
    return conn, data, Tokenizer(vocab, encoding_length=L)


def port_agent(world, split="train", **kw):
    """The port's agent over one split."""
    conn, data, tok = world
    items = expand_instructions(load_datasets([split], data), tok,
                                max_input=L)
    feat = FeatureDB.synthetic(SCANS, conn, dim=DIM)
    depth = FeatureDB.synthetic(SCANS, conn, dim=DIM, salt=7)
    env = R2REnv(feat, items, batch_size=2, connectivity_dir=conn,
                 max_candidates=16, max_input=L, depth_db=depth)
    return Seq2SeqAgent(Config(**{**AGENT_CFG, **kw}, connectivity_dir=conn,
                               data_dir=data),
                        env, feat, depth_db=depth, vocab_size=len(tok),
                        device="cpu")


def make_pair(world, split="train", **kw):
    """JAX and port agents over one split, the same weights."""
    conn, data, tok = world
    items = expand_instructions(load_datasets([split], data), tok,
                                max_input=L)
    jfeat = JaxFeatureDB.synthetic(SCANS, conn, dim=DIM)
    jdepth = JaxFeatureDB.synthetic(SCANS, conn, dim=DIM, salt=7)
    jenv = JaxEnv(jfeat, items, batch_size=2, connectivity_dir=conn,
                  max_candidates=16, max_input=L, depth_db=jdepth,
                  backend="python")
    jagent = JaxAgent(JaxConfig(**{**AGENT_CFG, **kw}, connectivity_dir=conn),
                      jenv, jfeat, depth_db=jdepth, vocab_size=len(tok),
                      rng_seed=11)
    agent = port_agent(world, split, **kw)
    agent.load_jax_params(jax.tree_util.tree_map(np.asarray, jagent.params))
    return jagent, agent


@pytest.fixture(scope="module")
def pairs(world, narrow_bert):
    """One JAX / port pair per (split, configuration), shared by the tests
    that drive it (each resets what it reads: the env's epoch, the
    results); both agents of a pair advance in step."""
    cache = {}

    def get(split, name):
        if (split, name) not in cache:
            cache[split, name] = make_pair(world, split, **CONFIGS[name])
        return cache[split, name]

    return get


@pytest.mark.parametrize("name", ["EncoderLSTM", "BertImg"])
def test_argmax_test_matches_jax(pairs, name):
    """Argmax evaluation of a whole split on the device paths: the same
    trajectories."""
    jagent, agent = pairs("val_unseen", name)
    want = {r["instr_id"]: r["trajectory"]
            for r in jagent.test(feedback="argmax")}
    got = {r["instr_id"]: r["trajectory"]
           for r in agent.test(feedback="argmax")}
    assert got == want and len(got) == agent.env.size()


@pytest.mark.parametrize("name", ["EncoderLSTM", "mcatt"])
def test_dijkstra_search_matches_jax(pairs, name):
    """Dijkstra search over the plain ({ctx, h0, c0}) and the mcatt
    per-episode caches, sliced per frontier row: the paths, actions and
    listener scores of the JAX search (the decoder state at rnn_dim and
    at the MCAN width)."""
    jagent, agent = pairs("val_unseen", name)
    jagent.env.reset_epoch()
    agent.env.reset_epoch()
    want = jax_search.dijkstra_search(jagent, n_candidates=2,
                                      max_expansions=30)
    got = search.dijkstra_search(agent, n_candidates=2, max_expansions=30)
    assert [r["instr_id"] for r in got] == [r["instr_id"] for r in want]
    for res, jres in zip(got, want):
        assert res["dijk_path"] == jres["dijk_path"]
        key = lambda p: (p["trajectory"], p["action"])  # noqa: E731
        paths, jpaths = (sorted(r["paths"], key=key) for r in (res, jres))
        assert [key(p) for p in paths] == [key(p) for p in jpaths]
        # a path's scores are running sums of up to 5 log-probabilities
        for p, jp in zip(paths, jpaths):
            np.testing.assert_allclose(p["listener_scores"],
                                       jp["listener_scores"], rtol=1e-5,
                                       atol=1e-5)


def bert_add_checkpoint(policy, family, rng):
    """A pretraining file of ``family`` for this BertAdd listener, random
    weights under the family's torch names, a pooler (which no graft
    takes) and, for the whole-encoder family, nonzero LSTM bias_hh."""
    ref = bert_add_reference_names(policy.state_dict())
    if family == "hugadd":  # BertAddModel: the HF names at the top level
        ref = {(k[len("bert."):] if k.startswith("bert.") else k): v
               for k, v in ref.items()
               if k.startswith(("bert.", "addlayer.", "img_embedding."))}
    blob = {f"bert.{k}": torch.from_numpy(rand(rng, *v.shape, scale=0.1))
            for k, v in ref.items()}
    pooler = "bert.pooler.dense" if family == "hugadd" else \
        "bert.bert.pooler.dense"
    blob[f"{pooler}.weight"] = torch.ones(64, 64)
    return blob


@pytest.mark.parametrize("family", ["hugadd", "bertadd_encoder"])
def test_bert_add_families_graft_as_jax(pairs, tmp_path, family):
    """--pretrain_model_name of a HugAdd or a BertAdd pretraining file on a
    BertAdd listener: the port's load_pretrained_encoder gives exactly the
    JAX graft's weights (the bias_hh folded into bias_ih as JAX sums
    them), and changes the encoder."""
    jagent, agent = pairs("train", "BertAdd")
    blob = bert_add_checkpoint(agent.policy, family,
                               np.random.default_rng(len(family)))
    path = tmp_path / family / "pytorch_model.bin"
    os.makedirs(path.parent)
    torch.save(blob, path)
    before = agent.policy.state_dict()
    got, _missed = load_pretrained_encoder(before, str(path.parent))
    jnew, _jmissed = jax_pretrain_load.load_pretrained_encoder(
        jagent.params, str(path.parent))
    want = policy_state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             jnew))
    assert got.keys() == want.keys()
    for key, val in want.items():
        np.testing.assert_array_equal(got[key].numpy(), val, err_msg=key)
    changed = {k.split(".")[1] for k in got
               if not torch.equal(got[k], before[k])}
    assert changed >= {"embeddings", "text_layers", "add_layers",
                       "img_embedding"}
    assert ("tail" in changed) == (family == "bertadd_encoder")


@pytest.mark.parametrize("name", ["EncoderLSTM", "BertAdd"])
def test_jax_listener_file_loads(world, pairs, tmp_path, name):
    """The JAX agent's listener file (flax msgpack) read by the port's
    load: every tensor equal to load_jax_params of the same params."""
    jagent, agent = pairs("train", name)
    path = str(tmp_path / "listener")
    jagent.save(7, path)
    other = port_agent(world, **CONFIGS[name])
    torch.manual_seed(5)
    for p in other.policy.parameters():
        p.data.normal_()
    assert other.load(path) == 7
    got = other.policy.state_dict()
    for key, val in agent.policy.state_dict().items():
        assert torch.equal(got[key], val), key


def test_cli_trains_the_default_listener(world, tmp_path, capsys):
    """python -m dasa_tpu_torch.cli --train listener with no
    --encoderType: the Config default EncoderLSTM listener trains two
    iterations and validates on the CPU."""
    from dasa_tpu_torch.cli import main

    conn, data, _tok = world
    args = ["--device", "cpu", "--connectivity_dir", conn, "--data_dir",
            data, "--snap_dir", str(tmp_path / "snap"), "--log_dir",
            str(tmp_path / "log"), "--name", "plain", "--iters", "2",
            "--log_every", "2", "--val_every", "2", "--batchSize", "2",
            "--train", "listener", "--rnnDim", "32", "--wemb", "16",
            "--aemb", "8", "--critic_dim", "32", "--angle_feat_size", "8",
            "--feature_size", str(DIM), "--maxInput", str(L),
            "--max_candidates", "16", "--maxAction", "5", "--subout", "max",
            "--bidir", "0"]
    main(args)
    out = capsys.readouterr().out
    assert "PROGRESS: 2/2" in out
    assert Config().encoder_type == "EncoderLSTM"


@pytest.mark.parametrize("mode", ["ndh", "ndhlistener", "validndh"])
def test_ndh_modes_run(world, tmp_path, capsys, mode):
    """The NDH modes through the CLI on the CPU, at tiny widths, over
    CVDN dialogs written here (``testing.write_ndh_task``) on the
    synthetic world: ``ndh`` and ``ndhlistener`` train two iterations and
    validate, ``validndh`` validates; ``--history all`` sets max_input to
    300 and ``--path_type trusted_path`` max_action to 40."""
    from dasa_tpu_torch.cli import main
    from dasa_tpu_torch.testing import write_ndh_task

    conn, _data, _tok = world
    data = str(tmp_path / "ndh")
    write_ndh_task(data, SCANS[:1], SCANS[1:], conn, n_train=4, n_val=2,
                   dialog_words=60)
    main(["--device", "cpu", "--connectivity_dir", conn, "--data_dir",
          data, "--snap_dir", str(tmp_path / "snap"), "--log_dir",
          str(tmp_path / "log"), "--name", "ndh", "--iters", "2",
          "--log_every", "2", "--val_every", "2", "--batchSize", "2",
          "--train", mode, "--history", "all", "--path_type",
          "trusted_path", "--rnnDim", "32", "--wemb", "16", "--aemb", "8",
          "--critic_dim", "32", "--angle_feat_size", "8", "--feature_size",
          str(DIM), "--max_candidates", "16", "--subout", "max",
          "--bidir", "0"])
    out = capsys.readouterr().out
    assert '"max_input": 300' in out and '"max_action": 40' in out
    assert "val_unseen" in out
    if mode == "validndh":
        assert "Env name: val_seen" in out
    else:
        assert "PROGRESS: 2/2" in out
        assert os.path.exists(tmp_path / "snap" / "ndh" / "state_dict"
                              / "LAST_iter2")
