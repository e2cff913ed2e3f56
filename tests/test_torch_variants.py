"""The port's variant decoders and building blocks against the JAX
package.

Each flax decoder (the BAttn decoder's back / progress-monitor / DyReLU
heads, the Advanced / KVMem / New / Mutan / MT / double decoders) and the
DyReLU and fusion blocks are initialized with a fixed key; their params
go across with ``policy_state_dict_from_jax`` (strict), and the same numpy
inputs go through both in f32: the step's outputs, its aux outputs and
the gradients of a loss on them.  Also ``_pm_score`` for every
``pm_type``, ``mt_kl_rows``, the heads a decoder lacks, and the three
policies an earlier slice refused
(tests/test_torch_variants_policy.py holds whole policies and the agent).

Tolerance: rtol 1e-5, atol 1e-6 for a decoder step's outputs (atol 1e-5
for the Mutan decoder's, reason beside it); atol 1e-5 for gradients
(sums over the batch and the candidates).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasa_tpu.agents.seq2seq import mt_kl_rows as jax_mt_kl_rows
from dasa_tpu.config import Config as JaxConfig
from dasa_tpu.models import DasaPolicy as JaxPolicy
from dasa_tpu.models import StepInputs as JaxInputs
from dasa_tpu.models import decoder as jdecoder
from dasa_tpu.models import variants as jvariants
from dasa_tpu_torch.agents.seq2seq import mt_kl_rows
from dasa_tpu_torch.config import Config
from dasa_tpu_torch.models import decoder as tdecoder
from dasa_tpu_torch.models import variants as tvariants
from dasa_tpu_torch.models.policy import DasaPolicy, StepInputs
from dasa_tpu_torch.testing import torch_threads
from dasa_tpu_torch.utils.jax_params import policy_state_dict_from_jax

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
BASE = dict(encoder_type="Dic", include_vision=True, angle_feat_size=8,
            feature_size=24, max_input=12, d_enc_hidden_size=16,
            d_hidden_size=32, critic_dim=32, aemb=8, d_vl_layers=1,
            d_la_layers=1, max_candidates=6)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def ragged_mask(b, t):
    """True = valid; row j keeps its first t - j tokens."""
    return np.arange(t)[None, :] < (t - np.arange(b))[:, None]


def load_flax(module, variables, root="decoder"):
    state = policy_state_dict_from_jax({root: variables["params"]})
    module.load_state_dict({k[len(root) + 1:]: torch.from_numpy(v)
                            for k, v in state.items()})
    return module.eval()


def close(got, ref, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(ref, np.float32), **tol)


# ---------------------------------------------------------------------
# decoders, one step
# ---------------------------------------------------------------------
B, A, EMB, HID, FEAT, K, LEN = 3, 8, 8, 32, 32, 7, 9


def decoder_inputs(seed):
    rng = np.random.default_rng(seed)
    cand_n = np.array([2, 4, 6])
    cand_idx = np.where(np.arange(K)[None] >= cand_n[:, None], 36,
                        rng.integers(0, 36, (B, K)))
    return dict(action=rand(rng, B, A), feature=rand(rng, B, 36, FEAT),
                cand_feat=rand(rng, B, K, FEAT), prev_h1=rand(rng, B, HID),
                c_0=rand(rng, B, HID), ctx=rand(rng, B, LEN, HID),
                ctx_mask=~ragged_mask(B, LEN),
                v_emb=rand(rng, B, 36, 16), cand_idx=cand_idx,
                dfeature=rand(rng, B, 36, FEAT),
                cand_dfeat=rand(rng, B, K, FEAT),
                prev_h1_d=rand(rng, B, HID), c_0_d=rand(rng, B, HID))


def decoder_pair(kind, **kw):
    """(flax decoder, port decoder, names of the call's inputs)."""
    base = ("action", "feature", "cand_feat", "prev_h1", "c_0", "ctx",
            "ctx_mask")
    if kind == "battn":
        return (jdecoder.BAttnDecoderLSTM(EMB, HID, 0.0, 0.0, FEAT, A, HID,
                                          max_input=12, **kw),
                tdecoder.BAttnDecoderLSTM(EMB, HID, FEAT, A, HID,
                                          max_input=12, **kw), base)
    if kind == "double":
        names = ("action", "feature", "dfeature", "cand_feat", "cand_dfeat",
                 "prev_h1", "c_0", "prev_h1_d", "c_0_d", "ctx", "ctx_mask")
        return (jvariants.DoubleBAttnDecoderLSTM(EMB, HID, 0.0, 0.0, FEAT,
                                                 A, HID),
                tvariants.DoubleBAttnDecoderLSTM(EMB, HID, FEAT, A, HID),
                names)
    if kind == "mt":
        return (jvariants.MTDecoder(EMB, HID, 0.0, 0.0, FEAT, A, HID,
                                    vemb_dim=16),
                tvariants.MTDecoder(EMB, HID, FEAT, A, HID, vemb_dim=16),
                base + ("v_emb", "cand_idx"))
    jcls = {"advanced": jvariants.AdvancedDecoderLSTM,
            "kvmem": jvariants.KVMemAttnDecoderLSTM,
            "new": jvariants.NewAttnDecoderLSTM,
            "mutan": jvariants.MutanAttnDecoderLSTM}[kind]
    tcls = {"advanced": tvariants.AdvancedDecoderLSTM,
            "kvmem": tvariants.KVMemAttnDecoderLSTM,
            "new": tvariants.NewAttnDecoderLSTM,
            "mutan": tvariants.MutanAttnDecoderLSTM}[kind]
    return (jcls(EMB, HID, 0.0, 0.0, FEAT, A, HID, max_input=12, **kw),
            tcls(EMB, HID, FEAT, A, HID, max_input=12, **kw), base)


def flat_outputs(out):
    """A decoder's outputs as a list of arrays and a dict of its aux."""
    if len(out) == 4:  # double: (rgb state, depth state, logit, aux)
        (h, c, h1), (hd, cd, h1d), logit, aux = out
        return [h, c, h1, hd, cd, h1d, logit], aux
    h, c, logit, h1, aux = out
    return [h, c, logit, h1], aux


DECODERS = [
    ("battn", dict(pred_back=True, back_input="pre")),
    ("battn", dict(pred_back=True, back_input="cur", use_shift=True,
                   shift_kernel_size=5)),
    ("battn", dict(use_dyrelu=True, pred_pm=True, pm_type="att")),
    ("battn", dict(pred_pm=True, pm_type="att_hid", use_shift=True)),
    ("battn", dict(pred_pm=True, pm_type="plain_att")),
    ("battn", dict(pred_pm=True, pm_type="plain_att_hid",
                   use_dyrelu=True, pred_back=True)),
    ("advanced", dict(pred_back=True)), ("kvmem", dict(pred_back=True)),
    ("new", dict()), ("mutan", dict()), ("mt", dict()), ("double", dict()),
]


@pytest.mark.parametrize("kind,kw", DECODERS,
                         ids=[f"{k}-{i}" for i, (k, _) in
                              enumerate(DECODERS)])
def test_decoder_step_matches_flax(kind, kw):
    """One step: the outputs, every aux output (back_logit, pm_score,
    pred_progress, alpha), and the gradients of a random projection of
    them with respect to the parameters and the float inputs."""
    jmod, tmod, names = decoder_pair(kind, **kw)
    arrs = decoder_inputs(len(kind) + len(kw))
    jargs = [jnp.asarray(arrs[n]) for n in names]
    params = jmod.init(jax.random.PRNGKey(3), *jargs[:-2],
                       **dict(zip(names[-2:], jargs[-2:])))
    proj_rng = np.random.default_rng(11)

    def weights(outs, aux):
        return [rand(proj_rng, *np.shape(x))
                for x in outs + [aux[k] for k in sorted(aux)]]

    def jloss(params, floats):
        args = dict(zip(names, jargs))
        args.update(floats)
        outs, aux = flat_outputs(jmod.apply(
            params, *(args[n] for n in names[:-2]),
            **{n: args[n] for n in names[-2:]}))
        return outs, aux

    floats = {n: jnp.asarray(arrs[n]) for n in names
              if arrs[n].dtype == np.float32}
    outs, aux = jloss(params, floats)
    w = weights(outs, aux)

    def jscalar(params, floats):
        outs, aux = jloss(params, floats)
        return sum((x * wi).sum() for x, wi in
                   zip(outs + [aux[k] for k in sorted(aux)], w))

    gp, gin = jax.grad(jscalar, argnums=(0, 1))(params, floats)
    tmod = load_flax(tmod, params)
    targs = {n: torch.from_numpy(np.asarray(arrs[n])) for n in names}
    for n in floats:
        targs[n].requires_grad_()
    if "cand_idx" in targs:
        targs["cand_idx"] = targs["cand_idx"].long()
    t_outs, t_aux = flat_outputs(tmod(*(targs[n] for n in names[:-2]),
                                      **{n: targs[n] for n in names[-2:]}))
    assert sorted(t_aux) == sorted(aux)
    # the Mutan fusion sums 32 rank-1 products into each logit: f32
    # roundoff reached 4e-6 on logits of magnitude 2
    tol = dict(rtol=1e-5, atol=1e-5) if kind == "mutan" else TOL
    for got, ref in zip(t_outs + [t_aux[k] for k in sorted(t_aux)],
                        outs + [aux[k] for k in sorted(aux)]):
        close(got, ref, tol)
    sum((x * torch.from_numpy(wi)).sum() for x, wi in
        zip(t_outs + [t_aux[k] for k in sorted(t_aux)], w)).backward()
    for n in floats:  # the MT decoder reads no candidate features
        grad = targs[n].grad
        close(torch.zeros_like(targs[n]) if grad is None else grad, gin[n],
              GRAD_TOL)
    ref_grads = policy_state_dict_from_jax({"decoder": gp["params"]})
    for pname, p in tmod.named_parameters():
        if p.requires_grad:
            grad = torch.zeros_like(p) if p.grad is None else p.grad
            close(grad, ref_grads[f"decoder.{pname}"], GRAD_TOL)


@pytest.mark.parametrize("pm_type", ["att", "att_hid", "plain_att",
                                     "plain_att_hid"])
def test_pm_score_matches_flax(pm_type):
    """_pm_score alone on a ragged mask: each row's valid prefix (9, 6, 1
    tokens: the last clamps to 2) resampled to the full width (the att
    types), padded to max_input 12, with the dropped h_tilde appended
    (the *_hid types)."""
    rng = np.random.default_rng(5)
    length = 9
    alpha = np.abs(rand(rng, B, length))
    mask = ~(np.arange(length)[None] < np.array([9, 6, 1])[:, None])
    alpha = np.where(mask, 0.0, alpha / alpha.sum(-1, keepdims=True)
                     ).astype(np.float32)
    h = rand(rng, B, HID)
    jmod = jdecoder.BAttnDecoderLSTM(EMB, HID, 0.0, 0.0, FEAT, A, HID,
                                     pred_pm=True, pm_type=pm_type,
                                     max_input=12)
    arrs = decoder_inputs(0)
    params = jmod.init(jax.random.PRNGKey(5), *(jnp.asarray(arrs[n]) for n in
                                               ("action", "feature",
                                                "cand_feat", "prev_h1",
                                                "c_0", "ctx", "ctx_mask")))
    ref = jmod.apply(params, jnp.asarray(alpha), jnp.asarray(mask),
                     jnp.asarray(h), method=jdecoder.BAttnDecoderLSTM
                     ._pm_score)
    tmod = load_flax(tdecoder.BAttnDecoderLSTM(
        EMB, HID, FEAT, A, HID, pred_pm=True, pm_type=pm_type,
        max_input=12), params)
    got = tmod._pm_score(torch.from_numpy(alpha), torch.from_numpy(mask),
                         torch.from_numpy(h))
    close(got, ref)


@pytest.mark.parametrize("per_channel", [False, True])
def test_lang_dyrelu_matches_flax(per_channel):
    rng = np.random.default_rng(6)
    x, q = rand(rng, 2, 5, 12), rand(rng, 2, 10)
    make_j = jvariants.lang_dyrelu_c if per_channel \
        else jvariants.lang_dyrelu_a
    make_t = tvariants.lang_dyrelu_c if per_channel \
        else tvariants.lang_dyrelu_a
    jmod = make_j(12)
    params = jmod.init(jax.random.PRNGKey(6), jnp.asarray(x), jnp.asarray(q))
    tmod = load_flax(make_t(12, 10), params, root="dyrelu1")
    close(tmod(torch.from_numpy(x), torch.from_numpy(q)),
          jmod.apply(params, jnp.asarray(x), jnp.asarray(q)))


@pytest.mark.parametrize("kind", ["mlb", "mutan"])
def test_fusions_match_flax(kind):
    rng = np.random.default_rng(7)
    v, q = rand(rng, 3, 12), rand(rng, 3, 10)
    if kind == "mlb":
        jmod, tmod = jvariants.MLBFusion(8), tvariants.MLBFusion(12, 10, 8)
    else:
        jmod = jvariants.MutanFusion(9, 7, 6, rank=3)
        tmod = tvariants.MutanFusion(12, 10, 9, 7, 6, rank=3)
    params = jmod.init(jax.random.PRNGKey(7), jnp.asarray(v), jnp.asarray(q))
    tmod = load_flax(tmod, params, root="mutan")
    close(tmod(torch.from_numpy(v), torch.from_numpy(q)),
          jmod.apply(params, jnp.asarray(v), jnp.asarray(q)))


@pytest.mark.parametrize("kw,match", [
    (dict(agent_type="mcatt"), "mcatt"),
    (dict(encoder_type="EncoderLSTM"), "EncoderLSTM"),
    (dict(encoder_type="BertAdd"), "BertAdd")])
def test_unported_policies_raise(kw, match):
    """The mcatt agent, the plain encoders and the legacy encoders, which
    an earlier slice refused, now build with their own encoder and give
    the JAX policy's first-step logits and value (same weights; rtol and
    atol 1e-4 where the 768-wide BERT is in the path,
    tests/test_torch_models.py's reason)."""
    encoder = {"mcatt": "McattEncoder", "EncoderLSTM": "EncoderLSTM",
               "BertAdd": "BertAddEncoder"}[match]
    # the MCAN narrowed as the BERT is (only mcatt reads these fields)
    kw = {**BASE, "mcan_hidden_size": 64, "mcan_heads": 2, "mcan_layers": 1,
          "mcan_flat_mlp_size": 32, **kw, "use_pallas": "never"}
    policy = DasaPolicy(Config(**kw), vocab_size=100).eval()
    assert type(policy.encoder).__name__ == encoder
    rng = np.random.default_rng(9)
    f_all, length, k = policy.cfg.feature_all_size, 12, 6
    arrs = [np.abs(rand(rng, *s)) for s in ((B, 8), (B, 36, f_all),
                                            (B, 36, f_all), (B, k, f_all),
                                            (B, k, f_all))]
    mask = np.arange(k)[None] > np.array([2, 4, 5])[:, None]
    instr = rng.integers(1, 100, (B, length))
    valid = ragged_mask(B, length)
    jpol = JaxPolicy(JaxConfig(**kw), vocab_size=100)
    jargs = (jnp.asarray(instr, jnp.int32), jnp.asarray(valid),
             jnp.asarray(valid.sum(1), jnp.int32),
             JaxInputs(*map(jnp.asarray, arrs), jnp.asarray(mask)))
    params = jpol.init({"params": jax.random.PRNGKey(0),
                        "dropout": jax.random.PRNGKey(1)}, *jargs)
    policy.load_state_dict({n: torch.from_numpy(v) for n, v in
                            policy_state_dict_from_jax(jax.tree_util.tree_map(
                                np.asarray, params)).items()})
    ref = jpol.apply(params, *jargs)
    with torch.no_grad():
        got = policy(torch.from_numpy(instr), torch.from_numpy(valid),
                     torch.from_numpy(valid.sum(1)),
                     StepInputs(*map(torch.from_numpy, arrs),
                                torch.from_numpy(mask)))
    for g, r in zip(got, ref):
        close(g, r, dict(rtol=1e-4, atol=1e-4))


@pytest.mark.parametrize("kw", [
    dict(agent_type="mutan", pred_back=True),
    dict(agent_type="double", pred_back=True),
    dict(agent_type="advanced", pred_pm=True)])
def test_missing_heads_raise_at_construction(kw):
    """A loss term whose head the agent's decoder lacks is refused when
    the policy is built (the JAX agent fails at its first training step
    with a KeyError)."""
    with pytest.raises(ValueError, match="no head"):
        DasaPolicy(Config(**{**BASE, **kw}))


# ---------------------------------------------------------------------
# the agent's pieces
# ---------------------------------------------------------------------
def test_mt_kl_rows_matches_jax():
    rng = np.random.default_rng(8)
    b, k = 6, 9
    logits = rand(rng, b, k)
    cand_n = rng.integers(1, k, b)
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(np.where(
        np.arange(k)[None] > cand_n[:, None], -1e9, logits)), -1))
    teacher = np.minimum(rng.integers(0, k, b), cand_n)
    cand_point = rng.integers(0, 36, (b, k))
    has_row = rng.random(b) < 0.8
    ref = jax_mt_kl_rows(*(jnp.asarray(x) for x in (
        logp, teacher, cand_point, cand_n, has_row)))
    got = mt_kl_rows(*(torch.from_numpy(np.asarray(x)) for x in (
        logp, teacher, cand_point, cand_n, has_row)))
    for g, r in zip(got, ref):
        close(g, r, dict(rtol=1e-5, atol=1e-6))
    assert float(got[1].sum()) > 0
