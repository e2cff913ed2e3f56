"""The port's encoder zoo, module by module, against the JAX package.

Each flax module (DicModel's ``collect_last_n`` text stack, EncoderLSTM,
B/CEncoderLSTM, MultiDicEncoder and ``merge_sentence_attention``,
AttnDecoderLSTM, the legacy LstmTail / Transformer / Gpt / BertImg /
BertAdd / BertMix encoders, the MCAN blocks and McattEncoder, and
McattDecoder) is initialized with a fixed key; its params go across with
``policy_state_dict_from_jax``, and the same numpy inputs go through both
in f32, dropout off: the outputs, and the gradients of a random
projection of them with respect to every parameter and float input
(a frozen stack's parameters: zero in JAX, no gradient in the port).
Also Gpt's causality, BertMix's text-only ctx, and the masked positions
of AttFlat and SA.

Tolerance: rtol 1e-5, atol 1e-6 for outputs; atol 1e-5 for gradients
(sums over the batch and the tokens), 1e-4 for those of the stacks
that attend over the 36 views (reason at JOINT_GRAD_TOL).  The BERT
widths are 64 (2 heads), the legacy width 32, MCAN 64 with 2 heads.
"""

from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasa_tpu.models import bert as jbert
from dasa_tpu.models import decoder as jdecoder
from dasa_tpu.models import encoder as jencoder
from dasa_tpu.models import legacy as jlegacy
from dasa_tpu.models import mcan as jmcan
from dasa_tpu.models import variants as jvariants
from dasa_tpu.models.layers import SoftDotAttention as JaxSoftDot
from dasa_tpu_torch.models import bert as tbert
from dasa_tpu_torch.models import decoder as tdecoder
from dasa_tpu_torch.models import encoder as tencoder
from dasa_tpu_torch.models import legacy as tlegacy
from dasa_tpu_torch.models import mcan as tmcan
from dasa_tpu_torch.models import variants as tvariants
from dasa_tpu_torch.models.layers import SoftDotAttention
from dasa_tpu_torch.testing import torch_threads
from dasa_tpu_torch.utils.jax_params import policy_state_dict_from_jax

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
# the parameter gradients of the stacks that attend over the 36 views
# (the joint [views; tokens] BERTs, the MCAN co-attention) reach magnitude
# 10-40; f32 roundoff of their sums over 3 x 46 rows reached 1.5e-5
JOINT_GRAD_TOL = dict(rtol=1e-5, atol=1e-4)
B, L, V, F = 3, 10, 50, 24
BERT = dict(vocab_size=V, hidden_size=64, num_attention_heads=2,
            intermediate_size=128, la_layers=2, vl_layers=1,
            img_feature_dim=F, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def ragged_mask(b, t):
    """True = valid; row j keeps its first t - 2j tokens."""
    return np.arange(t)[None, :] < (t - 2 * np.arange(b))[:, None]


def tokens(rng, b=B, length=L):
    return rng.integers(1, V, (b, length))


def load_flax(module, variables, root="m"):
    state = policy_state_dict_from_jax({root: variables["params"]})
    module.load_state_dict({k[len(root) + 1:]: torch.from_numpy(v)
                            for k, v in state.items()})
    return module.eval()


def close(got, ref, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(ref, np.float32), **tol)


def arrays(out):
    """A module's outputs as a list, its Nones and aux dicts dropped."""
    out = out if isinstance(out, tuple) else (out,)
    return [x for x in out if x is not None and not isinstance(x, Mapping)]


def parity(jmod, tmod, args, floats=(), method=None, tmethod=None,
           tol=TOL, init_args=None, root="m", params=None,
           grad_tol=GRAD_TOL, **kw):
    """Run ``jmod`` (its ``params``, or init from ``init_args`` or
    ``args``) and ``tmod`` on
    the same numpy ``args``: equal outputs (a tuple, Nones dropped), then
    the gradients of a random projection of them, for the params and the
    float args named by index in ``floats``.  ``root`` is the module's
    name in the policy (a decoder's renames apply under ``decoder``).
    Returns the port's outputs."""
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    if params is not None:
        pass
    elif init_args is None:
        params = jmod.init(jax.random.PRNGKey(5), *jargs, method=method,
                           **kw)
    else:  # the whole module's params, from its __call__
        params = jmod.init(jax.random.PRNGKey(5), *init_args)
    tmod = load_flax(tmod, params, root)
    tmod.zero_grad(set_to_none=True)

    def jrun(p, fl):
        a = list(jargs)
        for i, x in zip(floats, fl):
            a[i] = x
        return arrays(jmod.apply(p, *a, method=method, **kw))

    fl = [jargs[i] for i in floats]
    outs = jrun(params, fl)
    wrng = np.random.default_rng(17)
    w = [rand(wrng, *np.shape(x)) for x in outs]
    gp, gin = jax.grad(lambda p, f: sum(
        (x * wi).sum() for x, wi in zip(jrun(p, f), w)), argnums=(0, 1))(
        params, fl)
    targs = [None if a is None else torch.from_numpy(np.array(a))
             for a in args]
    for i in floats:
        targs[i].requires_grad_()
    tfn = tmod if tmethod is None else getattr(tmod, tmethod)
    t_outs = arrays(tfn(*targs, **kw))
    assert len(t_outs) == len(outs)
    for got, ref in zip(t_outs, outs):
        close(got, ref, tol)
    scalar = sum((x * torch.from_numpy(wi)).sum()
                 for x, wi in zip(t_outs, w))
    if scalar.requires_grad:  # else a frozen stack: no graph at all
        scalar.backward()
    grads = policy_state_dict_from_jax({root: gp["params"]})
    for name, p in tmod.named_parameters():
        ref = grads[f"{root}.{name}"]
        if p.grad is None:  # frozen, or the JAX cell's folded bias_hh
            np.testing.assert_array_equal(ref, 0.0, err_msg=name)
        else:
            close(p.grad, ref, grad_tol)
    for i, g in zip(floats, gin):
        close(targs[i].grad, g, grad_tol)
    return t_outs


# ---------------------------------------------------------------------
# models/bert.py and models/encoder.py
# ---------------------------------------------------------------------
@pytest.mark.parametrize("n", [2])
def test_text_forward_collect_last_n(n):
    """The channel concat of the last n layers' outputs, trained
    (update_lang_bert) so that gradients reach every layer."""
    rng = np.random.default_rng(n)
    cfg = dict(BERT, update_lang_bert=True)
    ids, valid = tokens(rng), ragged_mask(B, L).astype(np.int32)
    out = parity(jbert.DicModel(jbert.BertConfig(**cfg)),
                 tbert.DicModel(tbert.BertConfig(**cfg), text_only=True),
                 (ids, valid), method=jbert.DicModel.text_forward,
                 tmethod="text_forward", collect_last_n=n)
    assert out[0].shape == (B, L, 64 * n)


ENCODER_LSTM = [dict(), dict(bidirectional=False, sub_out="max"),
                dict(zero_init=True)]


@pytest.mark.parametrize("kw", ENCODER_LSTM,
                         ids=["bi-tanh", "uni-max", "zero-init"])
def test_encoder_lstm(kw):
    rng = np.random.default_rng(1)
    parity(jencoder.EncoderLSTM(V, 16, 12, 0.0, **kw),
           tencoder.EncoderLSTM(V, 16, 12, **kw),
           (tokens(rng), ragged_mask(B, L)))


@pytest.mark.parametrize("variant", ["B", "C-update", "B-n2-uni"])
def test_bert_text_encoder_lstm(variant):
    """B (frozen BERT), C (the linear_in projection, BERT trained) and B
    over the concat of the last two layers with one LSTM direction."""
    rng = np.random.default_rng(2)
    cfg = dict(BERT, update_lang_bert=variant == "C-update")
    kw = dict(project_dim=16 if variant.startswith("C") else None,
              n_layer_concat=2 if "n2" in variant else 1,
              bidirectional="uni" not in variant)
    parity(jencoder.BertTextEncoderLSTM(jbert.BertConfig(**cfg), 12, 0.0,
                                        **kw),
           tencoder.BertTextEncoderLSTM(tbert.BertConfig(**cfg), 12, **kw),
           (tokens(rng), ragged_mask(B, L)))


def test_multi_dic_encoder():
    """Three instructions a row through one DicEncoder: the text stack,
    then the per-sentence contexts and the averaged init states."""
    rng = np.random.default_rng(3)
    s = 3
    cfg = jbert.BertConfig(**BERT)
    jmod = jencoder.MultiDicEncoder(cfg, 16, 24, 0.0)
    tmod = tencoder.MultiDicEncoder(tbert.BertConfig(**BERT), 16, 24)
    ids = rng.integers(1, V, (B, s, L))
    valid = np.stack([ragged_mask(B, L)[::-1], ragged_mask(B, L),
                      ragged_mask(B, L)], 1)
    seq = valid.sum(-1)
    f = rand(rng, B, 36, F)
    jtext = (jnp.asarray(ids), jnp.asarray(valid))
    text_p = jmod.init(jax.random.PRNGKey(0), *jtext,
                       method=jencoder.MultiDicEncoder.text_forward)
    embeds = jmod.apply(text_p, *jtext,
                        method=jencoder.MultiDicEncoder.text_forward)
    params = jmod.init(jax.random.PRNGKey(0), embeds, jnp.asarray(valid),
                       jnp.asarray(seq), jnp.asarray(f))
    # the text stack's params come from text_forward alone
    bert = params["params"]["inner"]["bert"]
    bert.update(text_p["params"]["inner"]["bert"])
    tmod = load_flax(tmod, params)
    t_embeds = tmod.text_forward(torch.from_numpy(ids),
                                 torch.from_numpy(valid))
    close(t_embeds, embeds)
    outs = jmod.apply(params, embeds, jnp.asarray(valid), jnp.asarray(seq),
                      jnp.asarray(f))
    t_outs = tmod(t_embeds, torch.from_numpy(valid), torch.from_numpy(seq),
                  torch.from_numpy(f))
    assert t_outs[0].shape == (B, s, L, 32)
    for got, ref in zip(t_outs, outs):
        close(got, ref)


@pytest.mark.parametrize("merge", ["mean", "sum", "max", "cat"])
def test_merge_sentence_attention(merge):
    rng = np.random.default_rng(4)
    s, hid, cdim = 3, 8, 12
    h, ctxs = rand(rng, B, hid), rand(rng, B, s, L, cdim)
    valid = np.stack([ragged_mask(B, L)] * s, 1)
    valid[:, 1, -3:] = False
    jatt = JaxSoftDot(hid, cdim)
    params = jatt.init(jax.random.PRNGKey(1), jnp.asarray(h),
                       jnp.asarray(ctxs[:, 0]))
    tatt = load_flax(SoftDotAttention(hid, cdim), params)
    ref, ref_attn = jencoder.merge_sentence_attention(
        lambda q, c, m: jatt.apply(params, q, c, m), jnp.asarray(h),
        jnp.asarray(ctxs), jnp.asarray(valid), merge)
    got, attn = tencoder.merge_sentence_attention(
        tatt, torch.from_numpy(h), torch.from_numpy(ctxs),
        torch.from_numpy(valid), merge)
    close(got, ref)
    for g, r in zip(attn, ref_attn):
        close(g, r)


# ---------------------------------------------------------------------
# models/decoder.py and models/variants.py: the plain decoder steps
# ---------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["attn", "mcatt"])
def test_plain_decoder_steps(kind):
    """AttnDecoderLSTM and McattDecoder: the state, the logits and h_tilde
    (no aux), instruction attention at the hidden width."""
    rng = np.random.default_rng(5)
    emb, hid, feat, a, k = 8, 16, 20, 8, 6
    args = (rand(rng, B, a), rand(rng, B, 36, feat), rand(rng, B, k, feat),
            rand(rng, B, hid), rand(rng, B, hid), rand(rng, B, L, hid),
            ~ragged_mask(B, L))
    if kind == "attn":
        jmod = jdecoder.AttnDecoderLSTM(emb, hid, 0.0, 0.0, feat, a, hid)
        tmod = tdecoder.AttnDecoderLSTM(emb, hid, feat, a, hid)
    else:
        jmod = jvariants.McattDecoder(emb, hid, 0.0, 0.0, feat, a, hid,
                                      max_input=L)
        tmod = tvariants.McattDecoder(emb, hid, feat, a, hid, max_input=L)
    out = jmod.init_with_output(jax.random.PRNGKey(2),
                                *map(jnp.asarray, args))[0]
    assert out[-1] == {}
    parity(jmod, tmod, args, floats=(0, 1, 2, 3, 4, 5), root="decoder")
    assert tmod(*map(torch.from_numpy, args))[-1] == {}


# ---------------------------------------------------------------------
# models/legacy.py
# ---------------------------------------------------------------------
@pytest.mark.parametrize("bidir,dec", [(True, 24), (True, 32)])
def test_lstm_tail(bidir, dec):
    """encoder2decoder_ct exists only where hidden * directions differs
    from the decoder width."""
    rng = np.random.default_rng(6)
    tmod = tlegacy.LstmTail(20, 12, dec, bidirectional=bidir)
    assert hasattr(tmod, "encoder2decoder_ct") == (
        12 * (2 if bidir else 1) != dec)
    parity(jlegacy.LstmTail(12, dec, 0.0, bidir), tmod,
           (rand(rng, B, L, 20), ragged_mask(B, L)), floats=(0,))


@pytest.mark.parametrize("causal", [False, True], ids=["transformer", "gpt"])
def test_transformer_text_encoder(causal):
    rng = np.random.default_rng(7)
    kw = dict(vocab_size=V, width=32, heads=2, n_layers=2, hidden_size=12,
              dec_hidden_size=24)
    parity(jlegacy.TransformerTextEncoder(**kw, dropout_ratio=0.0,
                                          causal=causal),
           tlegacy.TransformerTextEncoder(**kw, causal=causal),
           (tokens(rng), ragged_mask(B, L)))


def test_gpt_is_causal():
    """A token's encoding under Gpt does not change when a later token
    does (one LSTM direction, so the whole encoder runs left to right);
    the Transformer's does."""
    rng = np.random.default_rng(8)
    ids = tokens(rng)
    mutated = ids.copy()
    mutated[:, -1] = mutated[:, -1] % (V - 1) + 1
    valid = torch.ones(B, L, dtype=torch.bool)
    for causal in (True, False):
        torch.manual_seed(0)
        enc = tlegacy.TransformerTextEncoder(V, 32, 2, 2, 12, 12,
                                             bidirectional=False,
                                             causal=causal).eval()
        with torch.no_grad():
            c1 = enc(torch.from_numpy(ids), valid)[0]
            c2 = enc(torch.from_numpy(mutated), valid)[0]
        diff = float((c1[:, :-1] - c2[:, :-1]).abs().max())
        assert (diff == 0.0) if causal else (diff > 1e-6)


@pytest.mark.parametrize("kind", ["BertImg", "BertAdd", "BertMix"])
def test_legacy_cross_encoders(kind):
    """text_forward (the cached half), then the per-step joint stack and
    tail: ctx over the joint [36 views; L tokens], or for BertMix over the
    tokens only; the vision rows; the init states."""
    rng = np.random.default_rng(9)
    cfg = dict(BERT, update_lang_bert=kind == "BertAdd")
    ids, valid = tokens(rng), ragged_mask(B, L)
    if kind == "BertImg":
        jmod = jlegacy.BertImgEncoder(jbert.BertConfig(**cfg), 12, 24, 0.0)
        tmod = tlegacy.BertImgEncoder(tbert.BertConfig(**cfg), 12, 24)
    else:
        strip = kind == "BertMix"
        jmod = jlegacy.BertAddEncoder(jbert.BertConfig(**cfg), 12, 24, 0.0,
                                      strip_vision_ctx=strip)
        tmod = tlegacy.BertAddEncoder(tbert.BertConfig(**cfg), 12, 24,
                                      strip_vision_ctx=strip)
    jtext = (jnp.asarray(ids), jnp.asarray(valid))
    text_p = jmod.init(jax.random.PRNGKey(3), *jtext,
                       method=type(jmod).text_forward)
    embeds = np.asarray(jmod.apply(text_p, *jtext,
                                   method=type(jmod).text_forward))
    f = rand(rng, B, 36, F)
    params = jmod.init(jax.random.PRNGKey(3), jnp.asarray(embeds),
                       jnp.asarray(valid), jnp.asarray(valid.sum(1)),
                       jnp.asarray(f))
    params["params"].update(text_p["params"])  # the embeddings, text stack
    parity(jmod, tmod, (ids, valid), method=type(jmod).text_forward,
           tmethod="text_forward", params=params)
    outs = parity(jmod, tmod, (embeds, valid, valid.sum(1), f),
                  floats=(0, 3), params=params, grad_tol=JOINT_GRAD_TOL)
    ctx_len = L if kind == "BertMix" else 36 + L
    assert outs[0].shape == (B, ctx_len, 24)
    assert outs[-1].shape == (B, 36, 64)


# ---------------------------------------------------------------------
# models/mcan.py
# ---------------------------------------------------------------------
MH, HEADS = 64, 2


def test_mhatt_and_ffn():
    rng = np.random.default_rng(10)
    x, y = rand(rng, B, L, MH), rand(rng, B, 36, MH)
    mask = ~ragged_mask(B, L)[:, None, None, :]
    parity(jmcan.MHAtt(MH, HEADS, 0.0), tmcan.MHAtt(MH, HEADS, 0.0),
           (x, x, y, mask), floats=(0, 1, 2))
    parity(jmcan.FFN(MH, 2 * MH, 0.0), tmcan.FFN(MH, 2 * MH, MH, 0.0),
           (x,), floats=(0,), root="ffn")


def test_sa_sga_and_backbone():
    rng = np.random.default_rng(11)
    x, y = rand(rng, B, L, MH), rand(rng, B, 36, MH)
    x_mask = ~ragged_mask(B, L)[:, None, None, :]
    y_mask = np.zeros((B, 1, 1, 36), bool)
    parity(jmcan.SA(MH, HEADS, 2 * MH, 0.0), tmcan.SA(MH, HEADS, 2 * MH, 0.0),
           (x, x_mask), floats=(0,))
    parity(jmcan.SGA(MH, HEADS, 2 * MH, 0.0),
           tmcan.SGA(MH, HEADS, 2 * MH, 0.0), (x, y, x_mask, y_mask),
           floats=(0, 1))
    parity(jmcan.MCASGASGA(MH, HEADS, 2 * MH, 2, 0.0),
           tmcan.MCASGASGA(MH, HEADS, 2 * MH, 2, 0.0),
           (x, y, x_mask, y_mask), floats=(0, 1))


def test_masked_positions_do_not_leak():
    """AttFlat and SA ignore what sits at masked tokens: changing the
    padded positions of x changes neither AttFlat's vector nor SA's
    outputs at the valid tokens; and AttFlat equals the JAX module."""
    rng = np.random.default_rng(12)
    x = rand(rng, B, L, MH)
    valid = ragged_mask(B, L)
    mask = ~valid[:, None, None, :]
    parity(jmcan.AttFlat(MH, 32, 48, dropout=0.0),
           tmcan.AttFlat(MH, 32, 48, rate=0.0), (x, mask), floats=(0,),
           root="attflat_lang")
    x2 = np.where(valid[..., None], x, rand(rng, B, L, MH) * 50)
    torch.manual_seed(0)
    flat = tmcan.AttFlat(MH, 32, 48, rate=0.0)
    sa = tmcan.SA(MH, HEADS, 2 * MH, 0.0)
    tm = torch.from_numpy(mask)
    with torch.no_grad():
        close(flat(torch.from_numpy(x2), tm), flat(torch.from_numpy(x), tm))
        v = torch.from_numpy(valid)
        close(sa(torch.from_numpy(x2), tm)[v], sa(torch.from_numpy(x), tm)[v],
              dict(rtol=1e-5, atol=1e-5))


def test_mcatt_encoder():
    """text_forward (embedding + BiLSTM at 32 a direction), then
    cross_forward: the token stream, the flat text, the vision stream and
    the attended vision."""
    rng = np.random.default_rng(13)
    kw = dict(vocab_size=V, word_embed_size=16, hidden_size=MH,
              n_head=HEADS, ff_size=4 * MH, n_layers=2, img_feat_size=F,
              flat_mlp_size=32, flat_out_size=MH)
    jmod, tmod = jmcan.McattEncoder(**kw, dropout=0.0), tmcan.McattEncoder(
        **kw, rate=0.0)
    ids, pad = tokens(rng), ~ragged_mask(B, L)
    f = rand(rng, B, 36, F)
    init = tuple(map(jnp.asarray, (ids, pad, f)))
    x = parity(jmod, tmod, (ids, pad), method=jmcan.McattEncoder.text_forward,
               tmethod="text_forward", init_args=init)[0]
    assert x.shape == (B, L, MH)
    parity(jmod, tmod, (x.detach().numpy(), pad, f), floats=(0, 2),
           method=jmcan.McattEncoder.cross_forward, tmethod="cross_forward",
           init_args=init, grad_tol=JOINT_GRAD_TOL)
