"""The PyTorch port's modules against the JAX package's flax modules.

Each flax module is initialized with a fixed key, its params are carried
into the port with ``policy_state_dict_from_jax`` (a strict
``load_state_dict``, so the port's parameter names and shapes must cover
the JAX tree exactly), and the same numpy inputs go through both, in f32.
Tolerance: atol 1e-5 for the LSTM and attention layers; 1e-4 where the
768-wide BERT stack is in the path, whose 768- and 3072-long f32 sums
(LayerNorm, FFN) round differently in XLA and in PyTorch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasa_tpu.models import adain as jadain
from dasa_tpu.models import bert as jbert
from dasa_tpu.models import decoder as jdecoder
from dasa_tpu.models import encoder as jencoder
from dasa_tpu.models import layers as jlayers
from dasa_tpu_torch.models import adain as tadain
from dasa_tpu_torch.models import bert as tbert
from dasa_tpu_torch.models import decoder as tdecoder
from dasa_tpu_torch.models import encoder as tencoder
from dasa_tpu_torch.models import layers as tlayers
from dasa_tpu_torch.utils.jax_params import policy_state_dict_from_jax


def load_flax(module, variables, root="m"):
    """Carry flax variables into a port module (strict)."""
    state = policy_state_dict_from_jax({root: variables["params"]})
    module.load_state_dict({k[len(root) + 1:]: torch.from_numpy(v)
                            for k, v in state.items()})
    return module.eval()


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def close(got, ref, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=rtol)


def ragged_mask(b, t):
    """True = valid; row j keeps its first t - j tokens."""
    return np.arange(t)[None, :] < (t - np.arange(b))[:, None]


@pytest.mark.parametrize("kernel", [False, True])
def test_bilstm_matches_flax(kernel):
    rng = np.random.default_rng(0)
    b, t, d, h = 3, 7, 6, 8
    x, mask = rand(rng, b, t, d), ragged_mask(b, t)
    jmod = jlayers.BiLSTM(h)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                       jnp.asarray(mask))
    j_ctx, (j_h, j_c) = jmod.apply(params, jnp.asarray(x), jnp.asarray(mask),
                                   pallas=kernel)
    tmod = load_flax(tlayers.BiLSTM(h, d), params)
    t_ctx, (t_h, t_c) = tmod(torch.from_numpy(x), torch.from_numpy(mask),
                             kernel=kernel)
    close(t_ctx, j_ctx)
    close(t_h, j_h)
    close(t_c, j_c)


@pytest.mark.parametrize("tilde,prob,masked", [
    (True, True, True), (False, False, True), (True, True, False)])
def test_soft_dot_attention_matches_flax(tilde, prob, masked):
    rng = np.random.default_rng(1)
    b, l, dim, cdim = 3, 9, 12, 20
    h, ctx = rand(rng, b, dim), rand(rng, b, l, cdim)
    mask = ~ragged_mask(b, l) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    jmod = jlayers.SoftDotAttention(dim, cdim)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(h),
                       jnp.asarray(ctx), jmask, output_tilde=tilde)
    j_out, j_attn = jmod.apply(params, jnp.asarray(h), jnp.asarray(ctx),
                               jmask, output_tilde=tilde, output_prob=prob)
    tmod = load_flax(tlayers.SoftDotAttention(dim, cdim, with_tilde=tilde),
                     params)
    t_out, t_attn = tmod(torch.from_numpy(h), torch.from_numpy(ctx),
                         None if mask is None else torch.from_numpy(mask),
                         output_tilde=tilde, output_prob=prob)
    close(t_out, j_out)
    close(t_attn, j_attn)


@pytest.mark.parametrize("kernel,tilde,masked", [
    (False, False, False), (True, False, False), (True, True, False),
    (False, True, True)])
def test_shift_attention_matches_flax(kernel, tilde, masked):
    rng = np.random.default_rng(2)
    b, dim, cdim = 3, 16, 24
    h, ctx = rand(rng, b, dim), rand(rng, b, 36, cdim)
    mask = ~ragged_mask(b, 36) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    jmod = jlayers.ShiftSoftDotAttention(dim, cdim, 5, use_pallas=kernel)
    params = jmod.init(jax.random.PRNGKey(2), jnp.asarray(h),
                       jnp.asarray(ctx), jmask, output_tilde=tilde)
    j_out, j_attn = jmod.apply(params, jnp.asarray(h), jnp.asarray(ctx),
                               jmask, output_tilde=tilde)
    tmod = load_flax(tlayers.ShiftSoftDotAttention(
        dim, cdim, 5, use_kernel=kernel, with_tilde=tilde), params)
    t_out, t_attn = tmod(torch.from_numpy(h), torch.from_numpy(ctx),
                         None if mask is None else torch.from_numpy(mask),
                         output_tilde=tilde)
    close(t_out, j_out)
    close(t_attn, j_attn)


def _bias(mask):
    return jbert.extended_attention_mask(jnp.asarray(mask), jnp.float32)


def test_bert_layer_matches_flax():
    rng = np.random.default_rng(3)
    cfg = jbert.BertConfig.base()
    x, mask = rand(rng, 2, 8, 768), ragged_mask(2, 8).astype(np.int32)
    jmod = jbert.BertLayer(cfg)
    params = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x), _bias(mask))
    ref = jmod.apply(params, jnp.asarray(x), _bias(mask))
    tmod = load_flax(tbert.BertLayer(tbert.BertConfig.base()), params)
    got = tmod(torch.from_numpy(x), tbert.extended_attention_mask(
        torch.from_numpy(mask), torch.float32))
    close(got, ref, atol=1e-4, rtol=1e-4)


def test_lxrt_layer_matches_flax():
    rng = np.random.default_rng(4)
    cfg = jbert.BertConfig.base()
    lang, visn = rand(rng, 2, 8, 768), rand(rng, 2, 36, 768)
    mask = ragged_mask(2, 8).astype(np.int32)
    jmod = jbert.LXRTXLayer(cfg)
    args = (jnp.asarray(lang), _bias(mask), jnp.asarray(visn), None)
    params = jmod.init(jax.random.PRNGKey(4), *args)
    j_lang, j_visn = jmod.apply(params, *args)
    tmod = load_flax(tbert.LXRTXLayer(tbert.BertConfig.base()), params)
    t_lang, t_visn = tmod(torch.from_numpy(lang),
                          tbert.extended_attention_mask(
                              torch.from_numpy(mask), torch.float32),
                          torch.from_numpy(visn), None)
    close(t_lang, j_lang, atol=1e-4, rtol=1e-4)
    close(t_visn, j_visn, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dec_hidden,kernel", [(32, False), (48, True)])
def test_dic_encoder_matches_flax(dec_hidden, kernel):
    """Text stack, cross layer, reversal, top BiLSTM, projections (the
    c_t projection exists only when 2 * hidden != dec_hidden)."""
    rng = np.random.default_rng(5)
    b, l, feat = 2, 10, 32
    kw = dict(la_layers=1, vl_layers=1, img_feature_dim=feat)
    ids = rng.integers(1, 200, (b, l)).astype(np.int32)
    valid = ragged_mask(b, l)
    seq_len = valid.sum(1).astype(np.int32)
    f_t = rand(rng, b, 36, feat)
    jmod = jencoder.DicEncoder(jbert.BertConfig.base(**kw), 16, dec_hidden,
                               0.0)

    def full(mod, ids, valid, seq_len, f_t, lstm_pallas=False):
        return mod(mod.text_forward(ids, valid), valid, seq_len, f_t,
                   lstm_pallas=lstm_pallas)

    jargs = tuple(jnp.asarray(a) for a in (ids, valid, seq_len, f_t))
    params = jmod.init(jax.random.PRNGKey(5), *jargs, method=full)
    j_ctx, j_h0, j_c0, _, j_visn = jmod.apply(params, *jargs,
                                              lstm_pallas=kernel,
                                              method=full)
    tmod = load_flax(tencoder.DicEncoder(tbert.BertConfig.base(**kw), 16,
                                         dec_hidden), params)
    targs = [torch.from_numpy(a) for a in (ids, valid, seq_len, f_t)]
    targs[0] = targs[0].long()
    text = tmod.text_forward(targs[0], targs[1])
    t_ctx, t_h0, t_c0, _, t_visn = tmod(text, *targs[1:],
                                        lstm_kernel=kernel)
    for got, ref in ((t_ctx, j_ctx), (t_h0, j_h0), (t_c0, j_c0),
                     (t_visn, j_visn)):
        close(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kernel", [False, True])
def test_dgada_channel_matches_flax(kernel):
    rng = np.random.default_rng(6)
    c = 24
    f, d = rand(rng, 2, 36, c), rand(rng, 2, 36, c)
    jmod = jadain.DGAdaChannel(c, "a", "sigmoid", use_pallas=kernel)
    params = jmod.init(jax.random.PRNGKey(6), jnp.asarray(f), jnp.asarray(d))
    ref = jmod.apply(params, jnp.asarray(f), jnp.asarray(d))
    tmod = load_flax(tadain.DGAdaChannel(c, "a", "sigmoid",
                                         use_kernel=kernel), params)
    close(tmod(torch.from_numpy(f), torch.from_numpy(d)), ref)


def test_adaptive_instance_normalization_matches_jax():
    rng = np.random.default_rng(7)
    content, style = rand(rng, 2, 36, 10), rand(rng, 2, 36, 10)
    ref = jadain.adaptive_instance_normalization(jnp.asarray(content),
                                                 jnp.asarray(style))
    close(tadain.adaptive_instance_normalization(
        torch.from_numpy(content), torch.from_numpy(style)), ref)


@pytest.mark.parametrize("kernel", [False, True])
def test_battn_decoder_and_critic_match_flax(kernel):
    rng = np.random.default_rng(8)
    b, a, emb, hid, feat, k, l = 3, 8, 8, 32, 32, 16, 9
    inputs = (rand(rng, b, a), rand(rng, b, 36, feat), rand(rng, b, k, feat),
              rand(rng, b, hid), rand(rng, b, hid), rand(rng, b, l, hid))
    ctx_mask = ~ragged_mask(b, l)
    jdec = jdecoder.BAttnDecoderLSTM(
        emb, hid, 0.5, 0.3, feat, a, ctx_dim=hid, use_shift=True,
        shift_kernel_size=5, use_pallas=kernel)
    jin = tuple(jnp.asarray(x) for x in inputs) + (jnp.asarray(ctx_mask),)
    params = jdec.init(jax.random.PRNGKey(8), *jin)
    j_h, j_c, j_logit, j_tilde, j_aux = jdec.apply(params, *jin)
    tdec = load_flax(tdecoder.BAttnDecoderLSTM(
        emb, hid, feat, a, hid, use_shift=True, shift_kernel_size=5,
        use_kernel=kernel), params, root="decoder")
    tin = [torch.from_numpy(x) for x in inputs] + [
        torch.from_numpy(ctx_mask)]
    t_h, t_c, t_logit, t_tilde, t_aux = tdec(*tin)
    for got, ref in ((t_h, j_h), (t_c, j_c), (t_logit, j_logit),
                     (t_tilde, j_tilde), (t_aux["alpha"], j_aux["alpha"])):
        close(got, ref)

    jcrit = jdecoder.Critic(24)
    cparams = jcrit.init(jax.random.PRNGKey(9), j_h)
    tcrit = load_flax(tdecoder.Critic(hid, 24), cparams, root="critic")
    close(tcrit(t_h), jcrit.apply(cparams, j_h))


@pytest.mark.parametrize("use_pallas", ["never", "always"])
def test_bf16_policy_tracks_f32(use_pallas):
    """The card computes in bf16: the same policy at bf16 on the CPU (the
    plain kernel versions, the cached weight casts) gives finite logits
    close to the f32 ones, and repeats itself exactly."""
    from dasa_tpu_torch.config import Config
    from dasa_tpu_torch.models.policy import DasaPolicy, StepInputs

    cfg = Config(encoder_type="Dic", include_vision=True,
                 adain_type="channel", ab_type="a", a_type="sigmoid",
                 use_shift=True, shift_kernel_size=5, angle_feat_size=8,
                 feature_size=24, max_input=12, d_enc_hidden_size=16,
                 d_hidden_size=32, critic_dim=32, aemb=8, d_vl_layers=1,
                 d_la_layers=1, use_pallas=use_pallas)
    torch.manual_seed(0)
    p32 = DasaPolicy(cfg).eval()
    p16 = DasaPolicy(cfg, compute_dtype=torch.bfloat16).eval()
    p16.load_state_dict(p32.state_dict())
    rng = np.random.default_rng(9)
    b, k, f = 2, 16, 32
    inputs = StepInputs(*(torch.from_numpy(np.abs(rand(rng, *s)))
                          for s in ((b, 8), (b, 36, f), (b, 36, f),
                                    (b, k, f), (b, k, f))),
                        cand_mask=torch.zeros(b, k, dtype=torch.bool))
    instr = torch.from_numpy(rng.integers(1, 100, (b, 12)))
    valid = torch.from_numpy(ragged_mask(b, 12))
    seq_len = valid.sum(1)
    with torch.no_grad():
        ref, _ = p32(instr, valid, seq_len, inputs, lstm_kernel=True)
        got, value = p16(instr, valid, seq_len, inputs, lstm_kernel=True)
        again, _ = p16(instr, valid, seq_len, inputs, lstm_kernel=True)
    assert got.dtype == torch.bfloat16 and bool(got.isfinite().all())
    torch.testing.assert_close(again, got, atol=0, rtol=0)
    # bf16 keeps 8 mantissa bits; a dozen rounded layers stay within a
    # few percent of the logits' scale
    scale = float(ref.abs().max())
    assert float((got.float() - ref).abs().max()) <= 0.05 * scale
