"""The port's variant building blocks against the JAX package's flax
modules: the AdaIN family and the gumbel-sigmoid gate, the policy's AdaIN
dispatch for every type, the unidirectional LSTM, ``MLP``,
``scaled_dot_attention``, the DicEncoder's one-direction top LSTM and
``ctx_v``, and the speaker encoder in one direction
(tests/test_torch_variants.py holds the decoders and whole policies).

Params go across with ``policy_state_dict_from_jax`` (a strict load), the
same numpy inputs go through both in f32, and the gumbel gate's uniform
noise is the JAX key's own draw, handed to the port.  Tolerance: rtol
1e-5, atol 1e-6 for the AdaIN modules and layers; atol 1e-5 for
gradients and the LSTMs (sums over tokens of products; f32 roundoff of a
dozen chained steps), 1e-4 where the 768-wide BERT stack is in the path
(tests/test_torch_models.py's reason).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from dasa_tpu.config import Config as JaxConfig
from dasa_tpu.models import DasaPolicy as JaxPolicy
from dasa_tpu.models import StepInputs as JaxInputs
from dasa_tpu.models import adain as jadain
from dasa_tpu.models import bert as jbert
from dasa_tpu.models import encoder as jencoder
from dasa_tpu.models import layers as jlayers
from dasa_tpu.models import speaker as jspeaker
from dasa_tpu_torch.config import Config
from dasa_tpu_torch.models import adain as tadain
from dasa_tpu_torch.models import bert as tbert
from dasa_tpu_torch.models import encoder as tencoder
from dasa_tpu_torch.models import layers as tlayers
from dasa_tpu_torch.models import speaker as tspeaker
from dasa_tpu_torch.models.policy import DasaPolicy, StepInputs
from dasa_tpu_torch.testing import torch_threads
from dasa_tpu_torch.utils.jax_params import policy_state_dict_from_jax

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
BERT_TOL = dict(rtol=1e-4, atol=1e-4)
ADAIN_TYPES = ("channel", "rgb_channel", "coco_channel", "meanchannel",
               "rgb_meanchannel", "rgb_stat_channel", "depth_stat_channel",
               "default")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def ragged_mask(b, t):
    """True = valid; row j keeps its first t - j tokens."""
    return np.arange(t)[None, :] < (t - np.arange(b))[:, None]


def load_flax(module, variables, root="m"):
    state = policy_state_dict_from_jax({root: variables["params"]})
    module.load_state_dict({k[len(root) + 1:]: torch.from_numpy(v)
                            for k, v in state.items()})
    return module.eval()


def close(got, ref, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(ref, np.float32), **tol)


def jax_uniform(key):
    """The port's ``noise(shape)``: the draws the JAX gate takes from
    ``key`` at that shape."""
    return lambda shape: torch.from_numpy(np.asarray(
        jax.random.uniform(key, tuple(shape), jnp.float32)))


# ---------------------------------------------------------------------
# the gumbel-sigmoid gate and the AdaIN modules
# ---------------------------------------------------------------------
@pytest.mark.parametrize("hard,test", [(True, False), (False, False),
                                       (True, True)])
def test_gumbel_sigmoid_matches_jax(hard, test):
    """Forward, and the straight-through gradient of sum(w * gate)."""
    rng = np.random.default_rng(0)
    logits, w = rand(rng, 3, 36, 16, scale=2.0), rand(rng, 3, 36, 16)
    key = jax.random.PRNGKey(4)

    def jfn(x):
        return (jadain.gumbel_sigmoid(x, key, hard=hard, test=test)
                * jnp.asarray(w)).sum()

    ref = jadain.gumbel_sigmoid(jnp.asarray(logits), key, hard=hard,
                                test=test)
    ref_grad = jax.grad(jfn)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    u = None if test else jax_uniform(key)(logits.shape)
    got = tadain.gumbel_sigmoid(x, u, hard=hard, test=test)
    close(got, ref)
    if test:  # the threshold passes no gradient
        assert not got.requires_grad and not np.asarray(ref_grad).any()
    else:
        (got * torch.from_numpy(w)).sum().backward()
        close(x.grad, ref_grad, GRAD_TOL)
    if hard:  # 0 or 1, up to y_soft - y_soft's f32 rounding
        vals = got.detach().numpy()
        np.testing.assert_allclose(vals, np.round(vals), atol=1e-6)


def adain_module(name):
    """(flax module, port module) of an AdaIN module and gate:
    ``channel-{ab}-{a_type}``, ``coco-{ab}-{a_type}``, ``mean``, ``stat``."""
    c = 24
    kind, *rest = name.split("-")
    if kind in ("channel", "coco"):
        ab, a_type = rest[0], None if rest[1] == "None" else rest[1]
        if kind == "channel":
            return (jadain.DGAdaChannel(c, ab, a_type),
                    tadain.DGAdaChannel(c, ab, a_type))
        return (jadain.DGAdaCOCOChannel(c, ab, a_type, mid_dim=16),
                tadain.DGAdaCOCOChannel(c, ab, a_type, mid_dim=16))
    if kind == "mean":
        return jadain.DGAdaMeanChannel(c), tadain.DGAdaMeanChannel(c)
    return jadain.DGAdaStatChannel(c), tadain.DGAdaStatChannel(c)


ADAIN_MODULES = (
    [f"channel-{ab}-{a}" for ab in ("ab", "a", "b")
     for a in ("None", "sigmoid", "gumbel_sigmoid")]
    + ["coco-ab-sigmoid", "coco-a-gumbel_sigmoid", "coco-b-None", "mean",
       "stat"])


@pytest.mark.parametrize("is_test", [True, False])
@pytest.mark.parametrize("name", ADAIN_MODULES)
def test_adain_module_matches_flax(name, is_test):
    """Forward and the parameters' and inputs' gradients; out of test the
    gumbel gate takes the JAX key's noise."""
    jmod, tmod = adain_module(name)
    rng = np.random.default_rng(1)
    f, d = rand(rng, 2, 36, 24), rand(rng, 2, 36, 24)
    w = rand(rng, 2, 36, 24)
    key = jax.random.PRNGKey(7)
    jf, jd = jnp.asarray(f), jnp.asarray(d)
    params = jmod.init(jax.random.PRNGKey(1), jf, jd)

    def jloss(params, f, d):
        out = jmod.apply(params, f, d, is_test=is_test, gumbel_rng=key)
        return (out * jnp.asarray(w)).sum(), out

    (_, ref), (gp, gf, gd) = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(params, jf, jd)
    tmod = load_flax(tmod, params)
    tf, td = (torch.from_numpy(x).requires_grad_() for x in (f, d))
    got = tmod(tf, td, is_test=is_test, noise=jax_uniform(key))
    (got * torch.from_numpy(w)).sum().backward()
    close(got, ref)

    def grad_of(t):  # the gumbel threshold in test passes none to a's side
        return torch.zeros_like(t) if t.grad is None else t.grad

    close(grad_of(tf), gf, GRAD_TOL)
    close(grad_of(td), gd, GRAD_TOL)
    ref_grads = policy_state_dict_from_jax({"m": gp["params"]})
    for pname, p in tmod.named_parameters():
        close(grad_of(p), ref_grads[f"m.{pname}"], GRAD_TOL)


def test_stat_channel_std_is_unbiased():
    """The stat module's std is ddof=1 (torch.std's default), the AdaIN
    renormalization's the population one."""
    rng = np.random.default_rng(2)
    d = rand(rng, 2, 36, 4)
    mod = tadain.DGAdaStatChannel(4)
    seen = {}
    mod.a_fc.register_forward_hook(
        lambda m, inp, out: seen.update(stats=inp[0]))
    mod(torch.zeros(2, 36, 4), torch.from_numpy(d))
    close(seen["stats"][:, 4:8], d.std(axis=1, ddof=1))
    style = torch.from_numpy(d)
    content = torch.from_numpy(rand(rng, 2, 36, 4))
    out = tadain.adaptive_instance_normalization(content, style)
    close(out.std(dim=1, unbiased=False), d.std(axis=1, ddof=0),
          dict(rtol=1e-4, atol=1e-5))


def test_make_adain_builds_every_type():
    kinds = {"channel": tadain.DGAdaChannel,
             "rgb_channel": tadain.DGAdaChannel,
             "coco_channel": tadain.DGAdaCOCOChannel,
             "meanchannel": tadain.DGAdaMeanChannel,
             "rgb_meanchannel": tadain.DGAdaMeanChannel,
             "rgb_stat_channel": tadain.DGAdaStatChannel,
             "depth_stat_channel": tadain.DGAdaStatChannel}
    for kind, cls in kinds.items():
        assert type(tadain.make_adain(kind, 8, "ab", "sigmoid")) is cls
    assert tadain.make_adain("default", 8, "ab", None) is None
    assert tadain.make_adain("none", 8, "ab", None) is None


# ---------------------------------------------------------------------
# the policy's AdaIN dispatch
# ---------------------------------------------------------------------
BASE = dict(encoder_type="Dic", include_vision=True, angle_feat_size=8,
            feature_size=24, max_input=12, d_enc_hidden_size=16,
            d_hidden_size=32, critic_dim=32, aemb=8, d_vl_layers=1,
            d_la_layers=1, max_candidates=6)


def policy_pair(adain_only=False, **kw):
    """A JAX and a port policy of one config, the same weights, and one
    step's numpy inputs (ragged instructions, 3 and 5 candidates).
    ``adain_only`` initializes (and carries) the AdaIN module alone."""
    rng = np.random.default_rng(3)
    b, k, L = 2, 6, 12
    jcfg = JaxConfig(**BASE, **kw)
    f_all = jcfg.feature_all_size
    arrs = [np.abs(rand(rng, *s)) for s in ((b, 8), (b, 36, f_all),
                                            (b, 36, f_all), (b, k, f_all),
                                            (b, k, f_all))]
    cand_n = np.array([3, 5])
    mask = np.arange(k)[None] > cand_n[:, None]
    cidx = np.where(np.arange(k)[None] >= cand_n[:, None], 36,
                    rng.integers(0, 36, (b, k)))
    jin = JaxInputs(*[jnp.asarray(a) for a in arrs], jnp.asarray(mask),
                    jnp.asarray(cidx, jnp.int32))
    tin = StepInputs(*[torch.from_numpy(a) for a in arrs],
                     torch.from_numpy(mask), torch.from_numpy(cidx).long())
    instr = rng.integers(1, 100, (b, L))
    valid = ragged_mask(b, L)
    text = (instr, valid, valid.sum(1))
    jpol = JaxPolicy(jcfg, vocab_size=0)
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    if adain_only:
        params = jpol.init(rngs, jin, method=JaxPolicy.apply_adain)
    else:
        params = jpol.init(rngs, *(
            jnp.asarray(x, jnp.int32 if x.dtype.kind == "i" else None)
            for x in text), jin)
    tpol = DasaPolicy(Config(**BASE, **kw)).eval()
    state = policy_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, dict(params)))
    missing, unexpected = tpol.load_state_dict(
        {k_: torch.from_numpy(v) for k_, v in state.items()},
        strict=not adain_only)
    assert not unexpected
    assert not adain_only or all(not k_.startswith("adain.")
                                 for k_ in missing)
    return jpol, params, tpol, jin, tin, text


@pytest.mark.parametrize("kind", ADAIN_TYPES + ("none",))
def test_apply_adain_matches_jax(kind):
    """Every AdaIN type's dispatch: which slots take the modulated pano
    and candidates (``default`` overwrites f_t; ``none`` hands the rgb
    pano to the decoder)."""
    jpol, params, tpol, jin, tin, _ = policy_pair(
        True, adain_type=kind, ab_type="ab", a_type="sigmoid")
    ref = jpol.apply(params, jin, method=JaxPolicy.apply_adain)
    got = tpol.apply_adain(tin)
    for g, r in zip(got, ref):
        close(g, r, dict(rtol=1e-5, atol=1e-5))


@pytest.mark.parametrize("kind", ["channel", "coco_channel"])
def test_apply_adain_gumbel_out_of_test_matches_jax(kind):
    """The gumbel gate in training: the pano and the candidates draw from
    the same key, as the JAX dispatch hands one ``gumbel_rng`` to both."""
    jpol, params, tpol, jin, tin, _ = policy_pair(
        True, adain_type=kind, ab_type="ab", a_type="gumbel_sigmoid")
    key = jax.random.PRNGKey(9)
    for is_test in (True, False):
        ref = jpol.apply(params, jin, is_test=is_test, gumbel_rng=key,
                         method=JaxPolicy.apply_adain)
        got = tpol.apply_adain(tin, is_test=is_test,
                               gumbel_u=jax_uniform(key))
        for g, r in zip(got, ref):
            close(g, r, dict(rtol=1e-5, atol=1e-5))


def test_double_agent_without_adain_keeps_raw_depth():
    jpol, params, tpol, jin, tin, _ = policy_pair(True, agent_type="double",
                                                  adain_type="none")
    ref = jpol.apply(params, jin, method=JaxPolicy.apply_adain)
    got = tpol.apply_adain(tin)
    for g, r, raw in zip(got, ref, tin):
        close(g, r)
        assert torch.equal(g, raw)


# ---------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kernel", [False, True])
def test_unidirectional_lstm_matches_flax(kernel, reverse):
    """Forward (ys, final carry) and the gradients of a loss on both;
    ``kernel`` routes through LstmScanFn (K1 / K2's plain versions
    here), as the JAX LSTM's ``pallas=True`` routes to its kernel."""
    rng = np.random.default_rng(4)
    b, t, d, h = 3, 7, 6, 8
    x, mask = rand(rng, b, t, d), ragged_mask(b, t)
    gy, gh = rand(rng, b, t, h), rand(rng, b, h)
    jmod = jlayers.LSTM(h, reverse=reverse)
    params = jmod.init(jax.random.PRNGKey(4), jnp.asarray(x),
                       jnp.asarray(mask))

    def jloss(params, x):
        ys, (hf, cf) = jmod.apply(params, x, jnp.asarray(mask),
                                  pallas=kernel)
        return ((ys * gy).sum() + (hf * gh).sum() + cf.sum(),
                (ys, hf, cf))

    (_, (j_ys, j_h, j_c)), (gp, gx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    tmod = load_flax(tlayers.LSTM(h, d, reverse=reverse), params)
    tx = torch.from_numpy(x).requires_grad_()
    ys, (hf, cf) = tmod(tx, torch.from_numpy(mask), kernel=kernel)
    ((ys * torch.from_numpy(gy)).sum() + (hf * torch.from_numpy(gh)).sum()
     + cf.sum()).backward()
    for got, ref in ((ys, j_ys), (hf, j_h), (cf, j_c)):
        close(got, ref, GRAD_TOL)
    close(tx.grad, gx, GRAD_TOL)
    ref_grads = policy_state_dict_from_jax({"m": gp["params"]})
    for name, p in tmod.named_parameters():
        if p.requires_grad:
            close(p.grad, ref_grads[f"m.{name}"], GRAD_TOL)
    assert tmod.bias_hh_l0.grad is None


def test_mlp_matches_flax():
    rng = np.random.default_rng(5)
    x = rand(rng, 2, 5, 12)
    jmod = jlayers.MLP(16, 7)
    params = jmod.init(jax.random.PRNGKey(5), jnp.asarray(x))
    # an MLP's Dense_0 / Dense_1 become 0 / 2 under the AdaIN's names
    tmod = load_flax(tlayers.MLP(12, 16, 7), params, root="a_fc_content")
    close(tmod(torch.from_numpy(x)), jmod.apply(params, jnp.asarray(x)))


@pytest.mark.parametrize("query_rank,masked,prob", [
    (2, False, True), (2, True, False), (3, True, True)])
def test_scaled_dot_attention_matches_jax(query_rank, masked, prob):
    rng = np.random.default_rng(6)
    b, k, d = 2, 9, 16
    value, key = rand(rng, b, k, d), rand(rng, b, k, d)
    query = rand(rng, *((b, d) if query_rank == 2 else (b, 3, d)))
    mask = (~ragged_mask(b, k))[:, None, :] if masked else None
    ref = jlayers.scaled_dot_attention(
        *(jnp.asarray(x) for x in (value, key, query)),
        mask=None if mask is None else jnp.asarray(mask), output_prob=prob)
    got = tlayers.scaled_dot_attention(
        *(torch.from_numpy(x) for x in (value, key, query)),
        mask=None if mask is None else torch.from_numpy(mask),
        output_prob=prob)
    for g, r in zip(got, ref):
        close(g, r, dict(rtol=1e-5, atol=1e-5))


# ---------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------
@pytest.mark.parametrize("bidir,ctx_v,dec_hidden,kernel", [
    (False, False, 16, False), (False, True, 24, True),
    (True, True, 32, False)])
def test_dic_encoder_variants_match_flax(bidir, ctx_v, dec_hidden, kernel):
    """The one-direction top LSTM (the c_t projection only where
    num_dir * hidden != dec_hidden) and ctx_v's projection of the vision
    tokens."""
    rng = np.random.default_rng(7)
    b, l, feat = 2, 10, 32
    kw = dict(la_layers=1, vl_layers=1, img_feature_dim=feat)
    ids = rng.integers(1, 200, (b, l)).astype(np.int32)
    valid = ragged_mask(b, l)
    seq_len = valid.sum(1).astype(np.int32)
    f_t = rand(rng, b, 36, feat)
    jmod = jencoder.DicEncoder(jbert.BertConfig.base(**kw), 16, dec_hidden,
                               0.0, bidirectional=bidir, ctx_v=ctx_v,
                               ctx_v_dim=40)

    def full(mod, ids, valid, seq_len, f_t, lstm_pallas=False):
        return mod(mod.text_forward(ids, valid), valid, seq_len, f_t,
                   lstm_pallas=lstm_pallas)

    jargs = tuple(jnp.asarray(a) for a in (ids, valid, seq_len, f_t))
    params = jmod.init(jax.random.PRNGKey(7), *jargs, method=full)
    ref = jmod.apply(params, *jargs, lstm_pallas=kernel, method=full)
    tmod = load_flax(tencoder.DicEncoder(
        tbert.BertConfig.base(**kw), 16, dec_hidden, bidirectional=bidir,
        ctx_v=ctx_v, ctx_v_dim=40), params)
    assert hasattr(tmod, "encoder_lstm2decoder_ct") == (
        (2 if bidir else 1) * 16 != dec_hidden)
    targs = [torch.from_numpy(a) for a in (ids, valid, seq_len, f_t)]
    targs[0] = targs[0].long()
    got = tmod(tmod.text_forward(targs[0], targs[1]), *targs[1:],
               lstm_kernel=kernel)
    for g, r in zip(got, ref):
        if r is None:
            assert g is None
        else:
            close(g, r, BERT_TOL)
    assert (got[3] is not None) == ctx_v


class ForwardSpeakerEncoder(jspeaker.SpeakerEncoder):
    """The JAX speaker encoder with its one-direction LSTMs built as
    ``LSTM(features, dtype=...)``: ``SpeakerEncoder.setup`` passes the
    dtype positionally, where ``LSTM`` takes ``reverse``, so the JAX
    module runs them over the time-reversed path."""

    def setup(self):
        self.lstm = jlayers.LSTM(self.hidden_size, dtype=self.dtype)
        self.post_lstm = jlayers.LSTM(self.hidden_size, dtype=self.dtype)
        self.attention_layer = jlayers.SoftDotAttention(
            self.hidden_size, self.feature_size, self.dtype)
        self.drop = flax_nn.Dropout(self.dropout_ratio)


@pytest.mark.parametrize("kernel,jax_module", [
    (False, "forward"), (True, "forward"), (False, "as_is")])
def test_unidirectional_speaker_encoder_matches_flax(kernel, jax_module):
    """SpeakerEncoder(bidirectional=False): two one-direction LSTMs of
    rnn_dim around the panorama attention; forward and the gradient of
    the action features.  The port runs its LSTMs forward in time, as the
    reference's nn.LSTM does: it equals :class:`ForwardSpeakerEncoder`,
    and the JAX module as it is once the port's LSTMs are reversed."""
    rng = np.random.default_rng(8)
    b, t, feat, hid, a = 2, 5, 24, 16, 8
    x, pano = rand(rng, b, t, feat), rand(rng, b, t, 36, feat)
    g = rand(rng, b, t, hid)
    cls = (ForwardSpeakerEncoder if jax_module == "forward"
           else jspeaker.SpeakerEncoder)
    jmod = cls(feat, hid, 0.0, 0.0, a, bidirectional=False)
    params = jmod.init(jax.random.PRNGKey(8), jnp.asarray(x),
                       jnp.asarray(pano))

    def jloss(x):
        out = jmod.apply(params, x, jnp.asarray(pano))
        return (out * jnp.asarray(g)).sum(), out

    (_, ref), gx = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    tmod = load_flax(tspeaker.SpeakerEncoder(feat, hid, 0.0, 0.0, a,
                                             bidirectional=False), params)
    if jax_module == "as_is":
        tmod.lstm.reverse = tmod.post_lstm.reverse = True
    tx = torch.from_numpy(x).requires_grad_()
    out = tmod(tx, torch.from_numpy(pano), kernel=kernel)
    (out * torch.from_numpy(g)).sum().backward()
    close(out, ref, GRAD_TOL)
    close(tx.grad, gx, GRAD_TOL)
