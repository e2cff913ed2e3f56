"""Assembled navigation policy.

Counterpart of ``dasa_tpu/models/policy.py`` (reference
r2r_src/agent_dg.py:102-260): one ``nn.Module`` owning the encoder, the
decoder, the critic and the AdaIN module, exposed as per-step methods.
Three encoder families (``dasa_tpu/models/policy.py:96-249``):

- the plain encoders (:data:`PLAIN_ENCODERS`: EncoderLSTM, B/CEncoder,
  Transformer, Gpt) see no vision: the whole encoder runs once per
  episode, its per-episode cache is ``{ctx, h0, c0}``, and the decoder is
  ``AttnDecoderLSTM`` at ``rnn_dim``;
- ``agent_type="mcatt"`` (on a non-plain ``encoder_type``): the MCAN
  co-attention encoder, its embedding + BiLSTM cached as
  ``{text_embeds}``, the backbone every step, and ``McattDecoder`` at
  ``mcan_hidden_size``;
- the cross-modal encoders (Dic, and the legacy BertImg / BertAdd /
  BertMix): the text stack cached as ``{text_embeds}``, the rest every
  step; the decoder is BAttn with its heads, or the double / advanced /
  kvmem / new / mutan / mt agents' decoders.  BertImg's and BertAdd's ctx
  spans [36 views; L tokens] (``percept["ctx_valid"]``).

The kernel switch keeps the JAX package's meaning:
``use_pallas="always"`` routes the AdaIN gate and the shift attention
through their CUDA kernels; every encoder LSTM's routing is the agent's
``lstm_kernel`` argument (on under ``auto`` and ``always``).

Step dataflow (agent_dg.py:725-936): gather pano + candidates -> env-drop
noise (before or after AdaIN) -> AdaIN channel modulation -> cross-modal
encoder (with the per-episode cached text stack) -> decoder step ->
candidate logits.  ``deterministic=False`` turns dropout on; its masks
come from the caller's ``torch.Generator`` ``gen``.  ``is_test`` switches
the gumbel-sigmoid AdaIN gate to its threshold; out of test, its uniform
noise comes from ``gen`` too (``gumbel_u(shape)`` replaces the draw, for
tests).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import torch
from torch import nn

from dasa_tpu_torch.config import Config
from dasa_tpu_torch.models.adain import (
    adaptive_instance_normalization,
    make_adain,
)
from dasa_tpu_torch.models import legacy, mcan, variants
from dasa_tpu_torch.models.bert import BertConfig
from dasa_tpu_torch.models.decoder import (
    AttnDecoderLSTM,
    BAttnDecoderLSTM,
    Critic,
)
from dasa_tpu_torch.models.encoder import (
    BertTextEncoderLSTM,
    DicEncoder,
    EncoderLSTM,
)
from dasa_tpu_torch.models.layers import uniform

# the agent types whose decoder replaces the BAttn decoder
# (``dasa_tpu/models/policy.py:200-226``)
VARIANT_DECODERS = {"advanced": variants.AdvancedDecoderLSTM,
                    "kvmem": variants.KVMemAttnDecoderLSTM,
                    "new": variants.NewAttnDecoderLSTM,
                    "mutan": variants.MutanAttnDecoderLSTM}
AGENT_TYPES = ("default", "dg", "double", "mt", "mcatt",
               *VARIANT_DECODERS)
# encoders with no per-step vision input: the whole encoder runs once per
# episode and the decoder is the plain AttnDecoderLSTM
PLAIN_ENCODERS = ("EncoderLSTM", "BEncoder", "CEncoder", "Transformer",
                  "Gpt")
# the legacy single-stream encoders (models/legacy.py); the ctx of the
# first two spans the joint [36 vision; L text] tokens, BertMix's the text
JOINT_CTX_ENCODERS = ("BertImg", "BertAdd")
LEGACY_CROSS_ENCODERS = ("BertImg", "BertAdd", "BertMix")
ENCODER_TYPES = (*PLAIN_ENCODERS, "Dic", *LEGACY_CROSS_ENCODERS)


class StepInputs(NamedTuple):
    """Per-step featurized inputs (already gathered on device)."""

    action_feat: torch.Tensor   # (B, A) angle feature of current pose
    f_t: torch.Tensor           # (B, 36, F) rgb pano + angle
    d_t: torch.Tensor           # (B, 36, F) depth pano + angle
    cand_feat: torch.Tensor     # (B, K, F)
    cand_dfeat: torch.Tensor    # (B, K, F)
    cand_mask: torch.Tensor     # (B, K) True = masked (pad beyond STOP)
    cand_idx: Optional[torch.Tensor] = None  # (B, K) view-token index
                                # per candidate (STOP slot = views); the
                                # MT decoder's


class DecoderState(NamedTuple):
    h: torch.Tensor
    c: torch.Tensor
    h1: torch.Tensor


def _dropout_gen(deterministic: bool, gen):
    """The generator the modules draw dropout masks from: none when
    deterministic; a non-deterministic call must bring one."""
    if deterministic:
        return None
    if gen is None:
        raise ValueError("deterministic=False needs a torch.Generator for "
                         "the dropout masks")
    return gen


def decoder_state_width(cfg: Config) -> int:
    """Width of the DecoderState arrays: ``rnn_dim`` on the plain path,
    ``mcan_hidden_size`` for mcatt (param.py:235), else ``d_hidden_size``;
    the double agent carries its two decoder streams packed side by
    side."""
    if cfg.agent_type == "mcatt":
        return cfg.mcan_hidden_size
    base = (cfg.rnn_dim if cfg.encoder_type in PLAIN_ENCODERS
            else cfg.d_hidden_size)
    return base * (2 if cfg.agent_type == "double" else 1)


def bert_config_from(cfg: Config) -> BertConfig:
    base = (BertConfig.large if cfg.d_bert_type == "large"
            else BertConfig.base)
    return base(
        img_feature_dim=cfg.feature_all_size,
        la_layers=cfg.d_la_layers,
        vl_layers=cfg.d_vl_layers,
        v_layers=cfg.d_v_layers,
        update_lang_bert=cfg.d_transformer_update,
        update_add_layer=cfg.d_update_add_layer,
        hidden_dropout_prob=cfg.d_hidden_dropout_prob,
        attention_probs_dropout_prob=cfg.d_attn_dropout_prob,
    )


class DasaPolicy(nn.Module):
    """Every ``encoder_type`` of :data:`ENCODER_TYPES` (and the config's
    aliases of them), every agent type of :data:`AGENT_TYPES`, every
    AdaIN type and the BAttn heads.  ``vocab_size`` is the word vocab of
    the encoders that embed words themselves (EncoderLSTM, Transformer,
    Gpt, mcatt)."""

    def __init__(self, cfg: Config, vocab_size: int = 0,
                 compute_dtype=torch.float32):
        super().__init__()
        if (cfg.encoder_type not in ENCODER_TYPES
                or cfg.agent_type not in AGENT_TYPES):
            raise ValueError(f"DasaPolicy: encoder_type={cfg.encoder_type!r},"
                             f" agent_type={cfg.agent_type!r}")
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        use_kernel = cfg.use_pallas == "always"
        kw = dict(compute_dtype=compute_dtype)
        dec_kw = dict(kw, dropout_ratio=cfg.dropout,
                      featdropout=cfg.featdropout)
        if cfg.encoder_type in PLAIN_ENCODERS:
            self.encoder = self._plain_encoder(cfg, vocab_size, kw)
            self.decoder = AttnDecoderLSTM(
                cfg.aemb, cfg.rnn_dim, cfg.feature_all_size,
                cfg.angle_feat_size, cfg.rnn_dim, **dec_kw)
        elif cfg.agent_type == "mcatt":
            # the MCAN co-attention encoder and the plain decoder at the
            # MCAN hidden width (agent_mcatt.py:125-131)
            mh = cfg.mcan_hidden_size
            self.encoder = mcan.McattEncoder(
                vocab_size, cfg.wemb, mh, cfg.mcan_heads, 4 * mh,
                cfg.mcan_layers, cfg.feature_all_size,
                flat_mlp_size=cfg.mcan_flat_mlp_size, flat_out_size=mh, **kw)
            self.decoder = variants.McattDecoder(
                cfg.aemb, mh, cfg.feature_all_size, cfg.angle_feat_size, mh,
                max_input=cfg.max_input, **dec_kw)
        else:
            self.encoder = self._cross_encoder(cfg, kw)
            self.decoder = self._cross_decoder(cfg, use_kernel, dec_kw)
        self._check_heads(cfg)
        self.critic = Critic(decoder_state_width(cfg), cfg.critic_dim,
                             cfg.dropout, compute_dtype=compute_dtype)
        self.adain = make_adain(cfg.adain_type, cfg.feature_size,
                                cfg.ab_type, cfg.a_type, compute_dtype,
                                use_kernel=use_kernel)

    @staticmethod
    def _plain_encoder(cfg: Config, vocab_size: int, kw) -> nn.Module:
        """EncoderLSTM, B/CEncoderLSTM or the Transformer / Gpt encoder,
        each at ``rnn_dim`` (``rnn_dim / 2`` a direction when
        bidirectional)."""
        hidden = cfg.rnn_dim // 2 if cfg.bidir else cfg.rnn_dim
        tail = dict(bidirectional=cfg.bidir, dropout_ratio=cfg.dropout, **kw)
        if cfg.encoder_type in ("Transformer", "Gpt"):
            return legacy.TransformerTextEncoder(
                vocab_size, cfg.legacy_width, cfg.legacy_heads,
                cfg.legacy_layers, hidden, cfg.rnn_dim,
                causal=cfg.encoder_type == "Gpt", **tail)
        tail.update(sub_out=cfg.sub_out, zero_init=cfg.zero_init)
        if cfg.encoder_type == "EncoderLSTM":
            return EncoderLSTM(vocab_size, cfg.wemb, hidden, **tail)
        # update_bert gates the text BERT's freeze (model.py:88-247)
        bcfg = dataclasses.replace(bert_config_from(cfg),
                                   update_lang_bert=cfg.update_bert)
        return BertTextEncoderLSTM(
            bcfg, hidden,
            project_dim=cfg.wemb if cfg.encoder_type == "CEncoder" else None,
            n_layer_concat=cfg.d_bert_n_layers, **tail)

    @staticmethod
    def _cross_encoder(cfg: Config, kw) -> nn.Module:
        common = dict(bidirectional=cfg.d_bidirectional,
                      dropout_ratio=cfg.d_dropout_ratio, **kw)
        if cfg.encoder_type == "BertImg":
            return legacy.BertImgEncoder(
                bert_config_from(cfg), cfg.d_enc_hidden_size,
                cfg.d_hidden_size, n_vision_tokens=cfg.views, **common)
        if cfg.encoder_type in LEGACY_CROSS_ENCODERS:
            return legacy.BertAddEncoder(
                bert_config_from(cfg), cfg.d_enc_hidden_size,
                cfg.d_hidden_size, n_vision_tokens=cfg.views,
                strip_vision_ctx=cfg.encoder_type == "BertMix", **common)
        return DicEncoder(
            bert_config_from(cfg), cfg.d_enc_hidden_size, cfg.d_hidden_size,
            reverse_input=cfg.d_reverse_input, top_lstm=cfg.d_top_lstm,
            ctx_v=cfg.ctx_v, ctx_v_dim=cfg.feature_all_size, **common)

    @staticmethod
    def _cross_decoder(cfg: Config, use_kernel: bool, kw) -> nn.Module:
        num_dir = 2 if cfg.d_bidirectional else 1
        ctx_dim = (cfg.d_enc_hidden_size * num_dir if cfg.d_top_lstm
                   else cfg.bert_hidden_size)
        args = (cfg.aemb, cfg.d_hidden_size, cfg.feature_all_size,
                cfg.angle_feat_size, ctx_dim)
        agent = cfg.agent_type
        if agent == "double":
            return variants.DoubleBAttnDecoderLSTM(*args, **kw)
        if agent == "mt":
            return variants.MTDecoder(*args, vemb_dim=cfg.bert_hidden_size,
                                      **kw)
        if agent in VARIANT_DECODERS:
            # the JAX policy passes pred_back to advanced, kvmem and new
            # only (``dasa_tpu/models/policy.py:214-222``)
            back = cfg.pred_back and agent != "mutan"
            return VARIANT_DECODERS[agent](
                *args, pred_back=back, max_input=cfg.max_input, **kw)
        return BAttnDecoderLSTM(
            *args, use_shift=cfg.use_shift,
            shift_kernel_size=cfg.shift_kernel_size,
            pred_back=cfg.pred_back, back_input=cfg.back_input,
            use_dyrelu=cfg.decoder_type == "dyrelu", pred_pm=cfg.pred_pm,
            pm_type=cfg.pm_type, max_input=cfg.max_input,
            use_kernel=use_kernel, **kw)

    def _check_heads(self, cfg: Config) -> None:
        """The loss terms the config asks for need their decoder's heads:
        only the BAttn decoder has the progress monitor, and the mutan,
        mt and double decoders no back head (the JAX agent fails at its
        first training step there)."""
        battn = isinstance(self.decoder, BAttnDecoderLSTM)
        missing = [name for name, want, has in (
            ("pred_back", cfg.pred_back,
             hasattr(self.decoder, "back_candidate_att_layer")),
            ("pred_pm", cfg.pred_pm, battn)) if want and not has]
        if missing:
            raise ValueError(
                f"agent_type={cfg.agent_type!r}: its decoder has no head "
                f"for {', '.join(missing)}")

    # ---- episode-level ----
    def encode_text(self, instr, valid_mask, seq_len,
                    lstm_kernel: bool = False, *, deterministic: bool = True,
                    gen=None) -> Dict:
        """Per-episode cacheable computation: a plain encoder whole
        (``{ctx, h0, c0}``), mcatt's embedding + BiLSTM, or the cross
        encoders' text stack (``{text_embeds}``).  ``lstm_kernel`` routes
        the LSTM of the first two through ``ops.lstm``'s Functions."""
        gen = _dropout_gen(deterministic, gen)
        if self.cfg.encoder_type in PLAIN_ENCODERS:
            ctx, h0, c0 = self.encoder(instr, valid_mask, lstm_kernel, gen)
            return {"ctx": ctx, "h0": h0, "c0": c0}
        if self.cfg.agent_type == "mcatt":
            return {"text_embeds": self.encoder.text_forward(
                instr, ~valid_mask, lstm_kernel)}
        return {"text_embeds": self.encoder.text_forward(instr, valid_mask,
                                                         gen)}

    # ---- per-step pieces ----
    def encode_step(self, cached: Dict, valid_mask, seq_len, f_t,
                    lstm_kernel: bool = False, gen=None):
        """Per-step encoding.  Returns (ctx, h0, c0, ctx_v, v_emb)."""
        if self.cfg.encoder_type in PLAIN_ENCODERS:
            return cached["ctx"], cached["h0"], cached["c0"], None, None
        if self.cfg.agent_type == "mcatt":
            # the decoder state starts from (attended_txt, attended_v)
            # (agent_mcatt.py:620-623)
            ctx, att_txt, _v, att_v = self.encoder.cross_forward(
                cached["text_embeds"], ~valid_mask, f_t, gen)
            return ctx, att_txt, att_v, None, None
        return self.encoder(
            cached["text_embeds"], valid_mask, seq_len,
            f_t_all=f_t if self.cfg.include_vision else None,
            lstm_kernel=lstm_kernel, gen=gen)

    def apply_adain(self, inputs: StepInputs, is_test: bool = True,
                    gen=None,
                    gumbel_u: Optional[Callable] = None) -> StepInputs:
        """Depth-guided modulation of the pano/candidate visual channels;
        dispatch mirrors vl_rollout (agent_dg.py:742-777,
        ``dasa_tpu/models/policy.py:288-333``).  Out of test, the
        gumbel-sigmoid gate's uniform noise is ``gumbel_u(shape)`` or drawn
        from ``gen``."""
        cfg = self.cfg
        a = cfg.angle_feat_size
        if cfg.adain_type == "none":
            if cfg.agent_type == "double":
                return inputs  # double keeps raw depth in the d_t slot
            # the decoder reads the rgb pano when AdaIN is off
            return inputs._replace(d_t=inputs.f_t,
                                   cand_dfeat=inputs.cand_feat)
        f_vis, f_ang = inputs.f_t[..., :-a], inputs.f_t[..., -a:]
        d_vis = inputs.d_t[..., :-a]
        c_vis, c_ang = inputs.cand_feat[..., :-a], inputs.cand_feat[..., -a:]
        cd_vis = inputs.cand_dfeat[..., :-a]

        def noise(shape):
            if gumbel_u is not None:
                return gumbel_u(shape)
            if gen is None:
                raise ValueError("the gumbel-sigmoid gate out of test needs "
                                 "a generator for its noise")
            return uniform(shape, gen, f_vis.device)

        def mod(content, style):
            if cfg.adain_type == "default":
                return adaptive_instance_normalization(content, style)
            return self.adain(content, style, is_test=is_test, noise=noise)

        kind = cfg.adain_type
        if kind in ("rgb_stat_channel", "rgb_meanchannel"):
            df_vis, cand_vis = mod(f_vis, f_vis), mod(c_vis, f_vis)
        elif kind == "rgb_channel":
            df_vis, cand_vis = mod(f_vis, f_vis), mod(c_vis, c_vis)
        elif kind == "depth_stat_channel":
            df_vis, cand_vis = mod(f_vis, d_vis), mod(c_vis, d_vis)
        elif kind in ("channel", "coco_channel", "default"):
            df_vis, cand_vis = mod(f_vis, d_vis), mod(c_vis, cd_vis)
        elif kind == "meanchannel":
            df_vis, cand_vis = mod(f_vis, d_vis), mod(c_vis, f_vis)
        else:
            raise ValueError(f"adain_type={kind!r}")
        # the "channel" family writes the modulated pano into df_t (the
        # decoder's pano input) and keeps f_t for the encoder
        # (agent_dg.py:764-768); "default" overwrites f_t itself
        df_t = torch.cat([df_vis, f_ang.to(df_vis.dtype)], dim=-1)
        cand = torch.cat([cand_vis, c_ang.to(cand_vis.dtype)], dim=-1)
        if kind == "default":
            return inputs._replace(f_t=df_t, cand_feat=cand)
        return inputs._replace(d_t=df_t, cand_feat=cand)

    def decode_step(self, inputs: StepInputs, state: DecoderState, ctx,
                    ctx_mask, *, gen=None, already_dropfeat: bool = False,
                    v_emb=None):
        """One decoder step over the (AdaIN'd) pano df_t (in the d_t slot)
        and the candidates (``dasa_tpu/models/policy.py:335-370``); the
        double agent's two streams ride side by side in the state."""
        agent = self.cfg.agent_type
        if agent == "mt":
            h, c, logit, h1, aux = self.decoder(
                inputs.action_feat, inputs.d_t, inputs.cand_feat, state.h1,
                state.c, ctx, ctx_mask, gen=gen,
                already_dropfeat=already_dropfeat, v_emb=v_emb,
                cand_idx=inputs.cand_idx)
            return DecoderState(h, c, h1), logit, aux
        if agent == "double":
            half = self.cfg.d_hidden_size
            (h, c, h1), (hd, cd, h1d), logit, aux = self.decoder(
                inputs.action_feat, inputs.f_t, inputs.d_t,
                inputs.cand_feat, inputs.cand_dfeat,
                state.h1[:, :half], state.c[:, :half],
                state.h1[:, half:], state.c[:, half:], ctx, ctx_mask,
                gen=gen, already_dropfeat=already_dropfeat)
            return DecoderState(torch.cat([h, hd], -1),
                                torch.cat([c, cd], -1),
                                torch.cat([h1, h1d], -1)), logit, aux
        h, c, logit, h1, aux = self.decoder(
            inputs.action_feat, inputs.d_t, inputs.cand_feat, state.h1,
            state.c, ctx, ctx_mask, gen=gen,
            already_dropfeat=already_dropfeat)
        return DecoderState(h, c, h1), logit, aux

    def _apply_env_noise(self, inputs: StepInputs, env_noise) -> StepInputs:
        """Multiply the visual channels by the shared per-rollout noise
        vector (consistent env-drop, agent_dg.py:731-736, 780-785;
        ``dasa_tpu/models/policy.py:373``)."""
        a = self.cfg.angle_feat_size

        def noised(x):
            return torch.cat([x[..., :-a] * env_noise, x[..., -a:]], dim=-1)

        f_t = noised(inputs.f_t)
        cand = noised(inputs.cand_feat)
        if self.cfg.depth_drop:
            d_t = noised(inputs.d_t)
            cand_d = noised(inputs.cand_dfeat)
        else:
            d_t, cand_d = inputs.d_t, inputs.cand_dfeat
        return inputs._replace(f_t=f_t, d_t=d_t, cand_feat=cand,
                               cand_dfeat=cand_d)

    def percept_step(self, cached: Dict, valid_mask, seq_len,
                     inputs: StepInputs, lstm_kernel: bool = False, *,
                     deterministic: bool = True, is_test: bool = True,
                     env_noise=None, gen=None,
                     gumbel_u: Optional[Callable] = None) -> Dict:
        """The decoder-state-independent part of one step: env-drop ->
        AdaIN -> cross-modal encoder (vl_rollout, agent_dg.py:725-797).
        ``env_noise`` (F,) is the shared feature-drop mask, applied before
        or after AdaIN as ``env_drop_stage`` says; ``is_test`` and
        ``gumbel_u`` are :meth:`apply_adain`'s.  Returns the percept dict
        (ctx, h0, c0, inputs; BertImg's and BertAdd's ctx_valid, the MT
        agent's v_emb)."""
        cfg = self.cfg
        raw_gen = gen
        gen = _dropout_gen(deterministic, gen)
        if env_noise is not None and cfg.env_drop_stage == "before_adain":
            inputs = self._apply_env_noise(inputs, env_noise)
        inputs = self.apply_adain(inputs, is_test=is_test, gen=raw_gen,
                                  gumbel_u=gumbel_u)
        if env_noise is not None and cfg.env_drop_stage == "after_adain":
            inputs = self._apply_env_noise(inputs, env_noise)
        ctx, h0, c0, ctx_v, v_emb = self.encode_step(
            cached, valid_mask, seq_len, inputs.f_t, lstm_kernel=lstm_kernel,
            gen=gen)
        if ctx_v is not None:
            inputs = inputs._replace(d_t=inputs.d_t + ctx_v)
        if cfg.agent_type == "double":
            # both decoder streams start from the encoder state
            h0, c0 = torch.cat([h0, h0], -1), torch.cat([c0, c0], -1)
        percept = {"ctx": ctx, "h0": h0, "c0": c0, "inputs": inputs}
        if cfg.encoder_type in JOINT_CTX_ENCODERS:
            # ctx spans [36 vision; L text] tokens: the mask grows too
            percept["ctx_valid"] = torch.cat(
                [torch.ones(valid_mask.shape[0], cfg.views,
                            dtype=torch.bool, device=valid_mask.device),
                 valid_mask], dim=1)
        if cfg.agent_type == "mt":
            percept["v_emb"] = v_emb
        return percept

    def decode_from_percept(self, percept: Dict, valid_mask,
                            state: DecoderState, is_first, *,
                            deterministic: bool = True,
                            already_dropfeat: bool = False, gen=None):
        """The decoder-state-dependent tail of one step: state select at
        t=0, decoder step, candidate logits, critic (vl_rollout,
        agent_dg.py:798-830).  ``already_dropfeat``: the env-drop noise
        has dropped the visual features, so the decoder skips its own
        featdropout."""
        gen = _dropout_gen(deterministic, gen)
        h0, c0 = percept["h0"], percept["c0"]
        first = is_first.to(h0.dtype)[:, None]
        state = DecoderState(
            h=first * h0 + (1 - first) * state.h,
            c=first * c0 + (1 - first) * state.c,
            h1=first * h0 + (1 - first) * state.h1)
        ctx_valid = percept.get("ctx_valid", valid_mask)
        state, logit, aux = self.decode_step(
            percept["inputs"], state, percept["ctx"], ~ctx_valid, gen=gen,
            already_dropfeat=already_dropfeat, v_emb=percept.get("v_emb"))
        # mcatt's critic reads h_tilde (agent_mcatt.py:630 appends h1)
        critic_in = state.h1 if self.cfg.agent_type == "mcatt" else state.h
        return state, logit, self.critic(critic_in, gen), aux

    def policy_step(self, cached: Dict, valid_mask, seq_len,
                    inputs: StepInputs, state: DecoderState, is_first,
                    lstm_kernel: bool = False, *,
                    deterministic: bool = True, is_test: bool = True,
                    env_noise=None, gen=None):
        """The complete per-step forward: percept_step +
        decode_from_percept under one generator."""
        percept = self.percept_step(cached, valid_mask, seq_len, inputs,
                                    lstm_kernel=lstm_kernel,
                                    deterministic=deterministic,
                                    is_test=is_test, env_noise=env_noise,
                                    gen=gen)
        return self.decode_from_percept(
            percept, valid_mask, state, is_first,
            deterministic=deterministic,
            already_dropfeat=env_noise is not None, gen=gen)

    def forward(self, instr, valid_mask, seq_len, inputs: StepInputs,
                lstm_kernel: bool = False):
        """First-step (logit, value) of fresh episodes."""
        cached = self.encode_text(instr, valid_mask, seq_len, lstm_kernel)
        percept = self.percept_step(cached, valid_mask, seq_len, inputs,
                                    lstm_kernel=lstm_kernel)
        state = DecoderState(percept["h0"], percept["c0"], percept["h0"])
        batch = instr.shape[0]
        state, logit, value, _aux = self.decode_from_percept(
            percept, valid_mask, state,
            torch.ones(batch, dtype=torch.bool, device=instr.device))
        return logit, value
