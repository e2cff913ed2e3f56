"""Assembled navigation policy.

Counterpart of ``dasa_tpu/models/policy.py`` (reference
r2r_src/agent_dg.py:102-260): one ``nn.Module`` owning the Dic encoder,
the BAttn decoder, the critic and the AdaIN module, exposed as per-step
methods.  The kernel switch keeps the JAX package's meaning:
``use_pallas="always"`` routes the AdaIN gate and the shift attention
through their CUDA kernels (the top BiLSTM's routing is the agent's
``lstm_kernel`` argument, on under ``auto`` and ``always``).

Step dataflow (agent_dg.py:725-936): gather pano + candidates -> env-drop
noise (before or after AdaIN) -> AdaIN channel modulation -> cross-modal
encoder (with the per-episode cached text stack) -> decoder step ->
candidate logits.  ``deterministic=False`` turns dropout on; its masks
come from the caller's ``torch.Generator`` ``gen``.  The JAX methods'
``is_test`` flag switches only the gumbel-sigmoid AdaIN gate, which is
not ported (the variants slice), so it does not appear here.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
from torch import nn

from dasa_tpu_torch.config import Config
from dasa_tpu_torch.models.adain import (
    adaptive_instance_normalization,
    make_adain,
)
from dasa_tpu_torch.models.bert import BertConfig
from dasa_tpu_torch.models.decoder import BAttnDecoderLSTM, Critic
from dasa_tpu_torch.models.encoder import DicEncoder


class StepInputs(NamedTuple):
    """Per-step featurized inputs (already gathered on device)."""

    action_feat: torch.Tensor   # (B, A) angle feature of current pose
    f_t: torch.Tensor           # (B, 36, F) rgb pano + angle
    d_t: torch.Tensor           # (B, 36, F) depth pano + angle
    cand_feat: torch.Tensor     # (B, K, F)
    cand_dfeat: torch.Tensor    # (B, K, F)
    cand_mask: torch.Tensor     # (B, K) True = masked (pad beyond STOP)


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
    """Width of the DecoderState arrays: the decoder hidden size of the
    Dic / BAttn policy (the double and mcatt agents, which pack other
    widths, come with the variants slice)."""
    return cfg.d_hidden_size


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
    """The Dic / BAttnDecoderLSTM / DGAdaChannel policy.  Other encoder
    and agent types raise until their slice (ROADMAP.md)."""

    def __init__(self, cfg: Config, compute_dtype=torch.float32):
        super().__init__()
        if cfg.encoder_type != "Dic" or cfg.agent_type not in ("default",
                                                               "dg"):
            raise NotImplementedError(
                f"DasaPolicy: encoder_type={cfg.encoder_type!r}, "
                f"agent_type={cfg.agent_type!r} — only the Dic encoder with "
                "the default BAttn decoder is ported (ROADMAP.md, variants)")
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        use_kernel = cfg.use_pallas == "always"
        kw = dict(compute_dtype=compute_dtype)
        self.encoder = DicEncoder(
            bert_config_from(cfg), cfg.d_enc_hidden_size, cfg.d_hidden_size,
            bidirectional=cfg.d_bidirectional,
            reverse_input=cfg.d_reverse_input, top_lstm=cfg.d_top_lstm,
            ctx_v=cfg.ctx_v, dropout_ratio=cfg.d_dropout_ratio, **kw)
        num_dir = 2 if cfg.d_bidirectional else 1
        ctx_dim = (cfg.d_enc_hidden_size * num_dir if cfg.d_top_lstm
                   else cfg.bert_hidden_size)
        self.decoder = BAttnDecoderLSTM(
            cfg.aemb, cfg.d_hidden_size, cfg.feature_all_size,
            cfg.angle_feat_size, ctx_dim, use_shift=cfg.use_shift,
            shift_kernel_size=cfg.shift_kernel_size,
            pred_back=cfg.pred_back,
            use_dyrelu=cfg.decoder_type == "dyrelu", pred_pm=cfg.pred_pm,
            use_kernel=use_kernel, dropout_ratio=cfg.dropout,
            featdropout=cfg.featdropout, **kw)
        self.critic = Critic(cfg.d_hidden_size, cfg.critic_dim, cfg.dropout,
                             **kw)
        self.adain = make_adain(cfg.adain_type, cfg.feature_size,
                                cfg.ab_type, cfg.a_type, compute_dtype,
                                use_kernel=use_kernel)

    # ---- episode-level ----
    def encode_text(self, instr, valid_mask, seq_len, *,
                    deterministic: bool = True, gen=None) -> Dict:
        """Per-episode cacheable computation: the text-only BERT stack."""
        gen = _dropout_gen(deterministic, gen)
        return {"text_embeds": self.encoder.text_forward(instr, valid_mask,
                                                         gen)}

    # ---- per-step pieces ----
    def encode_step(self, cached: Dict, valid_mask, seq_len, f_t,
                    lstm_kernel: bool = False, gen=None):
        """Per-step encoding.  Returns (ctx, h0, c0, ctx_v, v_emb)."""
        return self.encoder(
            cached["text_embeds"], valid_mask, seq_len,
            f_t_all=f_t if self.cfg.include_vision else None,
            lstm_kernel=lstm_kernel, gen=gen)

    def apply_adain(self, inputs: StepInputs) -> StepInputs:
        """Depth-guided modulation of the pano/candidate visual channels;
        dispatch mirrors vl_rollout (agent_dg.py:742-777)."""
        cfg = self.cfg
        a = cfg.angle_feat_size
        if cfg.adain_type == "none":
            # the decoder reads the rgb pano when AdaIN is off
            return inputs._replace(d_t=inputs.f_t,
                                   cand_dfeat=inputs.cand_feat)
        f_vis, f_ang = inputs.f_t[..., :-a], inputs.f_t[..., -a:]
        d_vis = inputs.d_t[..., :-a]
        c_vis, c_ang = inputs.cand_feat[..., :-a], inputs.cand_feat[..., -a:]
        cd_vis = inputs.cand_dfeat[..., :-a]

        def mod(content, style):
            if cfg.adain_type == "default":
                return adaptive_instance_normalization(content, style)
            return self.adain(content, style)

        if cfg.adain_type == "rgb_channel":
            df_vis, cand_vis = mod(f_vis, f_vis), mod(c_vis, c_vis)
        else:  # channel | default
            df_vis, cand_vis = mod(f_vis, d_vis), mod(c_vis, cd_vis)
        # "channel" writes the modulated pano into df_t (the decoder's
        # pano input) and keeps f_t for the encoder (agent_dg.py:764-768);
        # "default" overwrites f_t itself
        df_t = torch.cat([df_vis, f_ang.to(df_vis.dtype)], dim=-1)
        cand = torch.cat([cand_vis, c_ang.to(cand_vis.dtype)], dim=-1)
        if cfg.adain_type == "default":
            return inputs._replace(f_t=df_t, cand_feat=cand)
        return inputs._replace(d_t=df_t, cand_feat=cand)

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
                     deterministic: bool = True, env_noise=None,
                     gen=None) -> Dict:
        """The decoder-state-independent part of one step: env-drop ->
        AdaIN -> cross-modal encoder (vl_rollout, agent_dg.py:725-797).
        ``env_noise`` (F,) is the shared feature-drop mask, applied before
        or after AdaIN as ``env_drop_stage`` says."""
        cfg = self.cfg
        gen = _dropout_gen(deterministic, gen)
        if env_noise is not None and cfg.env_drop_stage == "before_adain":
            inputs = self._apply_env_noise(inputs, env_noise)
        inputs = self.apply_adain(inputs)
        if env_noise is not None and cfg.env_drop_stage == "after_adain":
            inputs = self._apply_env_noise(inputs, env_noise)
        ctx, h0, c0, _ctx_v, _v_emb = self.encode_step(
            cached, valid_mask, seq_len, inputs.f_t, lstm_kernel=lstm_kernel,
            gen=gen)
        return {"ctx": ctx, "h0": h0, "c0": c0, "inputs": inputs}

    def decode_from_percept(self, percept: Dict, valid_mask,
                            state: DecoderState, is_first, *,
                            deterministic: bool = True,
                            already_dropfeat: bool = False, gen=None):
        """The decoder-state-dependent tail of one step: state select at
        t=0, decoder LSTM step, candidate logits, critic (vl_rollout,
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
        inputs = percept["inputs"]
        h, c, logit, h1, aux = self.decoder(
            inputs.action_feat, inputs.d_t, inputs.cand_feat, state.h1,
            state.c, percept["ctx"], ~valid_mask, gen=gen,
            already_dropfeat=already_dropfeat)
        state = DecoderState(h, c, h1)
        return state, logit, self.critic(state.h, gen), aux

    def policy_step(self, cached: Dict, valid_mask, seq_len,
                    inputs: StepInputs, state: DecoderState, is_first,
                    lstm_kernel: bool = False, *,
                    deterministic: bool = True, env_noise=None, gen=None):
        """The complete per-step forward: percept_step +
        decode_from_percept under one generator."""
        percept = self.percept_step(cached, valid_mask, seq_len, inputs,
                                    lstm_kernel=lstm_kernel,
                                    deterministic=deterministic,
                                    env_noise=env_noise, gen=gen)
        return self.decode_from_percept(
            percept, valid_mask, state, is_first,
            deterministic=deterministic,
            already_dropfeat=env_noise is not None, gen=gen)

    def forward(self, instr, valid_mask, seq_len, inputs: StepInputs,
                lstm_kernel: bool = False):
        """First-step (logit, value) of fresh episodes."""
        cached = self.encode_text(instr, valid_mask, seq_len)
        percept = self.percept_step(cached, valid_mask, seq_len, inputs,
                                    lstm_kernel=lstm_kernel)
        state = DecoderState(percept["h0"], percept["c0"], percept["h0"])
        batch = instr.shape[0]
        state, logit, value, _aux = self.decode_from_percept(
            percept, valid_mask, state,
            torch.ones(batch, dtype=torch.bool, device=instr.device))
        return logit, value
