"""Configuration for dasa_tpu_torch.

A typed dataclass replaces the reference's module-global argparse singleton
(reference: r2r_src/param.py:18-216).  Every reference flag that affects the
DASA training/eval paths is present under the same (snake_case) name so the
reference's README commands translate 1:1.  Unlike the reference, the config
is an explicit value passed down the stack — nothing reads global state — so
jitted programs can close over a frozen config without retracing hazards.

This is a copy of the JAX package's ``dasa_tpu/config.py`` with the same
fields, so one set of keyword arguments configures both packages.  The
comments on the execution knobs describe the JAX programs; the PyTorch port
reads ``compute_dtype`` and ``use_pallas`` and ignores the knobs of paths it
has not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Optional


def _default_connectivity_dir() -> str:
    """$DASA_CONNECTIVITY_DIR > ./connectivity (see
    scripts/fetch_connectivity.py)."""
    return os.environ.get("DASA_CONNECTIVITY_DIR") or "connectivity"


@dataclass(frozen=True)
class Config:
    # General (param.py:23-25)
    iters: int = 100_000
    name: str = "default"
    train: str = "listener"

    # Data preparation (param.py:30-36)
    max_input: int = 80           # --maxInput
    max_decode: int = 120         # --maxDecode
    max_action: int = 20          # --maxAction
    batch_size: int = 64          # --batchSize
    ignoreid: int = -100
    feature_size: int = 2048
    load_optim: bool = False      # --loadOptim

    # Checkpoints to load (param.py:39-44)
    speaker: Optional[str] = None
    listener: Optional[str] = None
    load: Optional[str] = None
    aug: Optional[str] = None     # augmented-path json for auglistener

    # Aux heads (param.py:47-54)
    pred_back: bool = False
    back_input: str = "pre"       # pre | cur
    use_action_seq: bool = False
    pred_pm: bool = False
    pm_type: str = "att"          # att | att_hid | plain_att | plain_att_hid

    # Listener training weights (param.py:57-64)
    zero_init: bool = False
    ml_weight: float = 0.05
    ml_weight_org: float = 0.2
    ml_weight_aug: float = 0.6
    teacher_weight: float = 1.0
    accumulate_grad: bool = False
    features: str = "imagenet"
    dfeatures: str = "imagenet"

    # Env dropout (param.py:67)
    featdropout: float = 0.3

    # SSL / submission (param.py:70-77)
    self_train: bool = False
    candidates: int = 1
    param_search: bool = False
    submit: bool = False
    beam: bool = False
    alpha: float = 0.5
    # beam_valid search flavor: "dijkstra" keys states by (viewpoint,
    # arriving action) (agent_dg.py:1038-1325); "state_factored" keeps
    # one state per physical pose — the speaker-follower search
    # (tasks/R2R/speaker/follower.py:720-980, test entry 987-999)
    search_type: str = "dijkstra"  # dijkstra | state_factored
    successor_size: int = 4        # state_factored frontier per round
    max_expansions: int = 0        # search budget; 0 = per-search default

    # Optimization (param.py:80-90)
    optim: str = "rms"            # rms | adam | sgd | adamw
    lr: float = 1e-4
    weight_decay: float = 0.0
    dropout: float = 0.5
    feedback: str = "sample"      # teacher | sample | argmax
    teacher: str = "final"
    epsilon: float = 0.1
    use_lr_scheduler: bool = False

    # Model dims (param.py:93-109)
    rnn_dim: int = 512
    critic_dim: int = 512
    wemb: int = 256
    aemb: int = 64
    proj: int = 512
    fast_train: bool = False
    bidir: bool = True
    sub_out: str = "tanh"         # tanh | max
    attn: str = "soft"
    angle_feat_size: int = 4

    # Encoder selection (param.py:112-117)
    update_bert: bool = False
    include_vision: bool = False
    use_dropout_vision: bool = False
    # EncoderLSTM | BEncoder | CEncoder | Dic (cross-modal) |
    # Transformer | Gpt | BertImg | BertAdd (legacy zoo, models/legacy.py)
    encoder_type: str = "EncoderLSTM"
    schedule_ratio: float = -1.0

    # Legacy transformer/gpt encoders (tasks/R2R/train.py:795-799; the
    # reference's widths come from pretrained checkpoints we can't
    # download, so these are free knobs)
    legacy_width: int = 256
    legacy_heads: int = 8
    legacy_layers: int = 2

    # DicEncoder / DicModel (param.py:121-137)
    d_hidden_size: int = 1024
    d_ctx_size: int = 2048
    d_enc_hidden_size: int = 768
    d_dropout_ratio: float = 0.4
    # BERT-internal dropout probs (BertConfig defaults in the reference,
    # vilmodel.py); exposed so tests can run the cross-modal stack
    # noise-free
    d_hidden_dropout_prob: float = 0.1
    d_attn_dropout_prob: float = 0.1
    d_bidirectional: bool = True
    d_transformer_update: bool = False   # update lang-BERT weights
    d_update_add_layer: bool = False     # update cross-modal layers
    d_bert_n_layers: int = 1
    d_reverse_input: bool = True
    d_top_lstm: bool = True
    d_vl_layers: int = 4
    d_la_layers: int = 9
    d_v_layers: int = 0
    d_bert_type: str = "small"           # small (768) | large (1024)
    pretrain_model_name: Optional[str] = None
    pretrain_model_type: str = "DicAddActionPreTrain"

    # Schedules / logging (param.py:138-146)
    log_every: int = 100
    warm_steps: int = 1000
    decay_start: int = 4000
    decay_intervals: int = 2000
    lr_decay: float = 0.2
    val_every: int = 1000
    save_every: int = 5000
    is_test: bool = False

    # A2C (param.py:150-151)
    gamma: float = 0.9
    normalize_loss: str = "total"  # total | batch | none

    # Mini dataset / agent selection (param.py:155-159)
    mini: bool = False
    agent_type: str = "default"

    # Pretraining (param.py:162-168)
    word_mask_rate: float = 0.15
    tasks: str = "lmask"
    lmask_weight: float = 1.0
    action_weight: float = 1.0
    pm_weight: float = 1.0
    back_weight: float = 1.0
    pretrain_isnext: bool = False  # add the NSP-style isnext objective
                                   # (batch_loader.py:419-432 negative
                                   # next-view sampling)

    # Depth-guided AdaIN (param.py:171-178)
    depth_index_file: str = "data/viewpointIds.npy"
    depth_value_file: str = "data/ResNet-152-imagenet-depth.npy"
    decoder_type: str = "default"  # default | dyrelu (param.py:175)
    adain_type: str = "none"       # none|default|channel|coco_channel|meanchannel|
                                   # rgb_channel|rgb_meanchannel|rgb_stat_channel|depth_stat_channel
    ab_type: str = "ab"            # ab | a | b
    a_type: Optional[str] = None   # sigmoid | gumbel_sigmoid | None
    env_drop_stage: str = "after_adain"  # before_adain | after_adain
    depth_drop: bool = False

    # Shift attention (param.py:181-184)
    use_shift: bool = False
    shift_kernel_size: int = 3

    # Consistent dropout (param.py:187-190)
    consistent_drop: bool = False
    decoder_consistent_drop: bool = False

    # Contextualized view (param.py:195)
    ctx_v: bool = False

    # MCAN / agent_mcatt dims (param.py:159, 233-244)
    mcan_hidden_size: int = 768   # HIDDEN_SIZE (== FLAT_OUT_SIZE)
    mcan_heads: int = 8           # MULTI_HEAD
    mcan_layers: int = 2          # --layer
    mcan_flat_mlp_size: int = 512  # FLAT_MLP_SIZE

    # NDH / CVDN (reference: r2r_src/ndhtrain.py:374-434)
    path_type: str = "trusted_path"  # planner_path | player_path | trusted_path
    history: str = "all"             # none|target|oracle_ans|nav_q_oracle_ans|all

    # ---- dasa_tpu_torch-specific ----
    # Data-parallel listener training: build a ('data','model') mesh over
    # the available devices and shard episode batches over `data`
    # (replaces tasks/R2R/parallel.py:24-119 + NCCL DDP).
    data_parallel: bool = False
    n_data: Optional[int] = None   # data-axis size; None => all devices
    # Fused on-device training rollouts (env transitions as table
    # gathers inside the grad program; zero host round-trips per pass).
    # auto: on for training rollouts that don't need the host env
    # mid-episode; never: always use the host act/replay path.
    device_rollout: str = "auto"   # auto | never
    # Run the teacher-ML and sampled-RL passes of one accumulate pair
    # as ONE 2B-wide slot-weighted device program (the MXU rows at
    # batch 20 are mostly padding, so the teacher half rides the
    # sampled scan's weight reads nearly free — BENCH_NOTES.md round-3
    # batch-width probe).  never: dispatch the two passes separately.
    fuse_passes: str = "never"     # auto | never
    # Streaming rollouts (continuous batching): the sampled-RL training
    # pass keeps every batch slot busy by resetting a slot to the next
    # episode from a pre-staged on-device pool the moment its episode
    # ends, instead of masking ended rows until the batch max episode
    # length.  One optimizer window = stream_steps scan steps; episodes
    # crossing a window boundary bootstrap the A2C return with the
    # critic's value (the SAME mechanism the reference applies at its
    # maxAction truncation, agent_dg.py:962-981, applied at window
    # edges) and carry their decoder state into the next window
    # (truncated BPTT at the boundary).  Episode trajectories are
    # unchanged (tests/test_stream.py proves each streamed episode
    # matches its standalone argmax rollout); what changes is the
    # optimizer-step granularity and the noise stream — a throughput
    # regime, not a bitwise-reproducibility knob.  episodic: the
    # reference's per-minibatch update structure (the default).
    rollout_mode: str = "episodic"  # episodic | stream
    stream_steps: int = 0          # scan steps per optimizer window
                                   # (0 => max_action)
    stream_pool: int = 0           # fresh episodes staged per pass half
                                   # per window (0 => auto-sized from
                                   # the dataset's mean path length)
    # lax.scan unroll factor for the stream window scan: k>1 lets XLA
    # keep the per-step weight-grad accumulators and decoder carry in
    # registers/VMEM across k consecutive steps instead of round-
    # tripping HBM every step (the elementwise/loop-fusion class sits
    # at the HBM roofline — BENCH_NOTES.md round-3 trace).  Numerics
    # are unchanged (same per-step ops, same rng folds); compile time
    # grows with k.  Only the stream scan: the episodic device
    # program's early-exit cond measured SLOWER unrolled
    # (agents/seq2seq.py:1001).
    stream_unroll: int = 1
    # large-update LR rule for the stream regime: "sqrt" scales lr by
    # sqrt(k) and the warmup/decay schedule iterations by 1/k, where
    # k is the update-size ratio vs the reference's episodic
    # accumulate pair (one stream update is W*S agent-steps vs the
    # pair's 2B*mean_episode_len, so k = S / dataset mean episode
    # length).  Measured to close stream-auto's val_seen deficit at
    # matched agent-steps (BENCH_NOTES.md round-5).  "none" keeps the
    # published reference schedule untouched (bit-comparable
    # semantics, the default).
    lr_scale_rule: str = "none"    # none | sqrt
    # PRNG bit generator for every random draw (dropout masks,
    # categorical sampling).  threefry: JAX's default, stable across
    # versions/backends; rbg: hardware RNG, much cheaper per-step
    # dropout-mask generation on TPU (the per-step threefry masks show
    # up at ~2-4% of the fused rollout trace).  Changing it changes
    # the noise stream, not the distribution.
    prng_impl: str = "threefry"    # threefry | rbg
    seed: int = 10
    views: int = 36                # panorama views (12 headings x 3 elevations)
    max_candidates: int = 16       # fixed candidate padding incl. STOP slot
                                   # (max graph degree across 90 scans is 13)
    data_dir: str = "data/task"    # R2R_{split}.json location
    # resolution order: explicit flag > $DASA_CONNECTIVITY_DIR >
    # ./connectivity (scripts/fetch_connectivity.py) > the reference
    # checkout present in this container
    connectivity_dir: str = ""
    img_features_path: Optional[str] = None   # .npz feature store; None => synthetic
    depth_features_path: Optional[str] = None
    vocab_path: Optional[str] = None
    log_dir: str = "snap"
    compute_dtype: str = "bfloat16"   # activations dtype on TPU
    # rematerialization of long-rollout forwards during backward:
    # never (default) = keep all activations — fastest AND smallest at
    # the headline config (whole-step remat makes XLA stack per-step
    # weight-grad partials, OOMing where never fits); percept =
    # recompute only the per-step encoder block (bounds residual HBM
    # for larger models); dots = keep MXU outputs only, recompute
    # elementwise chains in the backward (jax checkpoint_dots policy);
    # auto = whole-step remat past 16 steps; always = whole-step remat
    # at any length
    remat: str = "never"
    param_dtype: str = "float32"
    # cast f32 params to the compute dtype ONCE per training program
    # (outside the step scan) instead of at every use site: forward
    # numerics are unchanged (use sites cast anyway), but the scan's
    # weight-grad carry then accumulates in bf16 — half the carry HBM
    # traffic and no per-step convert+reduce pass.  Grads convert to
    # f32 once at the end; the f32 master params/optimizer are
    # untouched.  No effect when compute runs in f32 (CPU/tests).
    bf16_grad_accum: bool = True
    use_pallas: str = "auto"          # auto | never | always
    snap_dir: str = "snap"
    result_dir: str = "results"
    cache_text_encoder: bool = True   # run the 9 text-only BERT layers once per
                                      # episode instead of once per step (exact
                                      # when update_lang_bert is False; the
                                      # reference recomputes them every step —
                                      # agent_dg.py:789-797)
    sim_backend: str = "auto"         # auto | native | python

    # -- derived --
    def __post_init__(self):
        if self.angle_feat_size % 4 != 0:
            raise ValueError("angle_feat_size must be a multiple of 4")
        # encoder-type aliases: reference spellings, plus the legacy-zoo
        # members whose architectures reduce to stacks we already build
        # (docs/DATA_LIMITS.md): VicModel is DicModel with the full
        # 12-layer text stack and no vision-only layers
        # (vilmodel.py:1098-1243); HugLang is the text-BERT -> top-LSTM
        # path (r2rmodel.py:814-900 == BEncoder); BertLang/HugAdd fuse
        # vision through joint add-layers with the image rows KEPT in
        # ctx (r2rmodel.py:1906-2061, 1331-1461 == BertAdd); BertMix is
        # its own type (BertAddEncoder with strip_vision_ctx=True —
        # image rows dropped after fusion, r2rmodel.py:1776).
        et = {"DicEncoder": "Dic", "VicEncoder": "Vic",
              "HugLang": "BEncoder", "HugAdd": "BertAdd",
              "BertLang": "BertAdd",
              "vlbert": "BertImg"}.get(self.encoder_type,
                                       self.encoder_type)
        if et == "Vic":
            et = "Dic"
            object.__setattr__(self, "d_la_layers", 12)
            object.__setattr__(self, "d_v_layers", 0)
        object.__setattr__(self, "encoder_type", et)
        if self.remat not in ("never", "percept", "dots", "auto",
                              "always"):
            raise ValueError(
                f"remat must be never|percept|dots|auto|always, got "
                f"{self.remat!r}")
        if self.fuse_passes not in ("auto", "never"):
            raise ValueError(f"fuse_passes must be auto|never, got "
                             f"{self.fuse_passes!r}")
        if self.rollout_mode not in ("episodic", "stream"):
            raise ValueError(f"rollout_mode must be episodic|stream, "
                             f"got {self.rollout_mode!r}")
        if self.stream_unroll < 1:
            raise ValueError(f"stream_unroll must be >= 1, got "
                             f"{self.stream_unroll}")
        if self.lr_scale_rule not in ("none", "sqrt"):
            raise ValueError(f"lr_scale_rule must be none|sqrt, got "
                             f"{self.lr_scale_rule!r}")
        if self.search_type not in ("dijkstra", "state_factored"):
            raise ValueError(f"search_type must be dijkstra|"
                             f"state_factored, got {self.search_type!r}")
        if self.prng_impl not in ("threefry", "rbg", "unsafe_rbg"):
            raise ValueError(f"prng_impl must be threefry|rbg|"
                             f"unsafe_rbg, got {self.prng_impl!r}")
        if self.path_type not in ("planner_path", "player_path",
                                  "trusted_path"):
            raise ValueError(f"path_type must be planner_path|"
                             f"player_path|trusted_path, got "
                             f"{self.path_type!r}")
        if self.history not in ("none", "target", "oracle_ans",
                                "nav_q_oracle_ans", "all"):
            raise ValueError(f"history must be none|target|oracle_ans|"
                             f"nav_q_oracle_ans|all, got "
                             f"{self.history!r}")
        if self.agent_type == "mt" and not (
                self.include_vision and self.encoder_type == "Dic"):
            # the MT decoder reads the DicEncoder's per-view BERT tokens
            # (v_emb; model.py:1688) — no other encoder produces them
            raise ValueError(
                "agent_type='mt' requires encoder_type='Dic' with "
                "include_vision=True (the MT decoder consumes the "
                "vision-BERT view tokens)")
        if not self.connectivity_dir:
            object.__setattr__(self, "connectivity_dir",
                               _default_connectivity_dir())

    @property
    def feature_all_size(self) -> int:
        return self.feature_size + self.angle_feat_size

    @property
    def bert_hidden_size(self) -> int:
        return 1024 if self.d_bert_type == "large" else 768

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


# CLI aliases matching the reference's exact flag spellings (param.py).
_REF_ALIASES = {
    "maxInput": "max_input",
    "maxDecode": "max_decode",
    "maxAction": "max_action",
    "batchSize": "batch_size",
    "loadOptim": "load_optim",
    "zeroInit": "zero_init",
    "mlWeight": "ml_weight",
    "mlWeight_org": "ml_weight_org",
    "mlWeight_aug": "ml_weight_aug",
    "teacherWeight": "teacher_weight",
    "accumulateGrad": "accumulate_grad",
    "selfTrain": "self_train",
    "paramSearch": "param_search",
    "decay": "weight_decay",
    "rnnDim": "rnn_dim",
    "subout": "sub_out",
    "angleFeatSize": "angle_feat_size",
    "encoderType": "encoder_type",
    "adaIn_type": "adain_type",
    "normalize": "normalize_loss",
    "fast": "fast_train",
    "candidate": "candidate_mask",
}

_BOOL_FIELDS = {
    f.name for f in dataclasses.fields(Config) if f.type in ("bool", bool)
}


def _str2bool(v: str) -> bool:
    """The reference README passes explicit values to boolean flags
    (`--include_vision True`, `--d_update_add_layer True` —
    README.md:92-136).  The reference's own `type=bool` made any
    non-empty string truthy (argparse bool('False') is True); we parse
    the spelling properly so `--flag False` means False."""
    if v.lower() in ("true", "1", "yes"):
        return True
    if v.lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


# --train modes that run the NDH/CVDN task (train.py dispatch)
NDH_MODES = ("ndh", "ndhlistener", "validndh")


def ndh_budgets(path_type: str, history: str) -> tuple:
    """(max_action, max_input) the reference derives from the NDH task
    variant (ndhtrain.py:421-444, the uncommented values): episodes get
    20 steps on planner paths, 40 on player/trusted paths; the input
    budget scales with how much dialog history the instruction keeps —
    1 (<EOS> only) / 3 (<TAR> target <EOS>) / 70 (oracle answer) /
    80 (question + answer) / 300 (the whole dialog)."""
    max_action = 20 if path_type == "planner_path" else 40
    max_input = {"none": 1, "target": 3, "oracle_ans": 70,
                 "nav_q_oracle_ans": 80, "all": 300}[history]
    return max_action, max_input


def parse_args(argv=None) -> Config:
    """Build a Config from CLI args, accepting both snake_case names and the
    reference's camelCase spellings (e.g. --batchSize and --batch_size).
    Boolean flags work bare (`--depth_drop`), with an explicit value
    (`--include_vision True`, the reference README spelling), or negated
    (`--no_depth_drop`)."""
    parser = argparse.ArgumentParser(description="dasa_tpu_torch")
    defaults = Config()
    for f in dataclasses.fields(Config):
        name = f.name
        default = getattr(defaults, name)
        if name in _BOOL_FIELDS:
            parser.add_argument(f"--{name}", nargs="?", const=True,
                                type=_str2bool, default=default)
            parser.add_argument(f"--no_{name}", dest=name,
                                action="store_const", const=False)
        else:
            typ = type(default) if default is not None else str
            parser.add_argument(f"--{name}", type=typ, default=default)
    # alias flags
    for ref_name, attr in _REF_ALIASES.items():
        if attr not in {f.name for f in dataclasses.fields(Config)}:
            continue
        if attr in _BOOL_FIELDS:
            parser.add_argument(f"--{ref_name}", dest=attr, nargs="?",
                                const=True, type=_str2bool)
        else:
            default = getattr(defaults, attr)
            typ = type(default) if default is not None else str
            parser.add_argument(f"--{ref_name}", dest=attr, type=typ)
    ns = parser.parse_args(argv)
    kw = {f.name: getattr(ns, f.name) for f in dataclasses.fields(Config)}
    cfg = Config(**kw)
    if cfg.train in NDH_MODES:
        # NDH derives its episode/input budgets from path_type/history
        # (ndhtrain.py:421-444) — R2R's 20/80 defaults would silently
        # truncate `--history all` dialogs.  Explicit --max_action /
        # --max_input flags still win.
        given = {a[2:].split("=", 1)[0]
                 for a in (sys.argv[1:] if argv is None else argv)
                 if a.startswith("--")}
        max_action, max_input = ndh_budgets(cfg.path_type, cfg.history)
        upd = {}
        if not given & {"max_action", "maxAction", "no_max_action"}:
            upd["max_action"] = max_action
        if not given & {"max_input", "maxInput", "no_max_input"}:
            upd["max_input"] = max_input
        if upd:
            cfg = cfg.replace(**upd)
    return cfg
