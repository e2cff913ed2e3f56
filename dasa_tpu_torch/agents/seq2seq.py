"""The navigation agent: device and host rollouts, training and evaluation.

Counterpart of ``dasa_tpu/agents/seq2seq.py`` (reference
r2r_src/agent_dg.py:58-100, 633-1510).  Feature tables and env tables live
on the device, and the graph walk is tensor gathers
(``env/device_env.py``), so the device paths run no host env mid-episode:

- evaluation (``_device_eval_fn`` :2023, ``test`` :2143): one batch runs
  its whole argmax episode as a Python loop over ``max_action`` steps; the
  host rebuilds the trajectories from the recorded (T, B) tensors;
- training (``device_rollout`` :1537): a teacher pass walks the shortest
  path with gathers only and replays it as ONE batched-percept forward
  plus the sequential decoder; a sampled (or argmax) pass runs the policy,
  the env transition and the loss bookkeeping step by step, stops once
  every row has ended, and ends in the reversed A2C pass.  Autograd
  accumulates both passes' gradients in the parameters' ``.grad``;
  ``optim_step`` applies them.

The host act/replay rollout (``rollout`` :1685) steps the host env
instead: an act step per env step (the policy under ``no_grad``, then a
masked argmax, a sample or the teacher), then, when training, ONE replay
of the recorded episode through the device teacher pass's replay body.
It serves ``device_rollout="never"``, ``--submit`` (the visited-candidate
mask needs the host's per-episode visited sets), ``test(iters=...)`` and
selfTrain under stream.  Both phases take the encoder's LSTMs on their
plain path, as the JAX act and replay pass no ``lstm_pallas``
(``seq2seq.py:167-172``), so that the replay scores what the act step
computed; under ``use_pallas="always"`` the AdaIN gate and the shift
attention run their kernels in both.

The device passes draw dropout masks, the env-drop noise and sampled
actions from one ``torch.Generator`` reseeded per rollout from (seed,
rollout counter), the JAX agent's ``fold_in(_base_rng,
_rollout_counter)``; the host rollout draws from a generator per (step,
stream) (:class:`PassStreams`).  The two frameworks' streams differ, so
parity with the JAX package holds with dropout off and the noise passed
in.  Under ``rollout_mode="stream"`` training and evaluation run the
continuous-batching windows of ``agents/stream.py`` instead.  selfTrain
back-translation (a ``speaker`` handed to ``accumulate_gradient``)
relabels each batch before its pass.

``fuse_passes="auto"`` is a documented no-op: the JAX agent's combined
2B-wide program (``device_rollout_combined``, seq2seq.py:1246-1375) halves
the XLA dispatches of the episodic pair, which eager torch does not
have, so the port runs the split teacher + sampled pair, whose gradients
the combined program sums (``tests/test_torch_knobs.py`` holds JAX's
combined program against it).  ``remat`` recomputes blocks of a pass
in its backward (``models/layers.py:checkpointed``) where the JAX agent
applies ``jax.checkpoint``: the batched replay percept, the per-step
percept, or the whole step (:meth:`Seq2SeqAgent._recompute`).  Every pass
runs its backward inside the cast-once block, so a recompute reads the
same bf16 weight copies as the forward.
"""

from __future__ import annotations

import contextlib
import functools
import os
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from dasa_tpu_torch.agents.stream import StreamMixin
from dasa_tpu_torch.config import Config
from dasa_tpu_torch.data.features import FeatureDB
from dasa_tpu_torch.env import R2REnv
from dasa_tpu_torch.env.device_env import (
    DeviceEnvTables,
    device_obs,
    device_transition,
    episode_inputs,
)
from dasa_tpu_torch.models.featurize import (
    angle_feature,
    assemble_candidates,
    assemble_pano,
)
from dasa_tpu_torch.models.layers import (
    NEG_INF,
    cast_params_once,
    checkpointed,
)
from dasa_tpu_torch.models.policy import (
    DasaPolicy,
    DecoderState,
    StepInputs,
    decoder_state_width,
)
from dasa_tpu_torch.parallel import DataMesh, rank_seed
from dasa_tpu_torch.sim.engine import micro_trajectory
from dasa_tpu_torch.train.optim import COMPONENTS, ComponentOptimizer
from dasa_tpu_torch.utils import flax_msgpack
from dasa_tpu_torch.utils.angles import (
    all_point_angle_feature,
    view_rel_weight_table,
)
from dasa_tpu_torch.utils.device import resolve_device
from dasa_tpu_torch.utils.jax_params import policy_state_dict_from_jax
from dasa_tpu_torch.utils.pretrain_load import load_pretrained_encoder

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the reference's component names where they differ from the port's
# (agent_dg.py:1466-1487)
REFERENCE_COMPONENTS = {"adaIn": "adain"}
# the observation fields a replay re-reads (seq2seq.py:682-684)
REC_KEYS = ("feat_row", "view_index", "heading", "elevation",
            "cand_point_id", "cand_heading", "cand_elevation", "cand_n",
            "teacher", "back_teacher", "logit_mask")


def make_step_inputs(cfg: Config, tables, sobs) -> StepInputs:
    """Gather pano/candidate features on device from resident tables."""
    feat_table, dfeat_table, angle_table = tables
    f_t = assemble_pano(feat_table, angle_table, sobs["feat_row"],
                        sobs["view_index"])
    cand = assemble_candidates(
        feat_table, sobs["feat_row"], sobs["cand_point_id"],
        sobs["cand_heading"], sobs["cand_elevation"], sobs["cand_n"],
        cfg.angle_feat_size)
    if dfeat_table is not None:
        d_t = assemble_pano(dfeat_table, angle_table, sobs["feat_row"],
                            sobs["view_index"])
        cand_d = assemble_candidates(
            dfeat_table, sobs["feat_row"], sobs["cand_point_id"],
            sobs["cand_heading"], sobs["cand_elevation"], sobs["cand_n"],
            cfg.angle_feat_size)
    else:
        d_t, cand_d = f_t, cand
    act_feat = angle_feature(sobs["heading"], sobs["elevation"],
                             cfg.angle_feat_size).to(f_t.dtype)
    # view-token index per candidate slot (the STOP slot and the padding
    # -> the learned stop token at index `views`); the MT decoder's
    slots = torch.arange(sobs["cand_point_id"].shape[-1],
                         device=f_t.device)
    cand_idx = torch.where(slots >= sobs["cand_n"][..., None], cfg.views,
                           sobs["cand_point_id"].clamp(0, cfg.views - 1))
    return StepInputs(act_feat, f_t, d_t, cand, cand_d, sobs["logit_mask"],
                      cand_idx.long())


def _entropy(logp, p):
    return -torch.where(p > 0, p * logp, 0.0).sum(-1)


@functools.lru_cache(maxsize=None)
def _view_weights(device: torch.device) -> torch.Tensor:
    """The (36, 36) view-proximity table on ``device``, made once."""
    return torch.as_tensor(view_rel_weight_table(), device=device)


def mt_kl_rows(logp, teacher, cand_point_id, cand_n, has_row):
    """Per-row soft-distance KL of the MT agent (agent_mt.py:712-718,
    ``dasa_tpu/agents/seq2seq.py:101``).  The target over each row's real
    candidate slots is the softmax of the angular-proximity weights
    between each candidate's view and the teacher candidate's view
    (utils.py:703-713; the other slots masked to -1e5); the elements are
    target * (log target - logp) over the real slots of the rows
    ``has_row`` (a real teacher move).  Returns (kl_row, cnt_row): each
    row's summed elements and their count; the caller divides the sums
    for the reference's per-step ``mean``."""
    k = logp.shape[-1]
    table = _view_weights(logp.device)
    views = cand_point_id.clamp(0, table.shape[0] - 1)
    t_view = views.gather(1, teacher.clamp(0, k - 1)[:, None])[:, 0]
    w = table[t_view[:, None], views]                         # (B, K)
    real = torch.arange(k, device=logp.device)[None, :] < cand_n[:, None]
    tgt = torch.softmax(torch.where(real, w, -1e5), dim=-1)
    valid = real & has_row[:, None]
    elem = torch.where(valid, torch.xlogy(tgt, tgt) - tgt * logp.float(),
                       0.0)
    return elem.sum(-1), valid.sum(-1).float()


def back_ce(aux, sobs):
    """Cross-entropy of the back head's masked logits with the teacher's
    move back toward the start (seq2seq.py:481-488), per row."""
    back = aux["back_logit"].float().masked_fill(sobs["logit_mask"], NEG_INF)
    blogp = torch.log_softmax(back, dim=-1)
    return -blogp.gather(1, sobs["back_teacher"][:, None])[:, 0]


def aux_terms(cfg, aux, logp, sobs, active, pm_target, real,
              n_rows: int) -> dict:
    """One step's auxiliary loss terms of the episodic passes
    (seq2seq.py:481-515, 897-956): the back head's cross-entropy per row
    (every row), the progress monitor's and agent_advanced's squared error
    against the episode-start progress ``pm_target`` as batch means over
    the ``n_rows`` rows of the whole batch (all ranks'), times ``real`` (0
    on a step where no row of the batch is active), and the MT agent's KL
    as the step's summed elements (``kl``) and their count (``kl_cnt``),
    which :meth:`Seq2SeqAgent._finish_loss` divides once the count is
    summed over the ranks."""
    outs = {}
    if cfg.pred_back:
        outs["back_ce"] = back_ce(aux, sobs)
    if cfg.pred_pm:
        outs["pm_mse"] = ((aux["pm_score"].float() - pm_target) ** 2
                          ).sum() / n_rows * real
    if cfg.agent_type == "advanced":
        outs["adv_pm_mse"] = ((aux["pred_progress"].float() - pm_target)
                              ** 2).sum() / n_rows * real
    if cfg.agent_type == "mt":
        kl_row, cnt_row = mt_kl_rows(
            logp, sobs["teacher"], sobs["cand_point_id"], sobs["cand_n"],
            active & (sobs["teacher"] < sobs["cand_n"]))
        outs["kl"] = kl_row.sum()
        outs["kl_cnt"] = cnt_row.sum()
    return outs


def start_progress(dev, ep) -> torch.Tensor:
    """The episode-start progress, the progress monitor's target (=0 up
    to the eps term; the reference reads it once before the step loop,
    agent_dg.py:683, 864-866)."""
    goal = ep["goal"]
    total = dev.dist[ep["node0"], goal - dev.node_base[goal]]
    return 1.0 - total / (total + 1e-10)


def _env_and_reward(arrays, sobs, node, view, action, ended, goal_local):
    """Transition + reward shaping (agent_dg.py:900-926,
    seq2seq.py:703-716): +1 / -1 for a move closer to / away from the
    goal, +2 / -2 for stopping within / beyond 3 m, 0 once ended."""
    new_node, new_view, stop = device_transition(arrays, node, view, action,
                                                 ended)
    dist_new = arrays[6][new_node, goal_local]
    delta = sobs["distance"] - dist_new
    move_r = (delta > 0).float() - (delta < 0).float()
    stop_r = torch.where(dist_new < 3.0, 2.0, -2.0)
    reward = torch.where(ended, 0.0, torch.where(stop, stop_r, move_r))
    return new_node, new_view, ended | stop, reward


def _record(sobs, ended, is_first: bool, action):
    """The replay's per-step record of an observation."""
    rec = {key: sobs[key] for key in REC_KEYS}
    rec["active"] = ~ended
    rec["is_first"] = torch.full_like(ended, is_first)
    rec["action"] = action
    return rec


def _stack(recs: List[dict]) -> dict:
    return {key: torch.stack([r[key] for r in recs]) for key in recs[0]}


class PassStreams:
    """Where one training pass draws its randomness.

    With ``gen``, every draw comes from that generator in call order (the
    device passes).  Otherwise each (step, stream) has a generator of its
    own, seeded from ``seed`` as the JAX agent folds the step and the
    stream into its rollout key (``seq2seq.py:351-356``, ``:431-433``):
    stream 0 draws step ``t``'s percept dropout, 1 its decoder dropout, 2
    a sampled action; step -1 is the rollout's own (0 the env-drop noise,
    1 the text encoder's dropout).  The host act step and its replay then
    draw the same masks: the replay's batched percepts take the list of
    the steps' generators, one block of rows each
    (``models/layers.py:dropout``)."""

    def __init__(self, device, seed: int = 0,
                 gen: Optional[torch.Generator] = None):
        self.device, self.seed, self.gen = device, seed, gen

    def at(self, t: int, stream: int) -> torch.Generator:
        if self.gen is not None:
            return self.gen
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.seed * 4096 + t + 1) * 4 + stream)
        return gen

    def steps(self, n: int, stream: int):
        """The generator(s) of steps 0..n-1's rows batched together."""
        if self.gen is not None:
            return self.gen
        return [self.at(t, stream) for t in range(n)]

    @property
    def text(self) -> torch.Generator:
        return self.at(-1, 1)


class Seq2SeqAgent(StreamMixin):
    """Listener agent for the DASA dg path: episodic or streamed device
    training (teacher-ML + sampled A2C) and argmax evaluation.

    Runs on CUDA unless ``device`` names another device (the tests pass
    ``device="cpu"``).  Compute runs in ``cfg.compute_dtype`` on the card
    and in f32 on the CPU; parameters are f32, made from ``rng_seed``.
    ``cfg.use_pallas`` keeps the JAX package's meaning: ``auto`` routes
    only the encoder's LSTMs (the Dic top LSTM, a plain or legacy
    encoder's, McattEncoder's) of the sampled pass, the stream window,
    evaluation and search through their kernels, ``always`` also the
    AdaIN gate and the shift attention, ``never`` none.  The JAX package
    routes only the Dic top LSTM through its kernel; the others compute
    the same function.  ``vocab_size`` is the word vocab of the encoders
    that embed words themselves.

    ``mesh`` (``parallel.make_mesh``) makes the agent one rank of a
    data-parallel job, rank r in JAX device r's place: every rank draws
    the same global batch from an identically seeded env and runs its
    ``B / D`` rows (``_rows``) through the device passes, the host act /
    replay rollout and the stream window; the sums that normalise or
    report a loss are summed over the ranks, so each rank's loss is its
    share of the single-device loss, and ``optim_step`` sums the
    gradients with one all-reduce before the update, which then equals
    the single-device update (GSPMD's, seq2seq.py:225-237).  The weights
    are broadcast from rank 0 at construction and after ``load``; only
    rank 0 saves; evaluation gathers every rank's records, so each rank
    holds the whole split's results.  Dropout and sampling draw from a
    stream of the rank's own; the env-drop noise is shared.  Where the
    ranks do not divide ``batch_size`` every rank runs the whole batch,
    the single-device math, as GSPMD replicates such arrays."""

    def __init__(self, cfg: Config, env: Optional[R2REnv],
                 feature_db: FeatureDB,
                 depth_db: Optional[FeatureDB] = None, vocab_size: int = 0,
                 rng_seed: int = 0, device=None,
                 mesh: Optional[DataMesh] = None):
        self.cfg = cfg
        self.env = env
        self.device = resolve_device(device)
        self.mesh = mesh
        # the mesh when it splits the batch (else every rank runs it all)
        self._dp = (mesh if mesh is not None
                    and mesh.divides(cfg.batch_size) else None)
        dtype = _DTYPES[cfg.compute_dtype]
        if self.device.type == "cpu":
            dtype = torch.float32
        self.dtype = dtype
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed + rng_seed)
            policy = DasaPolicy(cfg, vocab_size=vocab_size,
                                compute_dtype=dtype)
        if cfg.pretrain_model_name:
            # the encoder from the pretraining checkpoint, before the
            # optimizer sees the parameters (the reference's
            # `encoder.bert = premodel.bert`, seq2seq.py:174-190)
            state, missed = load_pretrained_encoder(policy.state_dict(),
                                                    cfg.pretrain_model_name)
            policy.load_state_dict(state)
            note = (f"; {len(missed)} unmatched leaves, e.g. {missed[:3]}"
                    if missed else "")
            print(f"Initialized encoder from pretrain checkpoint "
                  f"{cfg.pretrain_model_name}{note}", flush=True)
        # eval mode: dropout is explicit (a generator per pass), never
        # nn.Module.training
        self.policy = policy.to(self.device).eval()
        if mesh is not None:
            mesh.replicate_module(self.policy)
        self._lstm_kernel = cfg.use_pallas != "never"
        self.optimizer = ComponentOptimizer(self._scaled_lr_cfg(),
                                            self.policy)
        self._seed = cfg.seed + rng_seed
        self._gen = torch.Generator(device=self.device)
        self._rollout_counter = 0
        self._env_steps_log: List[torch.Tensor] = []
        self._pending_replays: List[dict] = []
        self.losses: List[torch.Tensor] = []
        self.logs = defaultdict(list)

        def table(values):
            return torch.as_tensor(np.asarray(values)).to(self.device, dtype)

        self.feat_table = table(feature_db.values)
        self.dfeat_table = (table(depth_db.values)
                            if depth_db is not None else None)
        self.angle_table = table(
            all_point_angle_feature(cfg.angle_feat_size))
        self._dev_env_cache: Dict[int, tuple] = {}
        self.results: Dict[str, dict] = {}
        self.total_env_steps = 0  # (episode, step) pairs processed

    def _scaled_lr_cfg(self) -> Config:
        """The optimizer's config.  ``lr_scale_rule="sqrt"`` under stream
        (seq2seq.py:192-211): one stream update covers W * S agent-steps
        against the episodic pair's 2B * mean length, so lr is scaled by
        sqrt(k) and the schedule's iterations by 1 / k, with k = window
        steps / mean episode length (at least 1).  Records
        ``applied_lr_schedule``."""
        cfg = self.cfg
        if cfg.lr_scale_rule == "sqrt" and cfg.rollout_mode == "stream":
            k = max(1.0, (cfg.stream_steps or cfg.max_action)
                    / self._stream_mean_len())
            cfg = cfg.replace(
                lr=cfg.lr * float(np.sqrt(k)),
                warm_steps=int(np.ceil(cfg.warm_steps / k)),
                decay_start=int(np.ceil(cfg.decay_start / k)),
                decay_intervals=max(1, round(cfg.decay_intervals / k)))
            print(f"lr_scale_rule=sqrt: k={k:.2f} lr={cfg.lr:.3g} "
                  f"warm={cfg.warm_steps} "
                  f"decay={cfg.decay_start}/{cfg.decay_intervals}",
                  flush=True)
        self.applied_lr_schedule = {
            "lr": cfg.lr, "warm_steps": cfg.warm_steps,
            "decay_start": cfg.decay_start,
            "decay_intervals": cfg.decay_intervals}
        return cfg

    @property
    def tables(self):
        return (self.feat_table, self.dfeat_table, self.angle_table)

    # ------------------------------------------------------------------
    # data parallel (parallel/mesh.py)
    # ------------------------------------------------------------------
    def _n_shards(self) -> int:
        return 1 if self._dp is None else self._dp.n_data

    def _rows(self, n: int) -> slice:
        """This rank's rows of a batch axis of ``n``."""
        return slice(0, n) if self._dp is None else self._dp.rows(n)

    def _allsum(self, x: torch.Tensor) -> torch.Tensor:
        return x if self._dp is None else self._dp.allsum(x)

    def _all_ended(self, ended: torch.Tensor) -> bool:
        """Whether every row of the whole batch has ended (a host sync)."""
        if self._dp is None:
            return bool(ended.all())
        return int(self._dp.allsum((~ended).sum())) == 0

    def _reduce_logs(self, logs: dict) -> dict:
        """The logged sums over the ranks, in one all-reduce."""
        if self._dp is None or not logs:
            return logs
        keys = sorted(logs)
        vec = self._dp.allsum(torch.stack([logs[k].detach().float()
                                           for k in keys]))
        return {k: vec[i].to(logs[k].dtype) for i, k in enumerate(keys)}

    def _pass_generator(self, gen: torch.Generator) -> torch.Generator:
        """Under data parallel, ``gen`` reseeded for this rank's dropout
        and sampling draws, after the draws every rank shares."""
        if self._dp is not None and self._dp.n_data > 1:
            gen.manual_seed(rank_seed(int(gen.initial_seed()), self._dp))
        return gen

    def load_jax_params(self, params) -> None:
        """Load the JAX package's param tree (nested dicts of arrays, with
        or without the top-level ``params`` key)."""
        state = policy_state_dict_from_jax(params)
        self.policy.load_state_dict(
            {k: torch.as_tensor(np.asarray(v, np.float32))
             for k, v in state.items()})

    # ------------------------------------------------------------------
    def _device_env_tables(self) -> DeviceEnvTables:
        """Device tables for the CURRENT env, cached per env object."""
        key = id(self.env)
        if key not in self._dev_env_cache:
            self._dev_env_cache[key] = (self.env, DeviceEnvTables.build(
                self.env, self.cfg.max_candidates, self.device))
        return self._dev_env_cache[key][1]

    def use_device_rollout(self) -> bool:
        """The device paths serve a rollout unless ``device_rollout`` is
        ``never`` or ``submit`` asks for the visited-candidate mask (the
        host rollout serves those)."""
        if self.cfg.device_rollout == "never" or self.env is None:
            return False
        return not self.cfg.submit and getattr(self.env, "graphs",
                                               None) is not None

    def _put(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x)).to(self.device)

    def _put_sobs(self, sobs: dict) -> dict:
        """A host observation record on the device; integer fields as
        int64 (indices), as the device paths record them."""
        out = {}
        for key, val in sobs.items():
            val = np.asarray(val)
            if val.dtype.kind in "iu":
                val = val.astype(np.int64)
            out[key] = self._put(val)
        return out

    def _batch_inputs(self):
        """Reset the env to its next minibatch; device inputs of it."""
        self.env.reset()
        return self._episode_tensors()

    def _episode_tensors(self):
        """Device inputs of the env's current minibatch: the env tables,
        the episode inputs and the instruction tensors."""
        env = self.env
        dev = self._device_env_tables()
        rows = self._rows(len(env.batch))
        ep = {k: self._put(v[rows])
              for k, v in episode_inputs(env, dev).items()}
        instr = self._put(env._static["instr"][rows]).long()
        valid = self._put(~env._static["pad_mask"][rows])
        seq_len = self._put(env._static["seq_len"][rows]).long()
        return dev, ep, instr, valid, seq_len

    @torch.no_grad()
    def _device_eval(self, dev: DeviceEnvTables, ep, instr, valid,
                     seq_len) -> Dict[str, torch.Tensor]:
        """The argmax episode of one batch; returns the (T, B) record."""
        cfg = self.cfg
        policy = self.policy
        arrays = dev.arrays()
        k = cfg.max_candidates
        batch = instr.shape[0]
        cached = policy.encode_text(instr, valid, seq_len, self._lstm_kernel)
        goal, start = ep["goal"], ep["start"]
        total_dist = dev.dist[ep["node0"], goal - dev.node_base[goal]]
        width = decoder_state_width(cfg)
        zeros = torch.zeros(batch, width, dtype=self.dtype,
                            device=self.device)
        state = DecoderState(zeros, zeros, zeros)
        node, view = ep["node0"], ep["view0"]
        ended = torch.zeros(batch, dtype=torch.bool, device=self.device)
        recs: Dict[str, list] = {"node": [], "view": [], "action": [],
                                 "active": [], "stop": []}
        for t in range(cfg.max_action):
            sobs = device_obs(arrays, node, view, goal, start, total_dist, k)
            if bool(ended.all()):
                # every row has stopped: skip the model, as the JAX
                # program's lax.cond does (seq2seq.py:2070-2074)
                action = torch.full((batch,), k - 1, dtype=torch.long,
                                    device=self.device)
            else:
                inputs = make_step_inputs(cfg, self.tables, sobs)
                is_first = torch.full((batch,), t == 0, dtype=torch.bool,
                                      device=self.device)
                state, logit, _value, _aux = policy.policy_step(
                    cached, valid, seq_len, inputs, state, is_first,
                    lstm_kernel=self._lstm_kernel)
                masked = logit.float().masked_fill(sobs["logit_mask"],
                                                   NEG_INF)
                action = masked.argmax(dim=-1)
            recs["node"].append(node)
            recs["view"].append(view)
            recs["action"].append(action)
            recs["active"].append(~ended)
            recs["stop"].append((action >= sobs["cand_n"]) & ~ended)
            node, view, stop = device_transition(arrays, node, view, action,
                                                 ended)
            ended = ended | stop
        out = {key: torch.stack(v) for key, v in recs.items()}
        out["final_node"] = node
        out["final_view"] = view
        return out

    def _device_test_batch(self) -> None:
        """Evaluate one env minibatch on device and record results (under
        data parallel every rank's records, gathered)."""
        env = self.env
        dev, ep, instr, valid, seq_len = self._batch_inputs()
        recs = self._device_eval(dev, ep, instr, valid, seq_len)
        if self._dp is not None:
            recs = {k: self._dp.all_gather(v, dim=v.dim() - 1)
                    for k, v in recs.items()}
        recs = {k: v.cpu().numpy() for k, v in recs.items()}
        nodes, views = recs["node"], recs["view"]
        stops, actives = recs["stop"], recs["active"]
        T = nodes.shape[0]
        for i, item in enumerate(env.batch):
            gids = env.graphs[item["scan"]].ids
            base = dev.base[item["scan"]]
            self.total_env_steps += int(actives[:, i].sum())

            def vp(global_node):
                return gids[int(global_node) - base]

            def angles(view):
                return ((int(view) % 12) * (np.pi / 6),
                        (int(view) // 12 - 1) * (np.pi / 6))

            tr = [(vp(nodes[0, i]), *angles(views[0, i]))]
            for t in range(T):
                if not actives[t, i] or stops[t, i]:
                    break
                nxt = nodes[t + 1, i] if t + 1 < T else recs["final_node"][i]
                nxt_view = (views[t + 1, i] if t + 1 < T
                            else recs["final_view"][i])
                micro_trajectory(vp(nodes[t, i]), int(views[t, i]),
                                 int(nxt_view), tr)
                tr.append((vp(nxt), *angles(nxt_view)))
            iid = item["instr_id"]
            self.results[iid] = {"instr_id": iid, "trajectory": tr}

    @torch.no_grad()
    def first_step_logits(self) -> torch.Tensor:
        """Masked f32 candidate logits of the first step of the env's next
        minibatch (the comparison point between kernel settings)."""
        dev, ep, instr, valid, seq_len = self._batch_inputs()
        goal = ep["goal"]
        total = dev.dist[ep["node0"], goal - dev.node_base[goal]]
        sobs = device_obs(dev.arrays(), ep["node0"], ep["view0"], goal,
                          ep["start"], total, self.cfg.max_candidates)
        inputs = make_step_inputs(self.cfg, self.tables, sobs)
        logit, _value = self.policy(instr, valid, seq_len, inputs,
                                    lstm_kernel=self._lstm_kernel)
        return logit.float().masked_fill(sobs["logit_mask"], NEG_INF)

    def test(self, use_dropout: bool = False, feedback: str = "argmax",
             iters: Optional[int] = None) -> List[dict]:
        """Loop rollouts until the dataset wraps (BaseAgent.test,
        agent_dg.py:58-100; seq2seq.py:2143-2172), or run ``iters``
        batches of a shuffled epoch.  The argmax, dropout-free evaluation
        of a whole split runs on the device (streamed under
        ``rollout_mode="stream"``); the rest runs the host rollout, which
        evaluates without dropout whatever ``use_dropout`` says, as the
        JAX agent does."""
        self.results = {}
        env = self.env
        env.reset_epoch(shuffle=iters is not None)
        device_eval = (feedback == "argmax" and not use_dropout
                       and iters is None and self.use_device_rollout())
        if iters is not None:
            for _ in range(iters):
                self.rollout(train_ml=None, train_rl=False,
                             feedback=feedback)
        elif device_eval and self.use_stream_rollout():
            self.stream_test_loop()
        else:
            for _ in range(env.size() // env.batch_size + 2):
                if device_eval:
                    self._device_test_batch()
                else:
                    self.rollout(train_ml=None, train_rl=False,
                                 feedback=feedback)
                if len(self.results) >= env.size():
                    break
        return list(self.results.values())

    def get_results(self) -> List[dict]:
        """Reference API parity (BaseAgent.get_results)."""
        return list(self.results.values())

    # ------------------------------------------------------------------
    # training: the episodic device regime (seq2seq.py:327-1204, 1400-1570,
    # 1907-2015)
    # ------------------------------------------------------------------
    @property
    def iter_count(self) -> int:
        return self.optimizer.iteration

    def _recompute(self, site: str, n_steps: int) -> bool:
        """Whether :func:`models.layers.checkpointed` recomputes a block
        of a pass under ``cfg.remat``, where the JAX agent applies
        ``jax.checkpoint``.  ``site`` is ``"replay"``, the batched percept
        of a replay of ``n_steps`` steps (seq2seq.py:441-450: ``always`` /
        ``percept`` / ``dots``, ``auto`` past 16 steps); ``"percept"``, the
        per-step percept of the fused pass and the stream window
        (:850-851, stream.py:332-333: ``percept``); or ``"step"``, their
        whole step over ``n_steps`` steps (:1000-1005, stream.py:493-498:
        ``always`` / ``dots``, ``auto`` past 16 steps).  ``dots`` recomputes
        the same blocks as ``always``: JAX's policy keeps the matmul
        outputs, which an eager selective checkpoint would keep beside
        what autograd saves anyway."""
        remat = self.cfg.remat
        if site == "replay":
            return remat in ("always", "percept", "dots") or (
                remat == "auto" and n_steps > 16)
        if site == "percept":
            return remat == "percept"
        return remat in ("always", "dots") or (remat == "auto"
                                               and n_steps > 16)

    def _rollout_generator(self) -> torch.Generator:
        """The generator of the next rollout, reseeded from (seed, rollout
        counter) as the JAX agent folds its counter into ``_base_rng``
        (seq2seq.py:1420-1422), so a rollout's draws do not depend on
        earlier ones."""
        self._gen.manual_seed(self._seed * 1_000_003 + self._rollout_counter)
        self._rollout_counter += 1
        return self._gen

    def _noise_fn(self, gen: torch.Generator) -> torch.Tensor:
        """The consistent env-drop mask of one rollout (seq2seq.py:327):
        each visual channel kept with probability 1 - featdropout, and
        scaled by 1 / (1 - featdropout)."""
        p = self.cfg.featdropout
        keep = torch.rand(self.cfg.feature_size, generator=gen,
                          device=self.device) < 1.0 - p
        return keep.to(self.dtype) / (1.0 - p)

    def _cast_params_once(self):
        """Under ``bf16_grad_accum`` with a bf16 compute dtype, the pass
        reads ONE bf16 copy of each weight, so the weight's gradient
        accumulates in bf16 across steps as in the JAX agent
        (seq2seq.py:384) instead of being cast per use."""
        if self.cfg.bf16_grad_accum and self.dtype == torch.bfloat16:
            return cast_params_once(self.policy, self.dtype)
        return contextlib.nullcontext()

    def _teacher_len(self) -> int:
        """Step bound of teacher-forced episodes (seq2seq.py:755): the
        longest dataset path (shortest-path hops <= len(path) - 1, + STOP)
        + 1 margin, capped at max_action."""
        t_max = self.cfg.max_action
        if self.env is None or not getattr(self.env, "data", None):
            return t_max
        return min(t_max, max(len(item["path"]) for item in self.env.data)
                   + 1)

    def _device_rollout_args(self, env_noise: Optional[torch.Tensor],
                             speaker=None):
        """Reset the env to its next minibatch and gather a pass's inputs:
        the device episode inputs, the rollout's generator and, under
        ``consistent_drop`` or with a ``speaker``, its env-drop noise
        (seq2seq.py:1400-1440).  ``env_noise`` replaces the drawn noise
        (parity tests pass the JAX agent's).  A ``speaker`` relabels the
        minibatch (selfTrain back-translation, decoding with the same
        noise) after the reset and before the inputs are gathered."""
        self.env.reset()
        gen = self._rollout_generator()
        noise = None
        if self.cfg.consistent_drop or speaker is not None:
            noise = (self._noise_fn(gen) if env_noise is None
                     else env_noise.to(self.device, self.dtype))
        if speaker is not None:
            speaker.relabel_batch(self.env, noise)
        return (*self._episode_tensors(), self._pass_generator(gen), noise)

    def _teacher_trajectory(self, dev: DeviceEnvTables, ep, n_steps: int):
        """Phase A of the teacher pass (seq2seq.py:718-743): the
        shortest-path walk of ``n_steps`` steps, gathers only, no policy.
        Returns (stacked records, final record, rewards, rl masks, final
        ended)."""
        arrays = dev.arrays()
        k = self.cfg.max_candidates
        goal, start = ep["goal"], ep["start"]
        goal_local = goal - arrays[8][goal]
        total_dist = arrays[6][ep["node0"], goal_local]
        node, view = ep["node0"], ep["view0"]
        ended = torch.zeros_like(node, dtype=torch.bool)
        recs, rewards, masks = [], [], []
        for t in range(n_steps):
            sobs = device_obs(arrays, node, view, goal, start, total_dist, k)
            action = sobs["teacher"]
            recs.append(_record(sobs, ended, t == 0,
                                torch.minimum(action, sobs["cand_n"])))
            masks.append((~ended).float())
            node, view, ended, reward = _env_and_reward(
                arrays, sobs, node, view, action, ended, goal_local)
            rewards.append(reward)
        sobs = device_obs(arrays, node, view, goal, start, total_dist, k)
        final = _record(sobs, ended, False, torch.zeros_like(node))
        return (_stack(recs), final, torch.stack(rewards), torch.stack(masks),
                ended)

    def _finish_loss(self, batch: int, outs: List[dict], rewards, rl_masks,
                     g0, ml_weight: float, rl_weight: float,
                     ent_weight: float):
        """The IL + A2C loss from the per-step outs (ce, logp_a, ent,
        value and the auxiliary terms of :func:`aux_terms`)
        (seq2seq.py:522-591, 1105-1202): ml_weight * (sum(ce) + the
        weighted auxiliary sums) / batch, and the A2C loss of the
        discounted returns bootstrapped from ``g0``, normalized by
        ``normalize_loss``.  The auxiliary sums are logged as
        ``back_loss`` (weighted), ``pm_loss`` (weighted; agent_advanced's
        raw) and ``kl_loss``.  Under data parallel ``batch`` is the whole
        batch's row count and the counts that normalise (the A2C total,
        the KL's elements) are summed over the ranks, so the loss is this
        rank's share of the single-device loss; the logs stay this rank's
        (:meth:`_reduce_logs` sums them)."""
        cfg = self.cfg
        grid = {key: torch.stack([o[key] for o in outs]) for key in outs[0]}
        ce, logp_a, ent, value = (grid[k] for k in ("ce", "logp_a", "ent",
                                                    "value"))
        forth_loss = ce.sum()
        ml_loss, logs = forth_loss, {}
        if cfg.pred_back:
            logs["back_loss"] = cfg.back_weight * grid["back_ce"].sum()
            ml_loss = ml_loss + logs["back_loss"]
        if cfg.pred_pm:
            logs["pm_loss"] = cfg.pm_weight * grid["pm_mse"].sum()
            ml_loss = ml_loss + logs["pm_loss"]
        if cfg.agent_type == "advanced":
            # fixed x10 weight (agent_advanced.py:564), logged raw
            logs["pm_loss"] = grid["adv_pm_mse"].sum()
            ml_loss = ml_loss + 10.0 * logs["pm_loss"]
        if cfg.agent_type == "mt":
            # rides the ml scaling (agent_mt.py:871), logged raw; each
            # step's mean over its valid elements
            cnt = self._allsum(grid["kl_cnt"])
            logs["kl_loss"] = (grid["kl"] / cnt.clamp(min=1.0)).sum()
            ml_loss = ml_loss + logs["kl_loss"]
        total_loss = ml_weight * ml_loss / batch
        returns, g = [], g0
        for t in reversed(range(rewards.shape[0])):
            g = g * cfg.gamma + rewards[t]
            returns.append(g)
        returns = torch.stack(returns[::-1])
        adv = (returns - value).detach()
        critic = 0.5 * (((returns - value) ** 2) * rl_masks).sum()
        rl_loss = ((-logp_a * adv * rl_masks).sum() + critic
                   + (-ent_weight * ent * rl_masks).sum())
        total = rl_masks.sum()
        if cfg.normalize_loss == "total":
            rl_loss = rl_loss / self._allsum(total).clamp(min=1.0)
        elif cfg.normalize_loss == "batch":
            rl_loss = rl_loss / batch
        total_loss = total_loss + rl_weight * rl_loss
        logs.update(forth_loss=forth_loss, entropy=ent.sum(),
                    ml_loss=ml_loss, rl_loss=rl_weight * rl_loss,
                    critic_loss=rl_weight * critic, total=total,
                    loss=total_loss)
        return total_loss, logs

    def _step_outs(self, logit, value, sobs, action, active, aux,
                   pm_target, real, n_rows: int):
        """One step's outs: the cross-entropy with the teacher on active
        rows, the log-probability of the taken action (STOP for any slot
        past the candidates), the entropy, the value and the auxiliary
        terms (:func:`aux_terms`, with ``real`` and ``n_rows``)."""
        masked = logit.float().masked_fill(sobs["logit_mask"], NEG_INF)
        logp = torch.log_softmax(masked, dim=-1)
        ce = -logp.gather(1, sobs["teacher"][:, None])[:, 0]
        ce = torch.where(active, ce, torch.zeros_like(ce))
        a_rec = torch.minimum(action, sobs["cand_n"])
        logp_a = logp.gather(1, a_rec[:, None])[:, 0]
        outs = {"ce": ce, "logp_a": logp_a, "ent": _entropy(logp, logp.exp()),
                "value": value.float()}
        outs.update(aux_terms(self.cfg, aux, logp, sobs, active, pm_target,
                              real, n_rows))
        return outs

    def _replay_loss(self, instr, valid, seq_len, stacked, final_sobs,
                     rewards, rl_masks, final_ended, gen, env_noise,
                     ml_weight: float, rl_weight: float, ent_weight: float,
                     pm_target: Optional[torch.Tensor] = None):
        """The replay body (seq2seq.py:399-593) over a recorded episode:
        the percepts of ALL steps and of the A2C bootstrap run as ONE
        ((T+1) * B)-row batch (every LSTM on its plain path, as the JAX
        replay passes no ``lstm_pallas``; the gumbel gate out of test),
        then the decoder steps through the recorded observations and
        actions.  ``gen`` is a generator or the host rollout's
        :class:`PassStreams`; ``pm_target`` (B,) the episode-start
        progress, needed by the progress-monitor terms.  Under ``remat``
        the batched percept is recomputed in the backward
        (:meth:`_recompute`).  Returns (loss, logs)."""
        cfg, policy = self.cfg, self.policy
        if pm_target is None and (cfg.pred_pm
                                  or cfg.agent_type == "advanced"):
            raise ValueError("the progress-monitor loss needs pm_target")
        n_steps, batch = rewards.shape
        n_rows = batch * self._n_shards()
        real = None
        if cfg.pred_pm or cfg.agent_type == "advanced":
            # the steps on which a row of the whole batch is active (the
            # progress-monitor terms count no other)
            real = (self._allsum(stacked["active"].sum(1)) > 0).float()
        rep = n_steps + 1
        streams = (gen if isinstance(gen, PassStreams)
                   else PassStreams(self.device, gen=gen))
        cached = policy.encode_text(instr, valid, seq_len,
                                    deterministic=False, gen=streams.text)
        flat = {key: torch.cat([stacked[key], final_sobs[key][None]]).flatten(
            0, 1) for key in REC_KEYS}

        def percept_all(g):
            return policy.percept_step(
                {key: val.repeat(rep, *[1] * (val.dim() - 1))
                 for key, val in cached.items()},
                valid.repeat(rep, 1), seq_len.repeat(rep),
                make_step_inputs(cfg, self.tables, flat), lstm_kernel=False,
                deterministic=False, is_test=False, env_noise=env_noise,
                gen=g)

        percepts = checkpointed(percept_all, streams.steps(rep, 0),
                                self._recompute("replay", n_steps))

        def percept_at(t):
            def part(x):
                return None if x is None else x.unflatten(0, (rep, batch))[t]
            out = {key: part(val) for key, val in percepts.items()
                   if key != "inputs"}
            out["inputs"] = StepInputs(*(part(x) for x in percepts["inputs"]))
            return out

        width = decoder_state_width(cfg)
        zeros = torch.zeros(batch, width, dtype=self.dtype,
                            device=self.device)
        state = DecoderState(zeros, zeros, zeros)
        dropfeat = env_noise is not None
        outs = []
        for t in range(n_steps):
            sobs = {key: val[t] for key, val in stacked.items()}
            state, logit, value, aux = policy.decode_from_percept(
                percept_at(t), valid, state, sobs["is_first"],
                deterministic=False, already_dropfeat=dropfeat,
                gen=streams.at(t, 1))
            outs.append(self._step_outs(logit, value, sobs, sobs["action"],
                                        sobs["active"], aux, pm_target,
                                        None if real is None else real[t],
                                        n_rows))
        _, _, last_value, _ = policy.decode_from_percept(
            percept_at(n_steps), valid, state, final_sobs["is_first"],
            deterministic=False, already_dropfeat=dropfeat,
            gen=streams.at(n_steps, 1))
        last_value = last_value.detach().float()
        g0 = torch.where(final_ended, torch.zeros_like(last_value),
                         last_value)
        return self._finish_loss(n_rows, outs, rewards, rl_masks, g0,
                                 ml_weight, rl_weight, ent_weight)

    def _fused_loss(self, feedback: str, dev: DeviceEnvTables, ep, instr,
                    valid, seq_len, gen, env_noise, ml_weight: float,
                    rl_weight: float, ent_weight: float,
                    record: Optional[dict] = None):
        """The sampled / argmax pass (seq2seq.py:765-1204, one pass wide):
        per step the policy forward (the encoder's LSTMs, here and in the
        per-episode text encode, through their kernels unless
        ``use_pallas="never"``; the gumbel gate out of test), the
        action, the env transition and
        the reward, until every row has ended (the JAX program's
        all-ended cond, :1013-1017: the remaining steps add nothing); then
        the bootstrap value at the final state and the reversed A2C pass.
        ``record``, when given, receives the episode in the replay's form
        (tests replay it).  Under ``remat`` the per-step percept or the
        whole step is recomputed in the backward (:meth:`_recompute`).
        Returns (loss, logs)."""
        cfg, policy = self.cfg, self.policy
        arrays = dev.arrays()
        k = cfg.max_candidates
        batch = instr.shape[0]
        n_rows = batch * self._n_shards()
        # every step that runs has an active row (the loop stops once all
        # have ended), so the progress-monitor terms always count
        real = torch.ones((), device=self.device)
        cached = policy.encode_text(instr, valid, seq_len, self._lstm_kernel,
                                    deterministic=False, gen=gen)
        goal, start = ep["goal"], ep["start"]
        goal_local = goal - arrays[8][goal]
        total_dist = arrays[6][ep["node0"], goal_local]
        width = decoder_state_width(cfg)
        zeros = torch.zeros(batch, width, dtype=self.dtype,
                            device=self.device)
        carry = (ep["node0"], ep["view0"],
                 torch.zeros_like(ep["node0"], dtype=torch.bool),
                 DecoderState(zeros, zeros, zeros))
        dropfeat = env_noise is not None
        remat_percept = self._recompute("percept", cfg.max_action)
        remat_step = self._recompute("step", cfg.max_action)
        pm_target = start_progress(dev, ep)

        def policy_forward(g, sobs, state):
            inputs = make_step_inputs(cfg, self.tables, sobs)
            percept = checkpointed(
                lambda gp: policy.percept_step(
                    cached, valid, seq_len, inputs,
                    lstm_kernel=self._lstm_kernel, deterministic=False,
                    is_test=False, env_noise=env_noise, gen=gp),
                g, remat_percept)
            return policy.decode_from_percept(
                percept, valid, state, sobs["is_first"],
                deterministic=False, already_dropfeat=dropfeat, gen=g)

        def observe(node, view, first: bool):
            sobs = device_obs(arrays, node, view, goal, start, total_dist, k)
            sobs["is_first"] = torch.full_like(node, first, dtype=torch.bool)
            return sobs

        def step(g, node, view, ended, state, *, t):
            sobs = observe(node, view, t == 0)
            state, logit, value, aux = policy_forward(g, sobs, state)
            masked = logit.detach().float().masked_fill(sobs["logit_mask"],
                                                        NEG_INF)
            if feedback == "sample":
                action = torch.multinomial(torch.softmax(masked, dim=-1), 1,
                                           generator=g)[:, 0]
            elif feedback == "argmax":
                action = masked.argmax(dim=-1)
            else:
                raise ValueError(feedback)
            outs = self._step_outs(logit, value, sobs, action, ~ended, aux,
                                   pm_target, real, n_rows)
            outs["rl_mask"] = (~ended).float()
            node, view, ended, outs["reward"] = _env_and_reward(
                arrays, sobs, node, view, action, ended, goal_local)
            return sobs, action, outs, (node, view, ended, state)

        outs, recs = [], []
        for t in range(cfg.max_action):
            if self._all_ended(carry[2]):
                break
            sobs, action, out, carry = checkpointed(
                functools.partial(step, t=t), gen, remat_step, *carry)
            if record is not None:
                recs.append(_record(sobs, out["rl_mask"] == 0, t == 0,
                                    torch.minimum(action, sobs["cand_n"])))
            outs.append(out)
        node, view, ended, state = carry
        rewards = torch.stack([o.pop("reward") for o in outs])
        masks = torch.stack([o.pop("rl_mask") for o in outs])
        sobs = observe(node, view, False)
        g0 = torch.zeros(batch, device=self.device)
        if not bool(ended.all()):
            # A2C bootstrap at t = T (seq2seq.py:1144-1153); its value is
            # a constant of the loss
            with torch.no_grad():
                _, _, last_value, _ = policy_forward(gen, sobs, state)
            g0 = torch.where(ended, g0, last_value.float())
        if record is not None:
            record.update(stacked=_stack(recs), rewards=rewards,
                          rl_masks=masks, final_ended=ended,
                          pm_target=pm_target,
                          final_sobs=_record(sobs, ended, False,
                                             torch.zeros_like(node)))
        loss, logs = self._finish_loss(n_rows, outs, rewards, masks, g0,
                                       ml_weight, rl_weight, ent_weight)
        logs["env_steps"] = masks.sum().long()
        return loss, logs

    def device_rollout(self, train_ml: Optional[float] = None,
                       train_rl: bool = True,
                       feedback: Optional[str] = None,
                       env_noise: Optional[torch.Tensor] = None,
                       record: Optional[dict] = None,
                       speaker=None) -> None:
        """One training episode batch on the device (seq2seq.py:1537):
        the teacher pass or the sampled / argmax pass, whose gradients
        autograd adds to the parameters' ``.grad``.  Fetches nothing from
        the device.  ``speaker`` relabels the batch first (selfTrain
        back-translation, agent_dg.py:656-675).  ``env_noise`` replaces
        the drawn env-drop noise; ``record`` receives a sampled / argmax
        episode (both for tests)."""
        feedback = feedback or self.cfg.feedback
        train_rl = train_rl and feedback == "sample"
        dev, ep, instr, valid, seq_len, gen, noise = \
            self._device_rollout_args(env_noise, speaker)
        weights = (train_ml if train_ml is not None else 0.0,
                   1.0 if train_rl else 0.0,
                   0.01 if (train_rl and feedback == "sample") else 0.0)
        with self._cast_params_once():
            if feedback == "teacher":
                stacked, final, rewards, masks, ended = \
                    self._teacher_trajectory(dev, ep, self._teacher_len())
                loss, logs = self._replay_loss(
                    instr, valid, seq_len, stacked, final, rewards, masks,
                    ended, gen, noise, *weights,
                    pm_target=start_progress(dev, ep))
                logs["env_steps"] = stacked["active"].sum()
            else:
                loss, logs = self._fused_loss(
                    feedback, dev, ep, instr, valid, seq_len, gen, noise,
                    *weights, record=record)
                if record is not None:
                    record.update(instr=instr, valid=valid, seq_len=seq_len)
            loss.backward()
        logs = self._reduce_logs(logs)
        self._env_steps_log.append(logs.pop("env_steps"))
        for key, val in logs.items():
            self.logs[key].append(val.detach())
        self.losses.append(logs["loss"].detach())

    # ------------------------------------------------------------------
    # the host act/replay rollout (seq2seq.py:1661-1905)
    # ------------------------------------------------------------------
    @staticmethod
    def _to_sobs(obs, ended: np.ndarray, visited_mask,
                 is_first: bool) -> dict:
        """A host observation as the replay records it (seq2seq.py:1661):
        the logit mask hides the slots past STOP and, under ``submit``,
        the candidates already visited; ``action`` is filled in later."""
        k = obs.cand_point_id.shape[1]
        logit_mask = np.arange(k)[None, :] > obs.cand_n[:, None]
        if visited_mask is not None:
            logit_mask = logit_mask | visited_mask
        b = obs.batch_size()
        return {
            "feat_row": obs.feat_row, "view_index": obs.view_index,
            "heading": obs.heading, "elevation": obs.elevation,
            "cand_point_id": obs.cand_point_id,
            "cand_heading": obs.cand_heading,
            "cand_elevation": obs.cand_elevation, "cand_n": obs.cand_n,
            "teacher": obs.teacher, "back_teacher": obs.back_teacher,
            "logit_mask": logit_mask, "active": ~ended,
            "is_first": np.full(b, is_first, bool),
            "action": np.zeros(b, np.int64),
        }

    def _host_streams(self) -> PassStreams:
        """The next host rollout's streams, seeded from (seed, rollout
        counter) as :meth:`_rollout_generator` seeds a device pass."""
        streams = PassStreams(self.device,
                              self._seed * 1_000_003 + self._rollout_counter)
        self._rollout_counter += 1
        return streams

    @torch.no_grad()
    def _act_step(self, cached, valid, seq_len, state: DecoderState,
                  sobs: dict, feedback: str, training: bool, noise,
                  streams: PassStreams, t: int):
        """One act step of the host rollout (``_act_fn``,
        seq2seq.py:341-382): the percept and the decoder step, with step
        ``t``'s dropout streams when training (the gumbel gate out of test
        then) and every LSTM on its plain path, as the replay takes it;
        then the masked argmax or a sample from stream 2.  Returns (state,
        action)."""
        cfg, policy = self.cfg, self.policy
        percept = policy.percept_step(
            cached, valid, seq_len, make_step_inputs(cfg, self.tables, sobs),
            lstm_kernel=False, deterministic=not training,
            is_test=not training, env_noise=noise,
            gen=streams.at(t, 0) if training else None)
        state, logit, _value, _aux = policy.decode_from_percept(
            percept, valid, state, sobs["is_first"],
            deterministic=not training, already_dropfeat=noise is not None,
            gen=streams.at(t, 1) if training else None)
        masked = logit.float().masked_fill(sobs["logit_mask"], NEG_INF)
        if feedback == "argmax":
            action = masked.argmax(dim=-1)
        elif feedback == "sample":
            action = torch.multinomial(torch.softmax(masked, dim=-1), 1,
                                       generator=streams.at(t, 2))[:, 0]
        else:
            raise ValueError(feedback)
        return state, action

    def rollout(self, train_ml: Optional[float] = None,
                train_rl: bool = True, reset: bool = True, speaker=None,
                feedback: Optional[str] = None, defer_grad: bool = False,
                env_noise: Optional[torch.Tensor] = None) -> List[dict]:
        """One episode batch on the host env (seq2seq.py:1685-1847,
        agent_dg.py:633-1033): act steps until every row has stopped (the
        teacher needs no policy), recording each step.  With ``train_ml``
        or ``train_rl`` the recorded episode, padded to 8 steps or to
        ``max_action`` (padding exists only once every row has ended, so
        it is inert), is replayed for the IL + A2C loss whose gradients
        autograd adds to ``.grad``; ``defer_grad`` queues the replay for
        :meth:`flush_replays`.  ``speaker`` relabels the batch first;
        ``env_noise`` replaces the drawn env-drop noise (for tests).
        Records every trajectory in ``results``; returns them.  Under data
        parallel every rank steps the same host env; each runs the policy
        on its rows, the ranks' actions are gathered every step, and each
        replays its rows."""
        cfg = self.cfg
        feedback = feedback or cfg.feedback
        # teacher / argmax feedback never trains RL (agent_dg.py:643-644)
        train_rl = train_rl and feedback == "sample"
        training = train_ml is not None or train_rl
        env = self.env
        obs = env.reset() if reset else env._get_obs()
        batch = obs.batch_size()
        rows = self._rows(batch)
        streams = self._host_streams()
        # the reference draws the env-drop mask through an nn.Dropout: all
        # ones at evaluation (agent_dg.py:657, 677)
        noise = None
        if (training and cfg.consistent_drop) or speaker is not None:
            noise = (self._noise_fn(streams.at(-1, 0)) if env_noise is None
                     else env_noise.to(self.device, self.dtype))
        if speaker is not None:
            obs = speaker.relabel_batch(env, noise)
        if self._dp is not None and self._dp.n_data > 1:
            streams = PassStreams(self.device,
                                  rank_seed(streams.seed, self._dp))
        # the progress monitor's target: the episode-start progress
        pm_target = obs.progress.astype(np.float32).copy()
        instr = self._put(obs.instr[rows]).long()
        valid = self._put(~obs.pad_mask[rows])
        seq_len = self._put(obs.seq_len[rows]).long()
        cached = None
        if feedback != "teacher":
            with torch.no_grad():
                cached = self.policy.encode_text(
                    instr, valid, seq_len, deterministic=not training,
                    gen=streams.text if training else None)
        trajs = [[t] for t in env.state_tuples()]
        instr_ids = env.instr_ids()
        ended = np.zeros(batch, bool)
        last_dist = obs.distance.copy()
        # node-index visited sets; the current node joins before masking
        # (agent_dg.py:836-841)
        visited = [set() for _ in range(batch)] if cfg.submit else None
        zeros = torch.zeros(instr.shape[0], decoder_state_width(cfg),
                            dtype=self.dtype, device=self.device)
        state = DecoderState(zeros, zeros, zeros)
        records, rewards, rl_masks = [], [], []
        for t in range(cfg.max_action):
            visited_mask = None
            if visited is not None:
                nodes = env.current_nodes()
                visited_mask = np.zeros_like(obs.cand_point_id, bool)
                for i in range(batch):
                    visited[i].add(int(nodes[i]))
                    visited_mask[i] = np.isin(obs.cand_nbr_ix[i],
                                              list(visited[i]))
            sobs = self._to_sobs(obs, ended, visited_mask, t == 0)
            if feedback == "teacher":
                a = sobs["teacher"]
            else:
                state, action = self._act_step(
                    cached, valid, seq_len, state,
                    self._put_sobs({k: v[rows] for k, v in sobs.items()}),
                    feedback, training, noise, streams, t)
                if self._dp is not None:
                    action = self._dp.all_gather(action)
                a = action.cpu().numpy()
            # STOP (slot cand_n and past) or an ended row: env action -1
            a_env = np.where((a >= obs.cand_n) | ended, -1, a)
            sobs["action"] = np.minimum(a, obs.cand_n).astype(np.int64)
            records.append(sobs)
            obs = env.step(a_env, trajs)
            dist = obs.distance
            rewards.append(np.where(
                ended, 0.0, np.where(a_env == -1,
                                     np.where(dist < 3.0, 2.0, -2.0),
                                     np.sign(last_dist - dist))
            ).astype(np.float32))
            rl_masks.append((~ended).astype(np.float32))
            last_dist = dist.copy()
            self.total_env_steps += int((~ended).sum())
            ended = ended | (a_env == -1)
            if ended.all():
                break
        for iid, tr in zip(instr_ids, trajs):
            self.results[iid] = {"instr_id": iid, "trajectory": tr}
        if training:
            bucket = min(8, cfg.max_action)
            n_steps = bucket if len(records) <= bucket else cfg.max_action
            while len(records) < n_steps:
                pad = {k: v.copy() for k, v in records[-1].items()}
                pad["active"] = np.zeros_like(pad["active"])
                pad["is_first"] = np.zeros_like(pad["is_first"])
                records.append(pad)
                rewards.append(np.zeros(batch, np.float32))
                rl_masks.append(np.zeros(batch, np.float32))
            # this rank's rows of the recorded episode
            replay = {
                "instr": instr, "valid": valid, "seq_len": seq_len,
                "stacked": {k: np.stack([r[k][rows] for r in records])
                            for k in records[0]},
                "final_sobs": {k: v[rows] for k, v in self._to_sobs(
                    obs, ended, None, False).items()},
                "rewards": np.stack(rewards)[:, rows],
                "rl_masks": np.stack(rl_masks)[:, rows],
                "final_ended": ended[rows], "pm_target": pm_target[rows],
                "streams": streams, "noise": noise,
                "weights": (train_ml if train_ml is not None else 0.0,
                            1.0 if train_rl else 0.0,
                            0.01 if train_rl else 0.0)}
            if defer_grad:
                self._pending_replays.append(replay)
            else:
                self._run_replays([replay])
        return [{"instr_id": iid, "path": tr}
                for iid, tr in zip(instr_ids, trajs)]

    def _run_replays(self, replays: List[dict]) -> None:
        """Each recorded episode's IL + A2C loss and its backward
        (seq2seq.py:1854-1905), one after another: the JAX agent's fusing
        of two replays of one length into one vmapped program is a
        code-generation choice, and the summed gradients are the same."""
        for rep in replays:
            pm_target = rep.get("pm_target")
            with self._cast_params_once():
                loss, logs = self._replay_loss(
                    rep["instr"], rep["valid"], rep["seq_len"],
                    self._put_sobs(rep["stacked"]),
                    self._put_sobs(rep["final_sobs"]),
                    self._put(rep["rewards"]), self._put(rep["rl_masks"]),
                    self._put(rep["final_ended"]), rep["streams"],
                    rep["noise"], *rep["weights"],
                    pm_target=(None if pm_target is None
                               else self._put(pm_target)))
                loss.backward()
            logs = self._reduce_logs(logs)
            for key, val in logs.items():
                self.logs[key].append(val.detach())
            self.losses.append(logs["loss"].detach())

    def flush_replays(self) -> None:
        """Run the replays ``rollout(defer_grad=True)`` queued."""
        if self._pending_replays:
            pending, self._pending_replays = self._pending_replays, []
            self._run_replays(pending)

    # ------------------------------------------------------------------
    # the training loop (seq2seq.py:1907-2021)
    # ------------------------------------------------------------------
    def env_steps_total(self) -> int:
        """(episode, step) pairs processed: the host counter (evaluation,
        host rollouts) plus the device rollouts' counts (seq2seq.py:1565;
        fetches them)."""
        return self.total_env_steps + sum(int(x) for x in
                                          self._env_steps_log)

    def zero_grad(self) -> None:
        self.policy.zero_grad(set_to_none=True)
        self._pending_replays = []
        self.losses = []

    def accumulate_gradient(self, feedback: str = "teacher",
                            ml_weight: Optional[float] = None,
                            speaker=None) -> None:
        """The two-pass accumulation (seq2seq.py:1912, agent_dg.py:
        1347-1384): a teacher pass at ``teacher_weight``, or a teacher-ML
        pass at ``ml_weight`` (default ``cfg.ml_weight``; the aug
        alternation passes the org / aug weights) followed by a sampled
        A2C pass; under stream, one streamed window instead of the pair
        (seq2seq.py:1936-1944).  The passes run on the device, or as host
        rollouts where the device paths do not serve: ``device_rollout=
        "never"``, ``submit``, and selfTrain under stream, whose slots
        refill mid-window (seq2seq.py:1924-1932).  A ``speaker`` relabels
        each pass's batch first (selfTrain); its decode records no graph,
        so the speaker's parameters get no gradient.  ``fuse_passes="auto"``
        runs the same split pair (see the module docstring)."""
        cfg = self.cfg
        if ml_weight is None:
            ml_weight = cfg.ml_weight
        if feedback not in ("teacher", "sample"):
            raise ValueError(feedback)
        if not self.use_device_rollout() or (
                speaker is not None and self.use_stream_rollout()):
            run = self.rollout
        elif feedback == "sample" and self.use_stream_rollout():
            self.device_rollout_stream(ml_weight, feedback="sample")
            return
        else:
            run = self.device_rollout
        if feedback == "teacher":
            run(train_ml=cfg.teacher_weight, train_rl=False,
                feedback="teacher", speaker=speaker)
        else:
            run(train_ml=ml_weight, train_rl=False, feedback="teacher",
                speaker=speaker)
            run(train_ml=None, train_rl=True, feedback="sample",
                speaker=speaker)

    def optim_step(self) -> None:
        """Run the queued replays, apply the accumulated gradients
        (seq2seq.py:1981; under data parallel summed over the ranks
        first), then clear them; a no-op when nothing was accumulated."""
        self.flush_replays()
        if all(p.grad is None for p in self.policy.parameters()):
            return
        if self._dp is not None:
            self._dp.all_reduce_grads(self.policy.parameters())
        self.optimizer.step()
        self.policy.zero_grad(set_to_none=True)

    def train(self, n_iters: int, feedback: str = "teacher") -> None:
        """``n_iters`` optimizer iterations (seq2seq.py:1990): zero_grad,
        the teacher pass (and, under ``sample``, the sampled A2C pass after
        a teacher-ML pass at ``ml_weight`` unless it is 0; under stream,
        one streamed window), optim_step.  The passes are device passes
        or host rollouts as :meth:`accumulate_gradient` says."""
        for _ in range(n_iters):
            self.zero_grad()
            if feedback == "teacher":
                self.accumulate_gradient("teacher")
            elif feedback == "sample" and self.use_stream_rollout():
                self.device_rollout_stream(self.cfg.ml_weight,
                                           feedback="sample")
            elif feedback == "sample":
                run = (self.device_rollout if self.use_device_rollout()
                       else self.rollout)
                if self.cfg.ml_weight != 0:
                    run(train_ml=self.cfg.ml_weight, train_rl=False,
                        feedback="teacher")
                run(train_ml=None, train_rl=True, feedback="sample")
            else:
                raise ValueError(feedback)
            self.optim_step()

    # ------------------------------------------------------------------
    def save(self, epoch: int, path: str) -> None:
        """Per-component checkpoint in the reference's format
        (agent_dg.py:1466-1487): {component: {"epoch", "state_dict",
        "optimizer"}} under the r2r_src parameter names, plus the
        schedule's iteration.  Rank 0 writes (seq2seq.py:2184); under data
        parallel every rank waits for the file."""
        if self.mesh is not None and self.mesh.rank != 0:
            self.mesh.barrier()
            return
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        opts = self.optimizer.optimizers
        blob = {name: {"epoch": epoch, "state_dict": module.state_dict(),
                       "optimizer": opts[name if name in COMPONENTS
                                         else "other"].state_dict(),
                       "iteration": self.optimizer.iteration}
                for name, module in self.policy.named_children()}
        torch.save(blob, path)
        if self.mesh is not None:
            self.mesh.barrier()

    def load(self, path: str) -> int:
        """Mismatch-tolerant load (seq2seq.py:2209, agent_dg.py:1489-1510):
        each parameter whose name and shape match the checkpoint is
        restored; the others keep their values, with a NOTICE.  Reads the
        port's own files and the reference's r2r_src listener files (torch
        files of per-component dicts; the reference names the AdaIN
        component ``adaIn``), and the JAX package's: its msgpack
        ``{"epoch", "params", "opt_state"}`` and the round-1 pickle of flax
        bytes.  With ``load_optim`` the optimizer states come back too: a
        torch file's as saved, a JAX file's optax state through
        :meth:`ComponentOptimizer.restore_optax` (a NOTICE says when
        there is none, or it does not fit).  Under data parallel the
        weights are then broadcast from rank 0.  Returns the checkpoint's
        epoch."""
        fmt = flax_msgpack.file_format(path)
        if fmt == "torch":
            blob = torch.load(path, map_location=self.device)
            blob = {REFERENCE_COMPONENTS.get(name, name): entry
                    for name, entry in blob.items()}
            saved = {f"{name}.{key}": val for name, entry in blob.items()
                     for key, val in entry["state_dict"].items()}
            epoch = next(iter(blob.values()))["epoch"]
        else:
            if fmt == "msgpack":
                with open(path, "rb") as f:
                    blob = flax_msgpack.msgpack_restore(f.read())
                params = blob["params"]
            else:  # the round-1 pickle: {"epoch", "params": flax bytes, ..}
                blob = flax_msgpack.load_plain_pickle(path)
                params = flax_msgpack.msgpack_restore(blob["params"])
            saved = {k: torch.as_tensor(v) for k, v in
                     policy_state_dict_from_jax(params).items()}
            epoch = blob["epoch"]
        merged, skipped = {}, []
        for key, val in self.policy.state_dict().items():
            cand = saved.get(key)
            if cand is not None and cand.shape == val.shape:
                merged[key] = cand
            else:
                merged[key] = val
                skipped.append(key)
        unused = [key for key in saved if key not in merged]
        if skipped or unused:
            print("NOTICE: DIFFERENT KEYS IN THE LISTENER "
                  f"(kept init for {len(skipped)}: {skipped[:5]}...; "
                  f"ignored {len(unused)} checkpoint-only keys)", flush=True)
        self.policy.load_state_dict(merged)
        if self.cfg.load_optim:
            try:
                if fmt == "torch":
                    for name, opt in self.optimizer.optimizers.items():
                        opt.load_state_dict(blob[name]["optimizer"])
                        self.optimizer.iteration = blob[name]["iteration"]
                else:
                    opt_state = blob.get("opt_state")
                    if opt_state is None:
                        raise KeyError("the file holds no opt_state")
                    if isinstance(opt_state, bytes):  # round-1 pickle
                        opt_state = flax_msgpack.msgpack_restore(opt_state)
                    self.optimizer.restore_optax(opt_state,
                                                 policy_state_dict_from_jax)
            except (KeyError, ValueError) as e:  # component drift: fresh
                print(f"NOTICE: optimizer state not restored ({e})",
                      flush=True)
        if self.mesh is not None:
            self.mesh.replicate_module(self.policy)
        return int(epoch)
