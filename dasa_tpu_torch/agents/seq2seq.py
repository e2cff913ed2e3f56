"""The navigation agent: argmax evaluation on the device.

Counterpart of the evaluation path of ``dasa_tpu/agents/seq2seq.py``
(``make_step_inputs`` :65, ``_device_eval_fn`` :2023,
``_device_test_batch`` :2092, ``test`` :2143; reference
r2r_src/agent_dg.py:58-100, 725-936).  Feature tables and env tables live
on the device; one eval batch runs its whole episode (policy, transitions)
as a Python loop over ``max_action`` steps with no host env in the loop,
then the host rebuilds the trajectories from the recorded (T, B) node,
view and action tensors.  Training, the host rollout and the streamed
eval come with later slices (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

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
from dasa_tpu_torch.models.layers import NEG_INF
from dasa_tpu_torch.models.policy import (
    DasaPolicy,
    DecoderState,
    StepInputs,
    decoder_state_width,
)
from dasa_tpu_torch.sim.engine import micro_trajectory
from dasa_tpu_torch.utils.angles import all_point_angle_feature
from dasa_tpu_torch.utils.device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    return StepInputs(act_feat, f_t, d_t, cand, cand_d, sobs["logit_mask"])


class Seq2SeqAgent:
    """Listener agent for the DASA dg path, argmax evaluation only.

    Runs on CUDA unless ``device`` names another device (the tests pass
    ``device="cpu"``).  Compute runs in ``cfg.compute_dtype`` on the card
    and in f32 on the CPU; parameters are f32, made from ``rng_seed``.
    ``cfg.use_pallas`` keeps the JAX package's meaning: ``auto`` routes
    only the top BiLSTM through its kernel, ``always`` also the AdaIN
    gate and the shift attention, ``never`` none."""

    def __init__(self, cfg: Config, env: Optional[R2REnv],
                 feature_db: FeatureDB,
                 depth_db: Optional[FeatureDB] = None, rng_seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.env = env
        self.device = resolve_device(device)
        dtype = _DTYPES[cfg.compute_dtype]
        if self.device.type == "cpu":
            dtype = torch.float32
        self.dtype = dtype
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed + rng_seed)
            policy = DasaPolicy(cfg, compute_dtype=dtype)
        self.policy = policy.to(self.device).eval()
        self._lstm_kernel = cfg.use_pallas != "never"

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

    @property
    def tables(self):
        return (self.feat_table, self.dfeat_table, self.angle_table)

    def load_jax_params(self, params) -> None:
        """Load the JAX package's param tree (nested dicts of arrays, with
        or without the top-level ``params`` key)."""
        from dasa_tpu_torch.utils.jax_params import policy_state_dict_from_jax

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
        if self.cfg.device_rollout == "never" or self.env is None:
            return False
        return not self.cfg.submit and getattr(self.env, "graphs",
                                               None) is not None

    def _put(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x)).to(self.device)

    def _batch_inputs(self):
        """Reset the env to its next minibatch; device inputs of it."""
        env = self.env
        env.reset()
        dev = self._device_env_tables()
        ep = {k: self._put(v) for k, v in episode_inputs(env, dev).items()}
        instr = self._put(env._static["instr"]).long()
        valid = self._put(~env._static["pad_mask"])
        seq_len = self._put(env._static["seq_len"]).long()
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
        cached = policy.encode_text(instr, valid, seq_len)
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
        """Evaluate one env minibatch on device and record results."""
        env = self.env
        dev, ep, instr, valid, seq_len = self._batch_inputs()
        recs = {k: v.cpu().numpy() for k, v in self._device_eval(
            dev, ep, instr, valid, seq_len).items()}
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
        """Loop device eval batches until the dataset wraps
        (BaseAgent.test, agent_dg.py:58-100).  Only the argmax,
        dropout-free, whole-split evaluation is ported."""
        if (feedback != "argmax" or use_dropout or iters is not None
                or not self.use_device_rollout()
                or self.cfg.rollout_mode == "stream"):
            raise NotImplementedError(
                "Seq2SeqAgent.test: only the argmax device evaluation of a "
                "whole split is ported (no dropout, iters, submit, host "
                "rollout or streamed eval; ROADMAP.md)")
        self.results = {}
        env = self.env
        env.reset_epoch(shuffle=False)
        for _ in range(env.size() // env.batch_size + 2):
            self._device_test_batch()
            if len(self.results) >= env.size():
                break
        return list(self.results.values())

    def get_results(self) -> List[dict]:
        """Reference API parity (BaseAgent.get_results)."""
        return list(self.results.values())
