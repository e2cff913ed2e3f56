"""The system under test: ``dasa_tpu_torch``'s world, agent and the calls
the measured window drives, set up from the benchmark's inputs.

Everything of the port that the benchmark touches is here: the world
(the port's ``World`` with the feature stores given as row ids only: the
tables themselves are made on the device by ``data.feature_tables``),
the agent of ``train/trainer.py:make_agent`` with the benchmark's weights
loaded, the stream window's host state and counters, and the agent's
timed calls.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from dasa_tpu_torch.config import Config
from dasa_tpu_torch.data.datasets import expand_instructions
from dasa_tpu_torch.data.features import FeatureDB
from dasa_tpu_torch.train.trainer import World, make_agent
from dasa_tpu_torch.utils import Tokenizer, read_vocab
from dasa_tpu_torch.utils.misc import set_seed


class BenchWorld(World):
    """The port's World over one split of the benchmark's task, its
    feature stores holding the row ids and no values."""

    def __init__(self, cfg: Config, split: str, feature_ids: List[str],
                 ndh: bool):
        self.cfg = cfg
        self.ndh = ndh
        set_seed(cfg.seed)
        vocab = read_vocab(os.path.join(cfg.data_dir, "train_vocab.txt"))
        self.tok = Tokenizer(vocab, encoding_length=cfg.max_input)
        ids_only = np.zeros((len(feature_ids), 1, 1), np.float32)
        self.feature_db = FeatureDB(feature_ids, ids_only)
        self.depth_db = FeatureDB(feature_ids, ids_only)
        self.evaluators = {}
        items = expand_instructions(self._load(split), self.tok,
                                    cfg.max_input)
        self.envs = {split: self._make_env(items, split)}


def make_config(settings: dict, data_dir: str, conn_dir: str,
                seed: int) -> Config:
    return Config(**settings, data_dir=data_dir, connectivity_dir=conn_dir,
                  seed=seed, log_dir="", snap_dir="")


def build_agent(cfg: Config, world: BenchWorld, split: str, weights_fn,
                tables, device: str):
    """The agent of the split's env, its weights and feature tables the
    benchmark's."""
    agent = make_agent(cfg, world, env_name=split, device=device)
    shapes = {k: tuple(v.shape) for k, v in agent.policy.state_dict().items()}
    agent.policy.load_state_dict(weights_fn(shapes))
    agent.feat_table, agent.dfeat_table = tables
    return agent


def staged_ids(agent) -> List[List[tuple]]:
    """The (instr_id, uid) episodes the last window's fresh chunk held, a
    list a half (one rank)."""
    sent = agent._stream_host().inflight[-1][0]
    return [[(it["instr_id"], int(it["uid"])) for it in sent[h][0]]
            for h in (0, 1)]


def check_window(agent) -> None:
    """One optimizer iteration of ``Seq2SeqAgent.train(1, "sample")``
    under stream, the window keeping its slot-time records."""
    agent.zero_grad()
    agent.device_rollout_stream(agent.cfg.ml_weight, feedback="sample",
                                record=True)
    agent.optim_step()


def grad_norms_from_state(agent) -> Dict[str, float]:
    """Each parameter's first gradient as RMSprop took it, from its
    square average after one step (alpha 0.99); 0 where the optimizer
    holds no state for it."""
    out = {}
    opt = agent.optimizer
    for comp, inner in opt.optimizers.items():
        for p in opt.params[comp]:
            sq = inner.state.get(p, {}).get("square_avg")
            out[opt.names[p]] = (0.0 if sq is None else
                                 float(torch.sqrt(sq.float().sum() / 0.01)))
    return out


def trained_params(agent) -> Dict[str, torch.Tensor]:
    opt = agent.optimizer
    return {opt.names[p]: p for comp in opt.params for p in opt.params[comp]}


def records_of(agent) -> List[Dict[str, np.ndarray]]:
    st = agent._stream_host()
    out = [{k: v.cpu().numpy() for k, v in rec.items()}
           for rec in st.records]
    st.records.clear()
    return out


class WindowCounters:
    """The stream window's per-window counters (starved slot-steps, the
    episodes that ran: carried in alive or refilled), kept on the device
    as the window returns them."""

    def __init__(self, agent):
        self.starved: List[torch.Tensor] = []
        self.episodes: List[torch.Tensor] = []
        self.slot_steps = 0
        inner = agent._stream_window

        def counted(*args, **kwargs):
            loss, logs, carry = inner(*args, **kwargs)
            self.starved.append(logs["starved"])
            self.episodes.append(logs["n_eps"].sum())
            geom = args[2]
            self.slot_steps += geom.W * geom.S
            return loss, logs, carry

        agent._stream_window = counted

    def starved_total(self) -> Optional[int]:
        if not self.starved:
            return None
        return int(sum(int(x) for x in self.starved))

    def episodes_total(self) -> int:
        return int(sum(int(x) for x in self.episodes))


def agent_steps(agent, start: int) -> int:
    return int(sum(int(x) for x in agent._env_steps_log[start:]))
