"""Simple baseline agents: sanity oracles for the eval pipeline.

Counterpart of ``dasa_tpu/agents/simple.py`` (reference
tasks/R2R/agent.py:220-294: StopAgent, RandomAgent, ShortestAgent; and
eval_simple_agents, r2r_src/eval.py:130-143).  The Shortest agent is the
upper-bound oracle (SR = 1) and Stop the lower bound.  Host code only:
the agents step the host env and run no model.  The Random agent draws
from ``random.Random(seed)`` as the JAX package's does, so both walk the
same episodes.
"""

from __future__ import annotations

import random
from typing import Dict, List

import numpy as np

from dasa_tpu_torch.env import R2REnv


class BaseSimpleAgent:
    def __init__(self, env: R2REnv, episode_len: int = 20, seed: int = 0):
        self.env = env
        self.episode_len = episode_len
        self.results: Dict[str, dict] = {}
        self._rng = random.Random(seed)

    def _actions(self, obs, t: int) -> np.ndarray:
        raise NotImplementedError

    def rollout(self) -> None:
        env = self.env
        obs = env.reset()
        trajs = [[t] for t in env.state_tuples()]
        ended = np.zeros(obs.batch_size(), bool)
        for t in range(self.episode_len):
            actions = self._actions(obs, t)
            actions = np.where(ended, -1, actions)
            if (actions < 0).all():
                break
            obs = env.step(actions, trajs)
            ended |= actions < 0
        for iid, tr in zip(env.instr_ids(), trajs):
            self.results[iid] = {"instr_id": iid, "trajectory": tr}

    def test(self) -> List[dict]:
        self.results = {}
        self.env.reset_epoch()
        for _ in range(self.env.size() // self.env.batch_size + 2):
            self.rollout()
            if len(self.results) >= self.env.size():
                break
        return list(self.results.values())


class StopAgent(BaseSimpleAgent):
    """Never moves."""

    def _actions(self, obs, t):
        return np.full(obs.batch_size(), -1, np.int64)


class RandomAgent(BaseSimpleAgent):
    """Random candidate for ~5 steps then stop (mirrors the reference's
    heading-randomized 5-step walk)."""

    def _actions(self, obs, t):
        if t >= 5:
            return np.full(obs.batch_size(), -1, np.int64)
        out = np.empty(obs.batch_size(), np.int64)
        for i in range(obs.batch_size()):
            n = int(obs.cand_n[i])
            out[i] = self._rng.randrange(n) if n > 0 else -1
        return out


class ShortestAgent(BaseSimpleAgent):
    """Follows the shortest-path teacher — the SR=1 oracle."""

    def _actions(self, obs, t):
        return np.where(obs.teacher < obs.cand_n, obs.teacher, -1)


def eval_simple_agents(env: R2REnv, evaluator, episode_len: int = 20
                       ) -> Dict[str, dict]:
    """Score the three baselines (eval.py:130-143)."""
    out = {}
    for name, cls in (("Stop", StopAgent), ("Random", RandomAgent),
                      ("Shortest", ShortestAgent)):
        agent = cls(env, episode_len)
        results = agent.test()
        summary, _ = evaluator.score(results)
        out[name] = summary
    return out
