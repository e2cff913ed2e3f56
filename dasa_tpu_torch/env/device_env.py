"""Device-resident environment tables: the R2R graph walk as gathers.

Counterpart of ``dasa_tpu/env/device_env.py``.  The navigation state of an
episode is (node index, view index); a step to candidate slot ``a`` is two
table lookups.  ``DeviceEnvTables.build`` flattens every per-scan quantity
the host env derives (candidate geometry, shortest-path distances, first
hops, feature rows) into globally indexed tensors on the device, so the
argmax evaluation loop steps every episode of a batch with gathers and
never asks the host env mid-episode.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from dasa_tpu_torch.env.r2r_env import R2REnv
from dasa_tpu_torch.sim.engine import compute_pano_candidates
from dasa_tpu_torch.utils.angles import (
    ELEVATION_INC,
    HEADING_COUNT,
    HEADING_INC,
)

TWO_PI = 2.0 * np.pi


@dataclass
class DeviceEnvTables:
    """Globally indexed (over all scans) device tensors.  K is the
    candidate capacity excluding the STOP slot (max_candidates - 1)."""

    feat_row: torch.Tensor        # (N,) int64 feature-table row
    cand_n: torch.Tensor          # (N,) int64, capped at K
    cand_nbr: torch.Tensor        # (N, K) int64 GLOBAL node ix (0 pad)
    cand_point: torch.Tensor      # (N, K) int64 view index of candidate
    cand_heading: torch.Tensor    # (N, K) f32 absolute target heading
    cand_elevation: torch.Tensor  # (N, K) f32 absolute target elevation
    dist: torch.Tensor            # (N, M) f32 geodesic to local node
    next_hop: torch.Tensor        # (N, M) int64 GLOBAL first hop (-1)
    node_base: torch.Tensor       # (N,) int64 scan base offset of node
    base: Dict[str, int]          # scan -> global base offset

    @staticmethod
    def build(env: R2REnv, max_candidates: int,
              device="cpu") -> "DeviceEnvTables":
        k = max_candidates - 1  # keep a slot for STOP (r2r_env.py:335)
        base: Dict[str, int] = {}
        n_total = 0
        m_max = 1
        for scan in env.scans:
            base[scan] = n_total
            g = env.graphs[scan]
            n_total += g.num_nodes
            m_max = max(m_max, g.num_nodes)

        feat_row = np.zeros(n_total, np.int64)
        cand_n = np.zeros(n_total, np.int64)
        cand_nbr = np.zeros((n_total, k), np.int64)
        cand_point = np.zeros((n_total, k), np.int64)
        cand_heading = np.zeros((n_total, k), np.float32)
        cand_elev = np.zeros((n_total, k), np.float32)
        dist = np.full((n_total, m_max), np.inf, np.float32)
        next_hop = np.full((n_total, m_max), -1, np.int64)
        node_base = np.zeros(n_total, np.int64)

        for scan in env.scans:
            g = env.graphs[scan]
            g.compute_shortest_paths()
            b = base[scan]
            n = g.num_nodes
            node_base[b:b + n] = b
            dist[b:b + n, :n] = np.where(
                np.isfinite(g.dist), g.dist, np.inf).astype(np.float32)
            nh = g.next_hop
            next_hop[b:b + n, :n] = np.where(nh >= 0, nh + b, -1)
            for i in np.nonzero(g.included)[0]:
                gi = b + int(i)
                feat_row[gi] = env.feature_db.row(scan, g.ids[int(i)])
                cands = compute_pano_candidates(g, int(i))
                n_c = min(len(cands.nbr_ix), k)
                cand_n[gi] = n_c
                cand_nbr[gi, :n_c] = cands.nbr_ix[:n_c] + b
                cand_point[gi, :n_c] = cands.point_id[:n_c]
                cand_heading[gi, :n_c] = cands.normalized_heading[:n_c]
                cand_elev[gi, :n_c] = cands.elevation[:n_c]

        def put(x):
            return torch.as_tensor(x, device=device)

        return DeviceEnvTables(
            feat_row=put(feat_row), cand_n=put(cand_n),
            cand_nbr=put(cand_nbr), cand_point=put(cand_point),
            cand_heading=put(cand_heading), cand_elevation=put(cand_elev),
            dist=put(dist), next_hop=put(next_hop),
            node_base=put(node_base), base=base)

    def arrays(self):
        """The tensor leaves, in the JAX package's order (base excluded)."""
        return (self.feat_row, self.cand_n, self.cand_nbr, self.cand_point,
                self.cand_heading, self.cand_elevation, self.dist,
                self.next_hop, self.node_base)


def episode_inputs(env: R2REnv, tables: DeviceEnvTables
                   ) -> Dict[str, np.ndarray]:
    """Per-episode rollout inputs from the env's current minibatch (host
    numpy only; call after env.reset())."""
    batch: List[dict] = env.batch
    b = len(batch)
    node0 = np.zeros(b, np.int64)
    goal = np.zeros(b, np.int64)
    view0 = np.zeros(b, np.int64)
    for i, item in enumerate(batch):
        scan = item["scan"]
        g = env.graphs[scan]
        bofs = tables.base[scan]
        node0[i] = bofs + g.id2ix[item["path"][0]]
        goal[i] = bofs + g.id2ix[item["path"][-1]]
        # discretized initial heading, elevation 0 (engine.py:371-380)
        hs = int(np.floor((item["heading"] % TWO_PI) / HEADING_INC + 0.5))
        if hs == HEADING_COUNT:
            hs = 0
        view0[i] = hs + HEADING_COUNT
    return {"node0": node0, "view0": view0, "goal": goal,
            "start": node0.copy()}


def device_obs(tables_arrays, node, view, goal, start, total_dist,
               k_slots: int) -> Dict[str, torch.Tensor]:
    """One observation dict from the (node, view) state, all gathers (the
    device analog of R2REnv._python_fill_obs, r2r_env.py:309-350).
    ``node``, ``goal``, ``start`` are GLOBAL int64 (B,); k_slots =
    max_candidates."""
    (feat_row_t, cand_n_t, cand_nbr_t, cand_point_t, cand_heading_t,
     cand_elev_t, dist_t, next_hop_t, node_base_t) = tables_arrays
    k = k_slots
    kc = cand_nbr_t.shape[1]
    n = cand_n_t[node]                                       # (B,)
    slots_c = torch.arange(kc, device=node.device)[None, :]  # (1, kc)
    real = slots_c < n[:, None]                              # (B, kc)
    base_heading = (view % HEADING_COUNT).float() * HEADING_INC

    def pad_to_k(x):
        return torch.nn.functional.pad(x, (0, k - kc))

    zero_f = torch.zeros((), device=node.device)
    cand_point = pad_to_k(torch.where(real, cand_point_t[node], 0))
    cand_heading = pad_to_k(torch.where(
        real, cand_heading_t[node] - base_heading[:, None], zero_f))
    cand_elev = pad_to_k(torch.where(real, cand_elev_t[node], zero_f))

    def teacher_to(target):
        """Candidate slot of the shortest-path hop toward ``target``
        (r2r_env.py:276-288): STOP (= n) at the target or when no hop or
        candidate matches."""
        local = target - node_base_t[target]
        nxt = next_hop_t[node, local]                        # (B,) global
        match = real & (cand_nbr_t[node] == nxt[:, None])    # (B, kc)
        slot = match.to(torch.int32).argmax(dim=1)
        found = match.any(dim=1)
        at_target = node == target
        return torch.where(at_target | (nxt < 0) | ~found, n, slot)

    goal_local = goal - node_base_t[goal]
    distance = dist_t[node, goal_local]
    slots_k = torch.arange(k, device=node.device)[None, :]
    return {
        "feat_row": feat_row_t[node],
        "view_index": view,
        "heading": base_heading,
        "elevation": ((view // HEADING_COUNT).float() - 1.0) * ELEVATION_INC,
        "cand_point_id": cand_point,
        "cand_heading": cand_heading,
        "cand_elevation": cand_elev,
        "cand_n": n,
        "teacher": teacher_to(goal),
        "back_teacher": teacher_to(start),
        "logit_mask": slots_k > n[:, None],
        "distance": distance,
        "progress": 1.0 - distance / (total_dist + 1e-10),
    }


def device_transition(tables_arrays, node, view, action, ended):
    """One env step on device (engine.py:391-407): move to candidate
    ``action`` and face the view it was seen from; ``action >= cand_n`` or
    an already-ended row is STOP.  Returns (new_node, new_view, stop)."""
    (_, cand_n_t, cand_nbr_t, cand_point_t, *_rest) = tables_arrays
    n = cand_n_t[node]
    stop = (action >= n) | ended
    a = action.clamp(0, cand_nbr_t.shape[1] - 1)[:, None]
    tgt = torch.gather(cand_nbr_t[node], 1, a)[:, 0]
    tgt_view = torch.gather(cand_point_t[node], 1, a)[:, 0]
    return (torch.where(stop, node, tgt), torch.where(stop, view, tgt_view),
            stop)
