"""The reference's navigation world: connectivity graphs, shortest paths,
panorama candidates, the episode's start state, the observation of a
(node, view) state, the step to a candidate, the step's features and the
instruction's tokens.

Worked out from the raw files the benchmark writes (the connectivity
JSON, the R2R-format items and the vocab) by a frozen copy of the port's
arithmetic (``sim/graph.py``, ``sim/engine.py:compute_pano_candidates``,
``env/device_env.py``, ``models/featurize.py``, ``utils/vocab.py``),
importing nothing of the port.
"""

from __future__ import annotations

import json
import math
import os
import re
import string
from typing import Dict, List, Sequence

import numpy as np
import torch
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import dijkstra

HEADING_COUNT = 12
NUM_VIEWS = 36
HEADING_INC = 2.0 * math.pi / HEADING_COUNT
ELEVATION_INC = math.pi / 6.0
TWO_PI = 2.0 * math.pi


class Graph:
    """One scan: positions, traversable edges, all-pairs distances and
    first hops."""

    def __init__(self, path: str):
        with open(path) as f:
            data = json.load(f)
        n = len(data)
        self.ids = [item["image_id"] for item in data]
        self.id2ix = {vid: i for i, vid in enumerate(self.ids)}
        self.pos = np.array([(d["pose"][3], d["pose"][7], d["pose"][11])
                             for d in data], np.float64)
        inc = np.array([bool(d["included"]) for d in data])
        unob = np.array([np.asarray(d["unobstructed"], bool) for d in data])
        self.adj = unob & inc[None, :] & inc[:, None]
        diff = self.pos[:, None, :] - self.pos[None, :, :]
        w = np.where(self.adj, np.sqrt((diff * diff).sum(-1)), 0.0)
        dist, pred = dijkstra(csr_matrix(w), directed=False,
                              return_predecessors=True)
        nh = np.full((n, n), -1, dtype=np.int32)
        rows = np.arange(n)
        direct = pred == rows[:, None]
        nh[direct] = np.nonzero(direct)[1]
        pred_c = np.where(pred < 0, 0, pred)
        reachable = np.isfinite(dist) & (pred >= 0)
        for _ in range(n):
            unresolved = (nh < 0) & reachable
            if not unresolved.any():
                break
            cand = np.take_along_axis(nh, pred_c, axis=1)
            nh = np.where(unresolved & (cand >= 0), cand, nh)
        self.dist, self.next_hop = dist, nh
        self.included = inc

    def candidates(self, ix: int):
        """(neighbour indices, best view, heading, elevation) of node ix's
        traversable neighbours: the view nearest each neighbour's bearing
        among those whose horizontal field of view holds it."""
        adj = self.adj[ix].copy()
        adj[ix] = False
        nbrs = np.nonzero(adj)[0].astype(np.int32)
        target = self.pos[nbrs] - self.pos[ix]
        txy = np.linalg.norm(target[:, :2], axis=1)
        bearing = np.arctan2(target[:, 0], target[:, 1])
        elev = np.arctan2(target[:, 2], txy)
        view_h = (np.arange(NUM_VIEWS) % HEADING_COUNT) * HEADING_INC
        view_e = (np.arange(NUM_VIEWS) // HEADING_COUNT - 1) * ELEVATION_INC
        x = bearing[:, None] - view_h[None, :]
        rel_h = np.arctan2(np.sin(x), np.cos(x))
        rel_e = elev[:, None] - view_e[None, :]
        visible = np.cos(rel_h) >= math.cos(math.radians(60.0) * 640 / 480
                                            / 2.0)
        ang = np.where(visible, np.sqrt(rel_h ** 2 + rel_e ** 2), np.inf)
        best = np.argmin(ang, axis=1).astype(np.int32)
        m = np.arange(len(nbrs))
        heading = (view_h[best] + rel_h[m, best]).astype(np.float32)
        return nbrs, best, heading, elev.astype(np.float32)


class Tables:
    """The world's per-node tables over all scans, globally indexed, on
    ``device``: feature row, candidates (capped at K = max_candidates - 1),
    distances and first hops."""

    def __init__(self, conn_dir: str, scans: Sequence[str],
                 feature_ids: Sequence[str], max_candidates: int, device):
        k = max_candidates - 1
        self.graphs = {s: Graph(os.path.join(conn_dir,
                                             f"{s}_connectivity.json"))
                       for s in scans}
        self.base: Dict[str, int] = {}
        total, m_max = 0, 1
        for s in scans:
            self.base[s] = total
            total += len(self.graphs[s].ids)
            m_max = max(m_max, len(self.graphs[s].ids))
        row_of = {fid: i for i, fid in enumerate(feature_ids)}
        feat_row = np.zeros(total, np.int64)
        cand_n = np.zeros(total, np.int64)
        cand_nbr = np.zeros((total, k), np.int64)
        cand_point = np.zeros((total, k), np.int64)
        cand_heading = np.zeros((total, k), np.float32)
        cand_elev = np.zeros((total, k), np.float32)
        dist = np.full((total, m_max), np.inf, np.float32)
        next_hop = np.full((total, m_max), -1, np.int64)
        node_base = np.zeros(total, np.int64)
        for s in scans:
            g, b = self.graphs[s], self.base[s]
            n = len(g.ids)
            node_base[b:b + n] = b
            dist[b:b + n, :n] = np.where(np.isfinite(g.dist), g.dist,
                                         np.inf).astype(np.float32)
            next_hop[b:b + n, :n] = np.where(g.next_hop >= 0,
                                             g.next_hop + b, -1)
            for i in np.nonzero(g.included)[0]:
                gi = b + int(i)
                feat_row[gi] = row_of[f"{s}_{g.ids[int(i)]}"]
                nbrs, point, heading, elev = g.candidates(int(i))
                nc = min(len(nbrs), k)
                cand_n[gi] = nc
                cand_nbr[gi, :nc] = nbrs[:nc] + b
                cand_point[gi, :nc] = point[:nc]
                cand_heading[gi, :nc] = heading[:nc]
                cand_elev[gi, :nc] = elev[:nc]

        def put(x):
            return torch.as_tensor(x, device=device)

        self.feat_row, self.cand_n = put(feat_row), put(cand_n)
        self.cand_nbr, self.cand_point = put(cand_nbr), put(cand_point)
        self.cand_heading, self.cand_elev = put(cand_heading), put(cand_elev)
        self.dist, self.next_hop = put(dist), put(next_hop)
        self.node_base = put(node_base)
        self.k_slots = max_candidates

    def start_state(self, item: dict):
        """(start node, start view, goal node) of an R2R item."""
        g, b = self.graphs[item["scan"]], self.base[item["scan"]]
        hs = int(np.floor((item["heading"] % TWO_PI) / HEADING_INC + 0.5))
        if hs == HEADING_COUNT:
            hs = 0
        return (b + g.id2ix[item["path"][0]], hs + HEADING_COUNT,
                b + g.id2ix[item["path"][-1]])

    def obs(self, node, view, goal):
        """The observation of (node, view) toward ``goal``: candidates,
        the teacher's slot (STOP = the candidate count) and the
        distance."""
        k = self.k_slots
        kc = self.cand_nbr.shape[1]
        n = self.cand_n[node]
        real = torch.arange(kc, device=node.device)[None, :] < n[:, None]
        base_heading = (view % HEADING_COUNT).float() * HEADING_INC
        pad = (0, k - kc)
        zero = torch.zeros((), device=node.device)
        cand_point = torch.nn.functional.pad(
            torch.where(real, self.cand_point[node], 0), pad)
        cand_heading = torch.nn.functional.pad(torch.where(
            real, self.cand_heading[node] - base_heading[:, None], zero), pad)
        cand_elev = torch.nn.functional.pad(
            torch.where(real, self.cand_elev[node], zero), pad)
        goal_local = goal - self.node_base[goal]
        nxt = self.next_hop[node, goal_local]
        match = real & (self.cand_nbr[node] == nxt[:, None])
        slot = match.to(torch.int32).argmax(dim=1)
        teacher = torch.where((node == goal) | (nxt < 0) | ~match.any(1), n,
                              slot)
        slots_k = torch.arange(k, device=node.device)[None, :]
        return {"feat_row": self.feat_row[node], "view": view,
                "heading": base_heading,
                "elevation": ((view // HEADING_COUNT).float() - 1.0)
                * ELEVATION_INC,
                "cand_point": cand_point, "cand_heading": cand_heading,
                "cand_elev": cand_elev, "cand_n": n, "teacher": teacher,
                "logit_mask": slots_k > n[:, None],
                "distance": self.dist[node, goal_local]}

    def step(self, node, view, action, ended):
        """Move to candidate ``action`` facing the view it was seen from;
        ``action >= cand_n`` or an ended row stays (STOP)."""
        n = self.cand_n[node]
        stop = (action >= n) | ended
        a = action.clamp(0, self.cand_nbr.shape[1] - 1)[:, None]
        tgt = torch.gather(self.cand_nbr[node], 1, a)[:, 0]
        tgt_view = torch.gather(self.cand_point[node], 1, a)[:, 0]
        return (torch.where(stop, node, tgt),
                torch.where(stop, view, tgt_view), stop)

    def goal_dist(self, node, goal):
        return self.dist[node, goal - self.node_base[goal]]


def angle_feature(heading, elevation, size: int):
    quad = torch.stack([torch.sin(heading), torch.cos(heading),
                        torch.sin(elevation), torch.cos(elevation)], dim=-1)
    return quad.repeat(*((1,) * (quad.dim() - 1)), size // 4)


def all_point_angles(size: int, device) -> torch.Tensor:
    """(36 base views, 36 views, size): each view's angle feature
    relative to the base view's heading."""
    ix = np.arange(NUM_VIEWS)
    out = []
    for b in range(NUM_VIEWS):
        heading = (ix % HEADING_COUNT) * HEADING_INC \
            - (b % HEADING_COUNT) * HEADING_INC
        elev = (ix // HEADING_COUNT - 1) * ELEVATION_INC
        h = np.asarray(heading, np.float32)
        e = np.asarray(elev, np.float32)
        quad = np.stack([np.sin(h), np.cos(h), np.sin(e), np.cos(e)],
                        -1).astype(np.float32)
        out.append(np.tile(quad, size // 4))
    return torch.as_tensor(np.stack(out), device=device)


def step_features(feat, dfeat, angles, obs, angle_size: int):
    """(action angle feature, rgb pano, depth pano, candidates, depth
    candidates) of an observation; candidate slots past cand_n are 0."""
    def pano(table):
        vis = table[obs["feat_row"]].float()
        return torch.cat([vis, angles[obs["view"]]], -1)

    def cands(table):
        p = table[obs["feat_row"]].float()
        idx = obs["cand_point"][..., None].expand(-1, -1, p.shape[-1])
        vis = torch.gather(p, 1, idx)
        ang = angle_feature(obs["cand_heading"], obs["cand_elev"],
                            angle_size)
        k = obs["cand_point"].shape[1]
        real = torch.arange(k, device=vis.device)[None, :] \
            < obs["cand_n"][:, None]
        return torch.cat([vis, ang], -1) * real[..., None].float()

    act = angle_feature(obs["heading"], obs["elevation"], angle_size)
    return act, pano(feat), pano(dfeat), cands(feat), cands(dfeat)


_SPLIT = re.compile(r"(\W+)")


def tokenize(sentence: str, vocab: List[str], max_length: int):
    """<BOS> words <EOS>, padded with <PAD> (index 0) or cut to
    max_length with <EOS> last; words outside the vocab are <UNK>."""
    index = {w: i for i, w in enumerate(vocab)}
    index.setdefault("<BOS>", len(vocab))
    toks = []
    for word in [s.strip().lower() for s in _SPLIT.split(sentence.strip())
                 if s.strip()]:
        if all(c in string.punctuation for c in word) and not all(
                c == "." for c in word):
            toks += list(word)
        else:
            toks.append(word)
    enc = [index["<BOS>"]] + [index.get(w, index["<UNK>"]) for w in toks] \
        + [index["<EOS>"]]
    if len(enc) < max_length:
        enc += [index["<PAD>"]] * (max_length - len(enc))
    elif len(enc) > max_length:
        enc[max_length - 1] = index["<EOS>"]
    return np.array(enc[:max_length], np.int64)
