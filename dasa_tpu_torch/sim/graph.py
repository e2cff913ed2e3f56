"""Navigation-graph world model.

Loads a Matterport connectivity JSON into dense numpy arrays and
precomputes all-pairs shortest paths (distances + first hop), replacing
both the reference's C++ per-scan Location graph (src/lib/MatterSim.cpp:
239-274) and its Python-side networkx Dijkstra passes (r2r_src/env.py:
182-198, r2r_src/utils.py:26-55).

Pose translation lives at row-major indices 3, 7, 11 of the flat 4x4 pose
(utils.py:29-33; MatterSim.cpp:256-260 extracts the same column).  Edge
weights are 3-D euclidean distances and the graph is undirected
(utils.py:44-49).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import dijkstra


@dataclass
class ScanGraph:
    scan_id: str
    ids: List[str]                  # viewpointId per node index
    pos: np.ndarray                 # (N, 3) float64 world positions
    included: np.ndarray            # (N,) bool
    unobstructed: np.ndarray        # (N, N) bool, raw JSON adjacency
    height: np.ndarray              # (N,) float64
    id2ix: Dict[str, int] = field(default_factory=dict)
    # shortest-path products over included-and-unobstructed edges
    dist: Optional[np.ndarray] = None      # (N, N) float64, inf if unreachable
    next_hop: Optional[np.ndarray] = None  # (N, N) int32, -1 if none/self

    def __post_init__(self):
        if not self.id2ix:
            self.id2ix = {vid: i for i, vid in enumerate(self.ids)}

    @property
    def num_nodes(self) -> int:
        return len(self.ids)

    def nav_adjacency(self) -> np.ndarray:
        """(N, N) bool: traversable edges (unobstructed & both included).
        Matches populateNavigable's neighbor filter (MatterSim.cpp:289)."""
        inc = self.included
        return self.unobstructed & inc[None, :] & inc[:, None]

    def edge_lengths(self) -> np.ndarray:
        diff = self.pos[:, None, :] - self.pos[None, :, :]
        return np.sqrt((diff * diff).sum(-1))

    def compute_shortest_paths(self) -> None:
        """All-pairs Dijkstra over euclidean-weighted traversable edges,
        plus the first-hop matrix used for O(1) teacher actions
        (replaces nx.all_pairs_dijkstra_path at env.py:193-198)."""
        if self.dist is not None:
            return
        n = self.num_nodes
        adj = self.nav_adjacency()
        w = np.where(adj, self.edge_lengths(), 0.0)
        graph = csr_matrix(w)
        dist, pred = dijkstra(graph, directed=False, return_predecessors=True)
        # next_hop[u, v]: first node after u on the shortest path u->v.
        # pred[u, v] is the node before v; propagate back until the row
        # stabilizes (iterations bounded by graph diameter).
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
        self.dist = dist
        self.next_hop = nh

    def shortest_path(self, src: int, dst: int) -> List[int]:
        """Node-index path src..dst inclusive."""
        self.compute_shortest_paths()
        if src == dst:
            return [src]
        path = [src]
        cur = src
        for _ in range(self.num_nodes):
            cur = int(self.next_hop[cur, dst])
            if cur < 0:
                raise ValueError(
                    f"no path {self.ids[src]} -> {self.ids[dst]} in {self.scan_id}"
                )
            path.append(cur)
            if cur == dst:
                return path
        raise RuntimeError("path reconstruction did not terminate")

    def distance(self, src: int, dst: int) -> float:
        self.compute_shortest_paths()
        return float(self.dist[src, dst])


_GRAPH_CACHE: Dict[str, ScanGraph] = {}


def load_scan_graph(scan_id: str, connectivity_dir: str,
                    cache: bool = True) -> ScanGraph:
    key = os.path.join(connectivity_dir, scan_id)
    if cache and key in _GRAPH_CACHE:
        return _GRAPH_CACHE[key]
    path = os.path.join(connectivity_dir, f"{scan_id}_connectivity.json")
    with open(path) as f:
        data = json.load(f)
    n = len(data)
    ids = [item["image_id"] for item in data]
    pos = np.empty((n, 3), dtype=np.float64)
    included = np.empty(n, dtype=bool)
    unobstructed = np.zeros((n, n), dtype=bool)
    height = np.zeros(n, dtype=np.float64)
    for i, item in enumerate(data):
        p = item["pose"]
        pos[i] = (p[3], p[7], p[11])
        included[i] = bool(item["included"])
        unobstructed[i] = np.asarray(item["unobstructed"], dtype=bool)
        height[i] = float(item.get("height", 0.0))
    g = ScanGraph(scan_id, ids, pos, included, unobstructed, height)
    if cache:
        _GRAPH_CACHE[key] = g
    return g


def clear_graph_cache() -> None:
    _GRAPH_CACHE.clear()
