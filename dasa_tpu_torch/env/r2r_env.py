"""R2R navigation environment with dense observations.

Replaces the reference's EnvBatch + R2RBatch (r2r_src/env.py:33-504).
Episodic control (graphs, shortest paths, candidate geometry, minibatch
iteration) stays on host; observations are fixed-shape numpy structs
whose feature content is gathered on device.  Candidate geometry per
(scan, viewpoint) is cached once — the reference proves this is sound
with its buffered_state_dict (env.py:291-297).

Two interchangeable backends drive the episodes, chosen as the JAX
package's env chooses (``dasa_tpu/env/r2r_env.py:70-95``):

- ``python``: :class:`dasa_tpu_torch.sim.engine.BatchSim` (numpy).
- ``native``: the C++ engine (``dasa_tpu_torch/sim/native/dasasim.cpp``,
  built at first use by ``sim/csim.py``) — graph loading, Dijkstra,
  candidate precompute, and the entire batched observation fill happen
  in one C call per step, replacing the reference's serial per-sim
  Python stepping (env.py:72-120).

``backend="auto"`` (the default) takes the native engine when it builds
and prints the reason when it falls back to python, where the JAX env
falls back quietly; ``backend="native"`` raises when the engine cannot
be built or loaded.  :attr:`R2REnv.backend` says which one runs.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dasa_tpu_torch.data.features import FeatureDB
from dasa_tpu_torch.env.obs import Obs
from dasa_tpu_torch.sim.engine import BatchSim, PanoCandidates, micro_trajectory
from dasa_tpu_torch.sim.graph import ScanGraph, load_scan_graph


class R2REnv:
    """Batched R2R task environment.

    Actions per step are candidate indices into the obs' K slots; the
    STOP action is index ``cand_n`` (or -1, both accepted).  Trajectories
    (with reference-equivalent micro-steps) are recorded into
    caller-owned lists for evaluation.
    """

    def __init__(
        self,
        feature_db: FeatureDB,
        data: List[dict],
        batch_size: int = 64,
        seed: int = 10,
        name: Optional[str] = None,
        connectivity_dir: str = "connectivity",
        max_candidates: int = 16,
        max_input: int = 80,
        depth_db: Optional[FeatureDB] = None,
        backend: str = "auto",
    ):
        self.feature_db = feature_db
        self.depth_db = depth_db
        featurized = feature_db.scans
        self.data = [d for d in data if d["scan"] in featurized]
        self.name = name or "env"
        self.batch_size = batch_size
        self.connectivity_dir = connectivity_dir
        self.max_candidates = max_candidates
        self.max_input = max_input
        self.scans = sorted({d["scan"] for d in self.data})

        self.graphs: Dict[str, ScanGraph] = {}
        for scan in self.scans:
            g = load_scan_graph(scan, connectivity_dir)
            self.graphs[scan] = g

        # backend selection
        self.native = None
        self._scan_handle: Dict[str, int] = {}
        if backend not in ("auto", "native", "python"):
            raise ValueError(f"sim backend {backend!r}")
        if backend in ("auto", "native"):
            try:
                from dasa_tpu_torch.sim.csim import NativeEngine

                self.native = NativeEngine(k_max=max_candidates)
                for scan in self.scans:
                    h = self.native.load_scan(scan, connectivity_dir)
                    self._scan_handle[scan] = h
                    g = self.graphs[scan]
                    rows = np.zeros(g.num_nodes, np.int32)
                    for i in np.nonzero(g.included)[0]:
                        key = f"{scan}_{g.ids[int(i)]}"
                        rows[i] = feature_db.id2row.get(key, 0)
                    self.native.set_feat_rows(h, rows)
            except (OSError, RuntimeError) as e:
                if backend == "native":
                    raise
                print(f"R2REnv {self.name}: the native sim engine is "
                      f"unavailable ({str(e).splitlines()[0]}); running the "
                      "python engine", flush=True)
                self.native = None
        if self.native is None:
            for g in self.graphs.values():
                g.compute_shortest_paths()
            self.sim = BatchSim(batch_size, connectivity_dir, seed=seed)
        else:
            self.sim = None

        self._rng = random.Random(seed)
        self._rng.shuffle(self.data)
        self.ix = 0
        self.batch: List[dict] = []
        self._goal_ix = np.zeros(batch_size, dtype=np.int64)
        self._start_ix = np.zeros(batch_size, dtype=np.int64)
        self._total_dist = np.zeros(batch_size, dtype=np.float64)
        # episode-static obs fields, cached at reset
        self._static: Optional[dict] = None
        self._last_obs: Optional[Obs] = None

    @property
    def backend(self) -> str:
        return "native" if self.native is not None else "python"

    def size(self) -> int:
        return len(self.data)

    # -- minibatch iteration (env.py:201-223) --
    def _next_minibatch(self, tile_one: bool = False,
                        batch_size: Optional[int] = None) -> None:
        if batch_size is None:
            batch_size = self.batch_size
        if tile_one:
            batch = [self.data[self.ix]] * batch_size
            self.ix += 1
            if self.ix >= len(self.data):
                self._rng.shuffle(self.data)
                self.ix -= len(self.data)
        else:
            batch = self.data[self.ix: self.ix + batch_size]
            if len(batch) < batch_size:
                self._rng.shuffle(self.data)
                self.ix = batch_size - len(batch)
                batch += self.data[: self.ix]
            else:
                self.ix += batch_size
        self.batch = batch

    def reset_epoch(self, shuffle: bool = False) -> None:
        if shuffle:
            self._rng.shuffle(self.data)
        self.ix = 0

    # -- episodes --
    def reset(self, batch: Optional[List[dict]] = None, inject: bool = False,
              random_start: bool = False, **kwargs) -> Obs:
        if batch is None:
            self._next_minibatch(**kwargs)
        elif inject:
            self._next_minibatch(**kwargs)
            self.batch[: len(batch)] = batch
        else:
            self.batch = batch
        b = len(self.batch)
        scans = [item["scan"] for item in self.batch]
        if random_start:
            starts = [self._rng.choice(item["path"]) for item in self.batch]
        else:
            starts = [item["path"][0] for item in self.batch]
        headings = np.array([item["heading"] for item in self.batch],
                            np.float64)
        start_ix = np.array(
            [self.graphs[s].id2ix[vp] for s, vp in zip(scans, starts)],
            np.int64)
        goal_ix = np.array(
            [self.graphs[s].id2ix[item["path"][-1]]
             for s, item in zip(scans, self.batch)], np.int64)
        path0_ix = np.array(
            [self.graphs[s].id2ix[item["path"][0]]
             for s, item in zip(scans, self.batch)], np.int64)
        self._goal_ix[:b] = goal_ix
        self._start_ix[:b] = path0_ix

        if self.native is not None:
            scan_h = np.array([self._scan_handle[s] for s in scans],
                              np.int32)
            self.native.reset(scan_h, start_ix.astype(np.int32),
                              path0_ix.astype(np.int32),
                              goal_ix.astype(np.int32), headings)
            for i in range(b):
                self._total_dist[i] = self.native.distance(
                    int(scan_h[i]), int(path0_ix[i]), int(goal_ix[i]))
        else:
            self.sim.new_episodes(scans, starts, headings)
            for i, item in enumerate(self.batch):
                g = self.graphs[item["scan"]]
                self._total_dist[i] = g.dist[path0_ix[i], goal_ix[i]]

        # episode-static language fields
        L = self.max_input
        instr = np.zeros((b, L), dtype=np.int32)
        seq_len = np.zeros(b, dtype=np.int32)
        for i, item in enumerate(self.batch):
            enc = np.asarray(item["instr_encoding"])
            n_tok = min(len(enc), L)
            instr[i, :n_tok] = enc[:n_tok]
            nz = np.nonzero(enc == 0)[0]
            seq_len[i] = int(nz[0]) if len(nz) else len(enc)
        self._static = {"instr": instr, "pad_mask": instr == 0,
                        "seq_len": seq_len}
        return self._get_obs()

    def step(self, actions: Sequence[int],
             trajs: Optional[List[list]] = None) -> Obs:
        """actions: candidate index per episode; -1 or >= cand_n = STOP."""
        if self.native is not None:
            obs = self._last_obs
            acts = np.asarray(actions, np.int32)
            acts = np.where(acts >= obs.cand_n, -1, acts)
            if trajs is not None:
                scan_h, node, view, _ = self.native.get_state()
                for i, a in enumerate(acts):
                    if a < 0:
                        continue
                    scan = self.batch[i]["scan"]
                    g = self.graphs[scan]
                    trg = int(obs.cand_point_id[i, a])
                    micro_trajectory(g.ids[int(node[i])], int(view[i]),
                                     trg, trajs[i])
                    trajs[i].append((
                        g.ids[int(obs.cand_nbr_ix[i, a])],
                        (trg % 12) * (np.pi / 6),
                        (trg // 12 - 1) * (np.pi / 6)))
            self.native.step(acts)
            return self._get_obs()
        for i, a in enumerate(actions):
            a = int(a)
            st = self.sim.states[i]
            n = len(self.sim.candidates(st.scan, st.ix).nbr_ix)
            if a < 0 or a >= n:
                continue
            self.sim.step_candidate(i, a, None if trajs is None else trajs[i])
        return self._get_obs()

    def teleport(self, i: int, viewpoint: str, view_index: int) -> Obs:
        """Move episode i to an arbitrary viewpoint/view (search
        expansion; the reference re-news episodes mid-search,
        agent_dg.py:1135-1140).  Returns refreshed obs."""
        scan = self.batch[i]["scan"]
        node = self.graphs[scan].id2ix[viewpoint]
        if self.native is not None:
            self.native.teleport(i, node, int(view_index))
        else:
            st = self.sim.states[i]
            st.ix = node
            st.view_index = int(view_index)
        return self._get_obs()

    # -- state access for the agent/evaluator --
    def state_tuples(self) -> List[Tuple[str, float, float]]:
        """(viewpointId, heading, elevation) per episode — the trajectory
        entry format of the submission JSON (eval.py:17)."""
        if self.native is not None:
            _, node, view, _ = self.native.get_state()
            out = []
            for i in range(len(self.batch)):
                g = self.graphs[self.batch[i]["scan"]]
                out.append((g.ids[int(node[i])],
                            (int(view[i]) % 12) * (np.pi / 6),
                            (int(view[i]) // 12 - 1) * (np.pi / 6)))
            return out
        return [(st.graph.ids[st.ix], st.heading, st.elevation)
                for st in self.sim.states]

    def current_viewpoints(self) -> List[str]:
        return [t[0] for t in self.state_tuples()]

    def current_nodes(self) -> np.ndarray:
        if self.native is not None:
            _, node, _, _ = self.native.get_state()
            return node
        return np.array([st.ix for st in self.sim.states[:len(self.batch)]])

    def instr_ids(self) -> List[str]:
        return [item["instr_id"] for item in self.batch]

    # -- observation assembly --
    def _teacher_cand_idx(self, i: int, cands: PanoCandidates,
                          goal_ix: int) -> int:
        """Candidate index of the shortest-path action; n_cand => STOP
        (env.py:232-238 + agent_dg.py:325-345 collapsed)."""
        st = self.sim.states[i]
        if st.ix == goal_ix:
            return len(cands.nbr_ix)
        nxt = st.graph.next_hop[st.ix, goal_ix]
        if nxt < 0:
            return len(cands.nbr_ix)
        k = np.nonzero(cands.nbr_ix == nxt)[0]
        assert len(k) == 1, "teacher next-hop must be a candidate"
        return int(k[0])

    def _get_obs(self) -> Obs:
        b = len(self.batch)
        k = self.max_candidates
        if self.native is not None:
            dyn = self.native.fill_obs(k)
        else:
            dyn = self._python_fill_obs(b, k)
        slots = np.arange(k)[None, :]
        cand_mask = slots <= dyn["cand_n"][:, None]
        obs = Obs(
            instr=self._static["instr"],
            pad_mask=self._static["pad_mask"],
            seq_len=self._static["seq_len"],
            cand_mask=cand_mask,
            **dyn,
        )
        self._last_obs = obs
        return obs

    def _python_fill_obs(self, b: int, k: int) -> dict:
        dyn = {
            "feat_row": np.zeros(b, np.int32),
            "view_index": np.zeros(b, np.int32),
            "heading": np.zeros(b, np.float32),
            "elevation": np.zeros(b, np.float32),
            "cand_point_id": np.zeros((b, k), np.int32),
            "cand_nbr_ix": np.full((b, k), -1, np.int32),
            "cand_heading": np.zeros((b, k), np.float32),
            "cand_elevation": np.zeros((b, k), np.float32),
            "cand_n": np.zeros(b, np.int32),
            "teacher": np.zeros(b, np.int32),
            "back_teacher": np.zeros(b, np.int32),
            "distance": np.zeros(b, np.float32),
            "progress": np.zeros(b, np.float32),
        }
        from dasa_tpu_torch.utils.angles import HEADING_COUNT, HEADING_INC

        for i, item in enumerate(self.batch):
            st = self.sim.states[i]
            vp = st.graph.ids[st.ix]
            dyn["feat_row"][i] = self.feature_db.row(st.scan, vp)
            dyn["view_index"][i] = st.view_index
            dyn["heading"][i] = st.heading
            dyn["elevation"][i] = st.elevation
            cands = self.sim.candidates(st.scan, st.ix)
            n = min(len(cands.nbr_ix), k - 1)  # keep a slot for STOP
            dyn["cand_n"][i] = n
            base_heading = (st.view_index % HEADING_COUNT) * HEADING_INC
            dyn["cand_point_id"][i, :n] = cands.point_id[:n]
            dyn["cand_nbr_ix"][i, :n] = cands.nbr_ix[:n]
            dyn["cand_heading"][i, :n] = (
                cands.normalized_heading[:n] - base_heading)
            dyn["cand_elevation"][i, :n] = cands.elevation[:n]
            dyn["teacher"][i] = min(self._teacher_cand_idx(
                i, cands, int(self._goal_ix[i])), n)
            dyn["back_teacher"][i] = min(self._teacher_cand_idx(
                i, cands, int(self._start_ix[i])), n)
            dyn["distance"][i] = st.graph.dist[st.ix, self._goal_ix[i]]
            dyn["progress"][i] = 1.0 - dyn["distance"][i] / (
                self._total_dist[i] + 1e-10)
        return dyn

    def get_statistics(self) -> dict:
        length = sum(len(d["instructions"].split()) for d in self.data)
        path = 0.0
        for d in self.data:
            g = self.graphs[d["scan"]]
            if g.dist is None:
                g.compute_shortest_paths()
            path += g.dist[g.id2ix[d["path"][0]], g.id2ix[d["path"][-1]]]
        n = max(1, len(self.data))
        return {"length": length / n, "path": path / n}
