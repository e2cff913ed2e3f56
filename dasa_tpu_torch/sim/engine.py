"""Graph-based navigation simulator.

A faithful re-implementation of the motion/graph semantics of the
reference C++ simulator (src/lib/MatterSim.cpp) minus rendering — the DASA
training stack always runs with rendering disabled and discretized angles
(r2r_src/env.py:60-67), consuming precomputed features instead of pixels.

Two layers:

- :class:`Simulator` — single-agent episodic state machine with the exact
  reference contract (newEpisode/makeAction/getState, 30-degree
  discretization, FOV-visibility navigable candidates sorted by angular
  distance; MatterSim.cpp:276-311, 339-367, 379-435, 470-508).
- :class:`BatchSim` — a batch of episodes with a *panoramic* step API and
  closed-form candidate extraction.  Instead of driving an auxiliary
  simulator through all 36 views per (scan, viewpoint) like the reference
  (r2r_src/env.py:240-315), candidates are computed vectorized over
  neighbors x views and cached per scan — the hot path is pure numpy.

The native C++ engine (``sim/native/dasasim.cpp`` through
``sim/csim.py``) computes the same geometry; ``env/r2r_env.py`` runs it
when it builds, and this numpy engine otherwise or on request.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dasa_tpu_torch.sim.graph import ScanGraph, load_scan_graph
from dasa_tpu_torch.utils.angles import (
    ELEVATION_INC,
    HEADING_COUNT,
    HEADING_INC,
    NUM_VIEWS,
)

TWO_PI = 2.0 * math.pi


@dataclass
class Viewpoint:
    """Navigable location candidate (MatterSim.hpp:28-41)."""

    viewpointId: str
    ix: int
    point: Tuple[float, float, float]
    rel_heading: float
    rel_elevation: float
    rel_distance: float


@dataclass
class SimState:
    """Agent state (MatterSim.hpp:54-76), sans rgb/depth images."""

    scanId: str = ""
    step: int = 0
    location: Optional[Viewpoint] = None
    heading: float = 0.0
    elevation: float = 0.0
    viewIndex: int = 0
    navigableLocations: List[Viewpoint] = field(default_factory=list)


def _wrap_pi(x):
    """Wrap angle(s) to (-pi, pi]."""
    return np.arctan2(np.sin(x), np.cos(x))


class Simulator:
    """Single-episode graph simulator with the reference's exact motion
    semantics.  Rendering APIs are accepted and ignored (no pixels)."""

    def __init__(self, connectivity_dir: str = "connectivity"):
        self.connectivity_dir = connectivity_dir
        self.width = 320
        self.height = 240
        self.vfov = 0.8
        self.min_elevation = -0.94
        self.max_elevation = 0.94
        self.discretize_views = False
        self.rendering_enabled = True
        self.initialized = False
        self.state = SimState()
        self.graph: Optional[ScanGraph] = None
        self._rng = random.Random()

    # -- configuration (MatterSim.hpp:110-160) --
    def setCameraResolution(self, width: int, height: int):
        self.width, self.height = width, height

    def setCameraVFOV(self, vfov: float):
        self.vfov = vfov

    def setRenderingEnabled(self, value: bool):
        self.rendering_enabled = value

    def setDiscretizedViewingAngles(self, value: bool):
        self.discretize_views = value

    def setNavGraphPath(self, path: str):
        self.connectivity_dir = path

    def setDatasetPath(self, path: str):
        pass  # dataset path only feeds the renderer

    def setSeed(self, seed: int):
        self._rng.seed(seed)

    def setElevationLimits(self, lo: float, hi: float) -> bool:
        if -math.pi / 2.0 < lo < 0.0 < hi < math.pi / 2.0:
            self.min_elevation, self.max_elevation = lo, hi
            return True
        return False

    def init(self):
        self.initialized = True

    def close(self):
        self.initialized = False

    # -- motion (MatterSim.cpp:339-377) --
    def _set_heading_elevation(self, heading: float, elevation: float):
        st = self.state
        heading = math.fmod(heading, TWO_PI)
        while heading < 0.0:
            heading += TWO_PI
        st.heading = heading
        if self.discretize_views:
            # lround-style snap (half away from zero; heading is >= 0 here)
            heading_step = int(math.floor(st.heading / HEADING_INC + 0.5))
            if heading_step == HEADING_COUNT:
                heading_step = 0
            st.heading = heading_step * HEADING_INC
            st.elevation = elevation
            if st.elevation < -ELEVATION_INC / 2.0:
                st.elevation = -ELEVATION_INC
                st.viewIndex = heading_step
            elif st.elevation > ELEVATION_INC / 2.0:
                st.elevation = ELEVATION_INC
                st.viewIndex = heading_step + 2 * HEADING_COUNT
            else:
                st.elevation = 0.0
                st.viewIndex = heading_step + HEADING_COUNT
        else:
            st.elevation = max(min(elevation, self.max_elevation),
                               self.min_elevation)

    def _populate_navigable(self):
        """FOV-visibility candidates sorted by angular distance
        (MatterSim.cpp:276-311)."""
        g = self.graph
        st = self.state
        ix = st.location.ix
        cur = Viewpoint(st.location.viewpointId, ix, st.location.point, 0.0, 0.0, 0.0)
        st.location = cur
        nav = [cur]
        adj = g.unobstructed[ix]
        cos_half_hfov = math.cos(self.vfov * self.width / self.height / 2.0)
        target = g.pos - g.pos[ix]
        txy = target[:, :2]
        dist = np.linalg.norm(target, axis=1)
        bearing = np.arctan2(txy[:, 0], txy[:, 1])  # from +y, right positive
        rel_heading = _wrap_pi(bearing - st.heading)
        rel_elevation = (
            np.arctan2(target[:, 2], np.linalg.norm(txy, axis=1)) - st.elevation
        )
        visible = np.cos(rel_heading) >= cos_half_hfov
        ok = adj & g.included & visible
        ok[ix] = False
        for j in np.nonzero(ok)[0]:
            nav.append(
                Viewpoint(
                    g.ids[j],
                    int(j),
                    tuple(g.pos[j]),
                    float(rel_heading[j]),
                    float(rel_elevation[j]),
                    float(dist[j]),
                )
            )
        nav.sort(key=lambda v: math.sqrt(v.rel_heading ** 2 + v.rel_elevation ** 2))
        st.navigableLocations = nav

    # -- episodes (MatterSim.cpp:379-508) --
    def newEpisode(self, scanId: str, viewpointId: str = "",
                   heading: float = 0.0, elevation: float = 0.0):
        if not self.initialized:
            self.init()
        st = self.state
        st.step = 0
        st.scanId = scanId
        self.graph = load_scan_graph(scanId, self.connectivity_dir)
        self._set_heading_elevation(heading, elevation)
        g = self.graph
        if not viewpointId:
            start_ix = self._rng.randrange(g.num_nodes)
            ix = start_ix
            while not g.included[ix]:
                ix += 1
                if ix >= g.num_nodes:
                    ix = 0
                if ix == start_ix:
                    raise RuntimeError(f"scan {scanId} has no included viewpoints")
        else:
            if viewpointId not in g.id2ix:
                raise ValueError(f"unknown viewpointId {viewpointId} in {scanId}")
            ix = g.id2ix[viewpointId]
            if not g.included[ix]:
                raise ValueError(f"viewpointId {viewpointId} is excluded")
        st.location = Viewpoint(g.ids[ix], int(ix), tuple(g.pos[ix]), 0.0, 0.0, 0.0)
        self._populate_navigable()

    def getState(self) -> SimState:
        return self.state

    def makeAction(self, index: int, heading: float, elevation: float):
        st = self.state
        if not self.initialized or index < 0 or index >= len(st.navigableLocations):
            raise IndexError(f"invalid action index: {index}")
        dest = st.navigableLocations[index]
        st.location = Viewpoint(dest.viewpointId, dest.ix, dest.point, 0.0, 0.0, 0.0)
        st.step += 1
        if self.discretize_views:
            if heading > 0.0:
                heading = HEADING_INC
            elif heading < 0.0:
                heading = -HEADING_INC
            if elevation > 0.0:
                elevation = ELEVATION_INC
            elif elevation < 0.0:
                elevation = -ELEVATION_INC
        self._set_heading_elevation(st.heading + heading, st.elevation + elevation)
        self._populate_navigable()


# ---------------------------------------------------------------------------
# Panoramic candidates (closed-form 36-view sweep)
# ---------------------------------------------------------------------------


@dataclass
class PanoCandidates:
    """Per-viewpoint candidate set aggregated over the 36 discretized views.

    Equivalent to the reference's buffered adj_dict from make_candidate
    (env.py:240-315): each traversable neighbor is represented by the view
    from which it appears closest (in angular distance).
    """

    nbr_ix: np.ndarray              # (M,) int32 neighbor node index
    point_id: np.ndarray            # (M,) int32 best viewIndex
    normalized_heading: np.ndarray  # (M,) float32 absolute heading of target
    elevation: np.ndarray           # (M,) float32 absolute target elevation
    rel_distance: np.ndarray        # (M,) float32 metric distance
    ang_distance: np.ndarray        # (M,) float32 angular dist at best view


def compute_pano_candidates(graph: ScanGraph, ix: int,
                            vfov: float = math.radians(60.0),
                            width: int = 640, height: int = 480
                            ) -> PanoCandidates:
    """Closed-form equivalent of sweeping a simulator through the 36 views.

    For neighbor with absolute bearing b and absolute elevation angle e:
    at view v (heading h_v, elevation e_v), rel_heading = wrap(b - h_v) and
    rel_elevation = e - e_v; visible iff cos(rel_heading) >= cos(hfov/2)
    (MatterSim.cpp:276-311).  The best view minimizes
    sqrt(rel_heading^2 + rel_elevation^2) with ties to the lowest view
    index — the same winner as the reference's strict-improvement sweep
    over views 0..35 (env.py:250-288).
    """
    g = graph
    adj = g.nav_adjacency()[ix].copy()
    adj[ix] = False
    nbrs = np.nonzero(adj)[0].astype(np.int32)
    target = g.pos[nbrs] - g.pos[ix]
    txy_norm = np.linalg.norm(target[:, :2], axis=1)
    rel_distance = np.linalg.norm(target, axis=1)
    bearing = np.arctan2(target[:, 0], target[:, 1])          # (M,)
    elev_abs = np.arctan2(target[:, 2], txy_norm)             # (M,)

    view_h = (np.arange(NUM_VIEWS) % HEADING_COUNT) * HEADING_INC   # (36,)
    view_e = (np.arange(NUM_VIEWS) // HEADING_COUNT - 1) * ELEVATION_INC
    rel_h = _wrap_pi(bearing[:, None] - view_h[None, :])      # (M, 36)
    rel_e = elev_abs[:, None] - view_e[None, :]               # (M, 36)
    cos_half_hfov = math.cos(vfov * width / height / 2.0)
    visible = np.cos(rel_h) >= cos_half_hfov
    ang = np.sqrt(rel_h ** 2 + rel_e ** 2)
    ang = np.where(visible, ang, np.inf)
    best = np.argmin(ang, axis=1).astype(np.int32)            # (M,)
    m = np.arange(len(nbrs))
    best_rel_h = rel_h[m, best]
    normalized_heading = view_h[best] + best_rel_h
    return PanoCandidates(
        nbr_ix=nbrs,
        point_id=best,
        normalized_heading=normalized_heading.astype(np.float32),
        elevation=elev_abs.astype(np.float32),
        rel_distance=rel_distance.astype(np.float32),
        ang_distance=ang[m, best].astype(np.float32),
    )


def micro_trajectory(vp_id: str, src_view: int, trg_view: int,
                     traj: list) -> None:
    """Append the up/down/right micro-step visits between two discretized
    views at the same viewpoint (make_equiv_action's rotation dance,
    agent_dg.py:358-391) as (viewpointId, heading, elevation) tuples."""
    src_level, trg_level = src_view // 12, trg_view // 12
    cur = src_view
    while src_level < trg_level:    # tune up
        src_level += 1
        cur += 12
        traj.append((vp_id, (cur % 12) * HEADING_INC,
                     (cur // 12 - 1) * ELEVATION_INC))
    while src_level > trg_level:    # tune down
        src_level -= 1
        cur -= 12
        traj.append((vp_id, (cur % 12) * HEADING_INC,
                     (cur // 12 - 1) * ELEVATION_INC))
    while cur != trg_view:          # turn right
        cur = (cur // 12) * 12 + (cur + 1) % 12
        traj.append((vp_id, (cur % 12) * HEADING_INC,
                     (cur // 12 - 1) * ELEVATION_INC))


class _EpisodeState:
    __slots__ = ("scan", "graph", "ix", "view_index", "step")

    def __init__(self, scan: str, graph: ScanGraph, ix: int, view_index: int):
        self.scan = scan
        self.graph = graph
        self.ix = ix
        self.view_index = view_index
        self.step = 0

    @property
    def heading(self) -> float:
        return (self.view_index % HEADING_COUNT) * HEADING_INC

    @property
    def elevation(self) -> float:
        return (self.view_index // HEADING_COUNT - 1) * ELEVATION_INC


class BatchSim:
    """A batch of panoramic-action episodes over the navigation graphs.

    The action space per step is: choose a candidate (move there and face
    the view it was seen from) or STOP.  This collapses the reference's
    up/down/right/forward micro-step dance (agent_dg.py:358-391) into one
    host-side transition, while `trajectory` still records the equivalent
    micro-step visits so eval metrics match (eval.py:63-67 counts
    trajectory entries).
    """

    def __init__(self, batch_size: int, connectivity_dir: str,
                 seed: int = 10):
        self.batch_size = batch_size
        self.connectivity_dir = connectivity_dir
        self.states: List[Optional[_EpisodeState]] = [None] * batch_size
        self._cand_cache: Dict[Tuple[str, int], PanoCandidates] = {}
        self._rng = random.Random(seed)

    # -- episode management --
    def new_episodes(self, scans: Sequence[str], viewpoints: Sequence[str],
                     headings: Sequence[float]) -> None:
        for i, (scan, vp, heading) in enumerate(zip(scans, viewpoints, headings)):
            g = load_scan_graph(scan, self.connectivity_dir)
            ix = g.id2ix[vp]
            # discretized snap of the initial heading; initial elevation 0
            hs = int(math.floor((heading % TWO_PI) / HEADING_INC + 0.5))
            if hs == HEADING_COUNT:
                hs = 0
            self.states[i] = _EpisodeState(scan, g, ix, hs + HEADING_COUNT)

    def candidates(self, scan: str, ix: int) -> PanoCandidates:
        key = (scan, ix)
        out = self._cand_cache.get(key)
        if out is None:
            g = load_scan_graph(scan, self.connectivity_dir)
            out = compute_pano_candidates(g, ix)
            self._cand_cache[key] = out
        return out

    def step_candidate(self, i: int, cand_idx: int,
                       traj: Optional[list] = None) -> None:
        """Move episode i to its cand_idx-th candidate; face its pointId.

        Appends the equivalent micro-step visits (up/down turns, right
        turns, forward move) to traj as (viewpointId, heading, elevation)
        tuples, mirroring make_equiv_action (agent_dg.py:358-391)."""
        st = self.states[i]
        cands = self.candidates(st.scan, st.ix)
        trg_point = int(cands.point_id[cand_idx])
        src_point = st.view_index
        if traj is not None:
            micro_trajectory(st.graph.ids[st.ix], src_point, trg_point,
                             traj)
        st.ix = int(cands.nbr_ix[cand_idx])
        st.view_index = trg_point
        st.step += 1
        if traj is not None:
            traj.append((st.graph.ids[st.ix], st.heading, st.elevation))
