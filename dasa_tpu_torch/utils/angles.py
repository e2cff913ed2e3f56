"""View discretization and angle features.

The reference discretizes the panorama into 36 views: 12 headings x 3
elevations at 30-degree increments, with viewIndex = heading_step +
12 * (elevation_step + 1) — [0..11] looking down, [12..23] horizon,
[24..35] looking up (reference: include/MatterSim.hpp:69-71,195-196;
src/lib/MatterSim.cpp:339-367).

Angle features are [sin h, cos h, sin e, cos e] tiled to angle_feat_size
(reference: r2r_src/utils.py:361-368).  The per-view-index table the
reference builds by driving a throwaway simulator through all 36 views
(utils.py:386-408) has the closed form implemented here: when sweeping,
state.heading = (ix % 12) * 30deg and state.elevation = (ix // 12 - 1) *
30deg, so the feature relative to a base view is
angle_feature((ix%12 - base%12) * 30deg, (ix//12 - 1) * 30deg).
"""

from __future__ import annotations

import math

import numpy as np

HEADING_COUNT = 12
ELEVATION_COUNT = 3
NUM_VIEWS = HEADING_COUNT * ELEVATION_COUNT  # 36
HEADING_INC = 2.0 * math.pi / HEADING_COUNT  # 30 degrees
ELEVATION_INC = math.pi / 6.0                # 30 degrees


def view_index(heading_step: int, elevation_step: int) -> int:
    """viewIndex from discrete (heading in [0,12), elevation in {-1,0,1})."""
    return heading_step + HEADING_COUNT * (elevation_step + 1)


def view_heading(ix) -> float:
    """Absolute heading (radians) of discretized view index."""
    return (np.asarray(ix) % HEADING_COUNT) * HEADING_INC


def view_elevation(ix) -> float:
    """Absolute elevation (radians) of discretized view index."""
    return (np.asarray(ix) // HEADING_COUNT - 1) * ELEVATION_INC


def angle_feature(heading, elevation, angle_feat_size: int = 4) -> np.ndarray:
    """[sin h, cos h, sin e, cos e] tiled to angle_feat_size.

    Accepts scalars or arrays; broadcasting over leading dims.
    Reference: r2r_src/utils.py:361-368.
    """
    heading = np.asarray(heading, dtype=np.float32)
    elevation = np.asarray(elevation, dtype=np.float32)
    reps = angle_feat_size // 4
    quad = np.stack(
        [np.sin(heading), np.cos(heading), np.sin(elevation), np.cos(elevation)],
        axis=-1,
    ).astype(np.float32)
    return np.tile(quad, reps)


def point_angle_feature(base_view_id: int = 0, angle_feat_size: int = 4) -> np.ndarray:
    """(36, angle_feat_size) table: feature of each view ix relative to
    base_view_id's heading.  Reference: r2r_src/utils.py:386-408."""
    ix = np.arange(NUM_VIEWS)
    base_heading = (base_view_id % HEADING_COUNT) * HEADING_INC
    heading = view_heading(ix) - base_heading
    elevation = view_elevation(ix)
    return angle_feature(heading, elevation, angle_feat_size)


def all_point_angle_feature(angle_feat_size: int = 4) -> np.ndarray:
    """(36, 36, angle_feat_size): table for every base view.
    Reference: r2r_src/utils.py:407-408."""
    return np.stack(
        [point_angle_feature(b, angle_feat_size) for b in range(NUM_VIEWS)], axis=0
    )


def view_rel_weight_table() -> np.ndarray:
    """(36, 36) angular-proximity weights W[target, view] = -4 * ||rel||
    used by the MT agent's soft-distance KL target (reference
    ViewHelper.get_target_rel_weight, r2r_src/utils.py:693-702; the
    abs-angle sweep at 676-691 equals the closed form above).

    Replicates the reference arithmetic EXACTLY, including its one-sided
    heading wraparound: rel = min(|abs - base|, |[0, 2pi] - (abs - base)|)
    per component, which wraps only positive heading differences (a
    negative difference beyond pi keeps its raw magnitude).  The table
    is a loss-shaping prior, so fidelity beats symmetry here.
    """
    ix = np.arange(NUM_VIEWS)
    abs_ang = np.stack([view_elevation(ix), view_heading(ix)],
                       axis=-1).astype(np.float64)         # (36, 2)
    diff = abs_ang[None, :, :] - abs_ang[:, None, :]       # (tgt, view, 2)
    round_point = np.array([0.0, 2.0 * math.pi])
    rel = np.minimum(np.abs(diff), np.abs(round_point - diff))
    return (-4.0 * np.sqrt((rel * rel).sum(-1))).astype(np.float32)
