"""Dense, fixed-shape observation batch.

The reference builds per-agent dicts with (36, 2176) float arrays and
variable-length candidate lists every step (r2r_src/env.py:317-410), then
re-tensorizes them on GPU (agent_dg.py:286-323).  Here an observation is a
small struct of padded numpy arrays; panorama/candidate *features* are
never materialized on host — models gather them on device from a resident
feature table using `feat_row` and `cand_point_id`.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np


@dataclass
class Obs:
    # language (constant within an episode)
    instr: np.ndarray         # (B, L) int32 token ids
    pad_mask: np.ndarray      # (B, L) bool, True at <PAD> positions
    seq_len: np.ndarray       # (B,) int32

    # agent state
    feat_row: np.ndarray      # (B,) int32 row into the feature table
    view_index: np.ndarray    # (B,) int32 in [0, 36)
    heading: np.ndarray       # (B,) float32 absolute heading (radians)
    elevation: np.ndarray     # (B,) float32 absolute elevation (radians)

    # candidates (fixed K slots; slot cand_n is STOP, beyond is padding)
    cand_point_id: np.ndarray  # (B, K) int32 view index of candidate
    cand_heading: np.ndarray   # (B, K) float32 heading rel. to base view
    cand_elevation: np.ndarray  # (B, K) float32 absolute target elevation
    cand_n: np.ndarray         # (B,) int32 number of real candidates
    cand_mask: np.ndarray      # (B, K) bool, True for usable slots
                               # (real candidates + the STOP slot)
    cand_nbr_ix: np.ndarray    # (B, K) int32 graph node index of each
                               # candidate (-1 at non-real slots); host-side
                               # bookkeeping (visited masking for --submit)

    # supervision / reward signals
    teacher: np.ndarray       # (B,) int32 candidate idx (cand_n => STOP)
    back_teacher: np.ndarray  # (B,) int32
    distance: np.ndarray      # (B,) float32 geodesic distance to goal
    progress: np.ndarray      # (B,) float32 1 - distance/total

    def batch_size(self) -> int:
        return self.instr.shape[0]

    def asdict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    def permute(self, perm) -> "Obs":
        return Obs(**{k: v[perm] for k, v in self.asdict().items()})
