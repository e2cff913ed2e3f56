"""Trajectory evaluation: NE / OSR / SR / SPL / steps / lengths.

Scoring contract from the reference (r2r_src/eval.py:17-125): success is
final geodesic error < 3 m; oracle rate uses the closest visited point;
SPL = success * shortest / max(shortest, taken, 0.01); trajectory steps
count every recorded entry (including rotation micro-steps).
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

from dasa_tpu_torch.sim.graph import ScanGraph, load_scan_graph

ERROR_MARGIN = 3.0


class Evaluation:
    """Results format: [{'instr_id': str,
    'trajectory': [(viewpoint_id, heading_rad, elevation_rad), ...]}]."""

    def __init__(self, data: List[dict],
                 connectivity_dir: str = "connectivity",
                 splits: Optional[Sequence[str]] = None):
        self.error_margin = ERROR_MARGIN
        self.splits = list(splits) if splits else []
        self.gt: Dict[str, dict] = {}
        self.instr_ids: set = set()
        scans = set()
        for item in data:
            self.gt[str(item["path_id"])] = item
            scans.add(item["scan"])
            n_instr = len(item["instructions"]) if isinstance(
                item["instructions"], list) else 3
            self.instr_ids.update(
                "%s_%d" % (item["path_id"], i) for i in range(n_instr))
        self.graphs: Dict[str, ScanGraph] = {}
        for scan in scans:
            g = load_scan_graph(scan, connectivity_dir)
            g.compute_shortest_paths()
            self.graphs[scan] = g

    def _dist(self, scan: str, a: str, b: str) -> float:
        g = self.graphs[scan]
        return float(g.dist[g.id2ix[a], g.id2ix[b]])

    def _get_nearest(self, scan: str, goal_id: str, path) -> str:
        near_id = path[0][0]
        near_d = self._dist(scan, near_id, goal_id)
        for item in path:
            d = self._dist(scan, item[0], goal_id)
            if d < near_d:
                near_id, near_d = item[0], d
        return near_id

    def _score_item(self, instr_id: str, path, scores) -> None:
        gt = self.gt[instr_id.split("_")[-2]]
        start, goal = gt["path"][0], gt["path"][-1]
        assert start == path[0][0], \
            "Result trajectories should include the start position"
        scan = gt["scan"]
        final_position = path[-1][0]
        nearest = self._get_nearest(scan, goal, path)
        scores["nav_errors"].append(self._dist(scan, final_position, goal))
        scores["oracle_errors"].append(self._dist(scan, nearest, goal))
        scores["trajectory_steps"].append(len(path) - 1)
        distance = 0.0
        prev = path[0]
        for curr in path[1:]:
            distance += self._dist(scan, prev[0], curr[0])
            prev = curr
        scores["trajectory_lengths"].append(distance)
        scores["shortest_lengths"].append(self._dist(scan, start, goal))

    def score(self, results: Union[str, Iterable[dict]],
              allow_partial: bool = False):
        if isinstance(results, str):
            with open(results) as f:
                results = json.load(f)
        scores = defaultdict(list)
        remaining = set(self.instr_ids)
        for item in results:
            if item["instr_id"] in remaining:
                remaining.remove(item["instr_id"])
                self._score_item(item["instr_id"], item["trajectory"], scores)
        if not allow_partial and "train" not in self.splits:
            assert len(remaining) == 0, (
                f"Missing {len(remaining)} of {len(self.instr_ids)} "
                f"instruction ids")
        nav_errors = np.array(scores["nav_errors"])
        oracle_errors = np.array(scores["oracle_errors"])
        summary = {
            "nav_error": float(np.average(nav_errors)),
            "oracle_error": float(np.average(oracle_errors)),
            "steps": float(np.average(scores["trajectory_steps"])),
            "lengths": float(np.average(scores["trajectory_lengths"])),
            "success_rate": float(np.mean(nav_errors < self.error_margin)),
            "oracle_rate": float(np.mean(oracle_errors < self.error_margin)),
        }
        spl = [
            float(error < self.error_margin) * l / max(l, p, 0.01)
            for error, p, l in zip(
                scores["nav_errors"], scores["trajectory_lengths"],
                scores["shortest_lengths"])
        ]
        summary["spl"] = float(np.average(spl))
        return summary, dict(scores)

    def bleu_score(self, path2inst: Dict, tokenizer) -> tuple:
        """Corpus BLEU of generated instructions vs the 3 references
        (eval.py:110-125)."""
        from dasa_tpu_torch.train.bleu import compute_bleu

        refs, candidates = [], []
        for path_id, inst in path2inst.items():
            path_id = str(path_id)
            assert path_id in self.gt
            refs.append([tokenizer.split_sentence(sent)
                         for sent in self.gt[path_id]["instructions"]])
            candidates.append([tokenizer.index_to_word[int(w)] for w in inst])
        bleu, precisions, *_ = compute_bleu(refs, candidates, smooth=False)
        return bleu, precisions
