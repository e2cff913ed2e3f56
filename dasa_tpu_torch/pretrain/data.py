"""Pretraining data: shortest-path step records + BERT-style masking.

A copy of ``dasa_tpu/pretrain/data.py`` with its import rewritten to the
port's env.

Replaces the reference's offline pretrain-data generator
(r2r_src/generate_pretrain_data.py:20-49 walks teacher paths in a
no-render sim emitting target_{split}.json step records) and the
NavDataset masking pipeline (tasks/R2R/batch_loader.py:271-301: 15%
masking with the 80/10/10 mask/random/keep split, first and last tokens
never masked).

Divergence from the reference, on purpose: unmasked positions get label
-1 and the CE ignore-index is -1.  The reference writes label 0 for
unmasked positions but ignores only -1 (batch_loader.py:280-300 +
r2rpretrain_class.py:117), silently training every unmasked position
toward token id 0.
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, List, Optional

import numpy as np

from dasa_tpu_torch.env import R2REnv


def generate_pretrain_records(env: R2REnv,
                              max_steps: Optional[int] = None
                              ) -> List[dict]:
    """Walk every item's teacher path, emitting one record per step:
    {instr_encoding, feat_row, view_index, action (target viewIndex in
    [0, 36)), progress}."""
    records: List[dict] = []
    max_steps = max_steps or 16
    n_batches = -(-env.size() // env.batch_size)
    seen = set()
    env.reset_epoch()
    for _ in range(n_batches + 1):
        obs = env.reset()
        keep = [iid not in seen for iid in env.instr_ids()]
        seen.update(env.instr_ids())
        ended = np.zeros(obs.batch_size(), bool)
        for _t in range(max_steps):
            teacher = np.where(obs.teacher >= obs.cand_n, -1, obs.teacher)
            rows = np.arange(obs.batch_size())
            tgt_view = np.where(
                teacher >= 0,
                obs.cand_point_id[rows, np.maximum(teacher, 0)],
                obs.view_index)  # at goal: keep looking where you are
            pending = {}
            for i in range(obs.batch_size()):
                if ended[i] or not keep[i]:
                    continue
                rec = {
                    "instr_encoding": obs.instr[i].copy(),
                    "seq_len": int(obs.seq_len[i]),
                    "feat_row": int(obs.feat_row[i]),
                    "view_index": int(obs.view_index[i]),
                    "action": int(tgt_view[i]),
                    "progress": float(obs.progress[i]),
                    # next-state placeholders, filled after stepping
                    # (isnext negative sampling — batch_loader.py:395-432
                    # records the NEXT step's pano for the NSP task; at
                    # the goal, "next" stays the current state like the
                    # reference's absViewIndex == -1 terminal case)
                    "next_feat_row": int(obs.feat_row[i]),
                    "next_view_index": int(obs.view_index[i]),
                }
                records.append(rec)
                pending[i] = rec
            step_actions = np.where(ended, -1, teacher)
            ended |= step_actions == -1
            if ended.all():
                break
            obs = env.step(step_actions)
            for i, rec in pending.items():
                if step_actions[i] >= 0:
                    rec["next_feat_row"] = int(obs.feat_row[i])
                    rec["next_view_index"] = int(obs.view_index[i])
        if len(seen) >= env.size():
            break
    return records


def mask_tokens(tokens: np.ndarray, seq_len: int, vocab_size: int,
                mask_index: int, rng: random.Random,
                mask_rate: float = 0.15):
    """BERT 80/10/10 masking over positions [1, seq_len-1); returns
    (masked_tokens, labels) with labels = -1 at unmasked positions."""
    tokens = tokens.copy()
    labels = np.full_like(tokens, -1)
    for i in range(1, max(1, seq_len - 1)):
        if rng.random() < mask_rate:
            labels[i] = tokens[i]
            p = rng.random()
            if p < 0.8:
                tokens[i] = mask_index
            elif p < 0.9:
                tokens[i] = rng.randrange(vocab_size)
            # else keep
    return tokens, labels


class PretrainBatcher:
    """Shuffled epoch iterator over step records producing dense batches
    for DicAddActionPreTrain."""

    def __init__(self, records: List[dict], batch_size: int,
                 vocab_size: int, mask_index: int, seed: int = 0,
                 mask_rate: float = 0.15):
        self.records = list(records)
        self.batch_size = batch_size
        self.vocab_size = vocab_size
        self.mask_index = mask_index
        self.mask_rate = mask_rate
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.records) // self.batch_size

    def epoch(self) -> Iterator[Dict[str, np.ndarray]]:
        self._rng.shuffle(self.records)
        for s in range(0, len(self.records) - self.batch_size + 1,
                       self.batch_size):
            chunk = self.records[s: s + self.batch_size]
            seq, labels = [], []
            for r in chunk:
                t, l = mask_tokens(np.asarray(r["instr_encoding"]),
                                   r["seq_len"], self.vocab_size,
                                   self.mask_index, self._rng,
                                   self.mask_rate)
                seq.append(t)
                labels.append(l)
            batch = {
                "seq": np.stack(seq).astype(np.int32),
                "labels": np.stack(labels).astype(np.int32),
                "lang_mask": (np.stack(
                    [np.asarray(r["instr_encoding"]) for r in chunk])
                    != 0).astype(np.int32),
                "feat_row": np.array([r["feat_row"] for r in chunk],
                                     np.int32),
                "view_index": np.array([r["view_index"] for r in chunk],
                                       np.int32),
                "action": np.array([r["action"] for r in chunk],
                                   np.int32),
                "progress": np.array([r["progress"] for r in chunk],
                                     np.float32),
            }
            if "next_feat_row" in chunk[0]:
                # isnext negative sampling (batch_loader.py:419-432):
                # w.p. 0.5 present the TRUE next-step pano (isnext=1),
                # else a pano of the same next viewpoint rendered from a
                # random OTHER view index (isnext=0)
                isnext = np.empty(len(chunk), np.int32)
                nview = np.empty(len(chunk), np.int32)
                for j, r in enumerate(chunk):
                    real = r["next_view_index"]
                    if self._rng.random() <= 0.5:
                        isnext[j] = 1
                        nview[j] = real
                    else:
                        isnext[j] = 0
                        fake = self._rng.randrange(35)
                        nview[j] = fake + (fake >= real)
                batch["isnext"] = isnext
                batch["next_feat_row"] = np.array(
                    [r["next_feat_row"] for r in chunk], np.int32)
                batch["next_view"] = nview
            yield batch
