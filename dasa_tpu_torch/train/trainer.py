"""World setup and the ``validlistener`` entry point.

Counterpart of ``World``, ``make_agent`` and ``valid`` in
``dasa_tpu/train/trainer.py`` (reference r2r_src/train.py:396-421).  The
training loops, beam validation, the speaker modes, NDH worlds,
checkpoint loading and the data-parallel mesh come with later slices
(ROADMAP.md).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from dasa_tpu_torch.agents.seq2seq import Seq2SeqAgent
from dasa_tpu_torch.config import Config
from dasa_tpu_torch.data.datasets import expand_instructions, load_datasets
from dasa_tpu_torch.data.features import load_feature_db
from dasa_tpu_torch.env import R2REnv
from dasa_tpu_torch.train.evaluation import Evaluation
from dasa_tpu_torch.utils import (
    Tokenizer,
    build_vocab,
    read_vocab,
    write_vocab,
)
from dasa_tpu_torch.utils.misc import set_seed


class World:
    """Shared data context: tokenizer, feature stores, envs, evaluators."""

    def __init__(self, cfg: Config, splits=("train",),
                 val_splits=("val_seen", "val_unseen")):
        self.cfg = cfg
        set_seed(cfg.seed)
        vocab_path = cfg.vocab_path or os.path.join(
            cfg.data_dir, "train_vocab.txt")
        if os.path.exists(vocab_path):
            vocab = read_vocab(vocab_path)
        else:
            train_raw = load_datasets(["train"], cfg.data_dir)
            vocab = build_vocab(train_raw, min_count=5)
            if len(vocab) < 20:  # tiny synthetic data: keep every word
                vocab = build_vocab(train_raw, min_count=1)
            write_vocab(vocab, vocab_path)
        self.tok = Tokenizer(vocab, encoding_length=cfg.max_input)

        scans = sorted({d["scan"] for split in set(
            list(splits) + list(val_splits) + (["aug"] if cfg.aug else []))
            for d in load_datasets([cfg.aug if split == "aug" else split],
                                   cfg.data_dir)})
        self.feature_db = load_feature_db(
            cfg.img_features_path, scans, cfg.connectivity_dir,
            dim=cfg.feature_size)
        self.depth_db = None
        if cfg.adain_type != "none" or cfg.depth_features_path:
            self.depth_db = load_feature_db(
                cfg.depth_features_path, scans, cfg.connectivity_dir,
                dim=cfg.feature_size, salt=0x9E3779B9)

        self.envs: Dict[str, R2REnv] = {}
        self.evaluators: Dict[str, Evaluation] = {}
        for split in list(splits) + list(val_splits):
            raw = load_datasets([split], cfg.data_dir)
            items = expand_instructions(raw, self.tok, cfg.max_input)
            self.envs[split] = self._make_env(items, split)
            self.evaluators[split] = Evaluation(
                raw, cfg.connectivity_dir, splits=[split])
        if cfg.aug:
            raw = load_datasets([cfg.aug], cfg.data_dir)
            items = expand_instructions(raw, self.tok, cfg.max_input)
            self.envs["aug"] = self._make_env(items, "aug")

    def _make_env(self, items, name):
        cfg = self.cfg
        return R2REnv(self.feature_db, items, batch_size=cfg.batch_size,
                      seed=cfg.seed, name=name,
                      connectivity_dir=cfg.connectivity_dir,
                      max_candidates=cfg.max_candidates,
                      max_input=cfg.max_input, depth_db=self.depth_db)


def make_agent(cfg: Config, world: World, env_name: str = "train",
               device=None, rng_seed: int = 0) -> Seq2SeqAgent:
    if cfg.data_parallel:
        raise NotImplementedError(
            "data_parallel comes with the data-parallel slice (ROADMAP.md)")
    return Seq2SeqAgent(cfg, world.envs[env_name], world.feature_db,
                        depth_db=world.depth_db, rng_seed=rng_seed,
                        device=device)


def valid(cfg: Config, world: Optional[World] = None, device=None,
          agent: Optional[Seq2SeqAgent] = None) -> Dict[str, dict]:
    """validlistener (train.py:396-421): argmax-evaluate every split but
    train/aug and score it.  ``agent`` reuses an agent built by
    :func:`make_agent` (with weights loaded by the caller)."""
    if cfg.load is not None:
        raise NotImplementedError(
            "loading listener checkpoints comes with the training slice "
            "(ROADMAP.md); carry JAX weights with "
            "Seq2SeqAgent.load_jax_params")
    world = world or World(cfg)
    agent = agent or make_agent(cfg, world, device=device)
    out = {}
    for env_name, env in world.envs.items():
        if env_name in ("aug", "train"):
            continue
        agent.env = env
        results = agent.test(feedback="argmax")
        if env_name == "test":
            # the test split has no ground-truth goals
            summary = {}
        else:
            summary, _ = world.evaluators[env_name].score(results)
            print("Env name: %s, %s" % (env_name, ", ".join(
                "%s: %.4f" % (m, v) for m, v in summary.items())),
                flush=True)
        out[env_name] = summary
    return out
