"""World setup and the ``listener`` / ``auglistener`` / ``validlistener``
(with ``--submit`` or ``--beam``) / ``beamvalid`` / ``speaker`` /
``validspeaker`` entry points.

Counterpart of ``World``, ``make_agent``, ``run_validation``, ``train``,
``beam_valid``, ``train_speaker``, ``valid_speaker`` and ``valid`` in
``dasa_tpu/train/trainer.py`` (reference r2r_src/train.py:110-517),
with the NDH worlds (``World(ndh=True)``, reference ndhtrain.py).
``data_parallel`` makes the process one rank of a data-parallel job
(:func:`make_mesh_if_requested`, ``parallel/``): launch one process a card
with torchrun or with the JAX package's variables (``COORDINATOR_ADDRESS``,
``NUM_PROCESSES``, ``PROCESS_ID``); rank 0 writes the checkpoints and the
metrics, the other ranks their metrics under ``rank{r}/``.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np

from dasa_tpu_torch.agents.seq2seq import Seq2SeqAgent
from dasa_tpu_torch.agents.speaker import SpeakerAgent
from dasa_tpu_torch.config import Config
from dasa_tpu_torch.data.datasets import expand_instructions, load_datasets
from dasa_tpu_torch.data.features import load_feature_db
from dasa_tpu_torch.data.ndh import convert_ndh_items
from dasa_tpu_torch.env import R2REnv
from dasa_tpu_torch.parallel import DataMesh, make_mesh
from dasa_tpu_torch.parallel.distributed import initialize
from dasa_tpu_torch.train.evaluation import Evaluation
from dasa_tpu_torch.train.metrics import MetricsWriter
from dasa_tpu_torch.utils import (
    Tokenizer,
    build_vocab,
    read_vocab,
    write_vocab,
)
from dasa_tpu_torch.utils.misc import GracefulKiller, Timer, set_seed


class World:
    """Shared data context: tokenizer, feature stores, envs, evaluators.

    ``ndh=True`` reads CVDN-format ``NDH_{split}.json`` dialogs and converts
    them to the R2R schema (``data/ndh.py``, with the config's
    ``path_type`` and ``history``); the listener stack then runs
    unchanged (reference ndhtrain.py)."""

    def __init__(self, cfg: Config, splits=("train",),
                 val_splits=("val_seen", "val_unseen"), ndh: bool = False):
        self.cfg = cfg
        self.ndh = ndh
        set_seed(cfg.seed)
        vocab_path = cfg.vocab_path or os.path.join(
            cfg.data_dir, "train_vocab.txt")
        if os.path.exists(vocab_path):
            vocab = read_vocab(vocab_path)
        else:
            train_raw = self._load("train")
            vocab = build_vocab(train_raw, min_count=5)
            if len(vocab) < 20:  # tiny synthetic data: keep every word
                vocab = build_vocab(train_raw, min_count=1)
            write_vocab(vocab, vocab_path)
        self.tok = Tokenizer(vocab, encoding_length=cfg.max_input)

        scans = sorted({d["scan"] for split in set(
            list(splits) + list(val_splits) + (["aug"] if cfg.aug else []))
            for d in (load_datasets([cfg.aug], cfg.data_dir)
                      if split == "aug" else self._load(split))})
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
            raw = self._load(split)
            items = expand_instructions(raw, self.tok, cfg.max_input)
            self.envs[split] = self._make_env(items, split)
            self.evaluators[split] = Evaluation(
                raw, cfg.connectivity_dir, splits=[split])
        if cfg.aug:
            raw = load_datasets([cfg.aug], cfg.data_dir)
            items = expand_instructions(raw, self.tok, cfg.max_input)
            self.envs["aug"] = self._make_env(items, "aug")

    def _load(self, split: str):
        """The split's R2R-schema items: ``{split}`` of the R2R data, or
        the converted ``NDH_{split}.json`` dialogs of an NDH world."""
        if not self.ndh:
            return load_datasets([split], self.cfg.data_dir)
        with open(os.path.join(self.cfg.data_dir, f"NDH_{split}.json")) as f:
            raw = json.load(f)
        return convert_ndh_items(raw, self.cfg.path_type, self.cfg.history)

    def _make_env(self, items, name):
        cfg = self.cfg
        return R2REnv(self.feature_db, items, batch_size=cfg.batch_size,
                      seed=cfg.seed, name=name,
                      connectivity_dir=cfg.connectivity_dir,
                      max_candidates=cfg.max_candidates,
                      max_input=cfg.max_input, depth_db=self.depth_db,
                      backend=cfg.sim_backend)


def make_mesh_if_requested(cfg: Config) -> Optional[DataMesh]:
    """--data_parallel: join the job's process group (a one-rank job
    without launcher variables) and make the data axis over its ranks
    (``dasa_tpu/train/trainer.py:112-139``)."""
    if not cfg.data_parallel:
        return None
    backend = initialize()
    mesh = make_mesh(n_data=cfg.n_data)
    n_data = mesh.n_data
    if cfg.batch_size % n_data != 0:
        print(f"WARNING: batch_size {cfg.batch_size} not divisible by "
              f"data axis {n_data}; batch-dim arrays will be replicated "
              "instead of sharded", flush=True)
    print(f"data-parallel mesh: {n_data} rank(s) on 'data', this one rank "
          f"{mesh.rank} (backend {backend or 'none: one process'})",
          flush=True)
    return mesh


def make_agent(cfg: Config, world: World, env_name: str = "train",
               device=None, rng_seed: int = 0) -> Seq2SeqAgent:
    return Seq2SeqAgent(cfg, world.envs[env_name], world.feature_db,
                        depth_db=world.depth_db, vocab_size=len(world.tok),
                        rng_seed=rng_seed, device=device,
                        mesh=make_mesh_if_requested(cfg))


def _log_dir(cfg: Config, agent) -> str:
    """The run's metrics directory; a rank but the first of a
    data-parallel job writes under ``rank{r}/`` inside it."""
    path = os.path.join(cfg.log_dir, cfg.name)
    mesh = getattr(agent, "mesh", None)
    if mesh is not None and mesh.rank != 0:
        path = os.path.join(path, f"rank{mesh.rank}")
    return path


def run_validation(agent: Seq2SeqAgent, world: World, writer, it: int,
                   best: dict, snap_dir: str,
                   val_splits=("val_seen", "val_unseen")) -> str:
    """Argmax-evaluate the val splits, log their metrics, and checkpoint
    the best SR per split, the best val_unseen SPL and the best SR sum
    (train.py:306-365, ``dasa_tpu/train/trainer.py:142``)."""
    loss_str = ""
    current_sr_sum = 0.0
    csv_row = {"iteration": it}
    for env_name in val_splits:
        agent.env = world.envs[env_name]
        results = agent.test(feedback="argmax")
        summary, _ = world.evaluators[env_name].score(results)
        loss_str += ", %s " % env_name
        for metric, val in summary.items():
            loss_str += ", %s: %.3f" % (metric, val)
            csv_row[f"{env_name} {metric}"] = round(float(val), 6)
            writer.add_scalar(f"metric/{env_name}_{metric}", val, it)
        sr = summary["success_rate"]
        current_sr_sum += sr
        if sr > best.setdefault(env_name, 0.0):
            best[env_name] = sr
            agent.save(it, os.path.join(snap_dir, f"best_{env_name}"))
        if env_name == "val_unseen" and \
                summary["spl"] > best.setdefault("spl_unseen", 0.0):
            best["spl_unseen"] = summary["spl"]
            agent.save(it, os.path.join(snap_dir, "best_spl_unseen"))
    if current_sr_sum > best.setdefault("sr_sum", 0.0):
        best["sr_sum"] = current_sr_sum
        agent.save(it, os.path.join(snap_dir, "best_sr_sum"))
    writer.write_csv_row(csv_row)
    return loss_str


def make_speaker(cfg: Config, world: World, device=None) -> SpeakerAgent:
    return SpeakerAgent(cfg, world.envs["train"], world.feature_db,
                        vocab_size=len(world.tok), tok=world.tok,
                        device=device)


def train(cfg: Config, world: Optional[World] = None, device=None,
          agent: Optional[Seq2SeqAgent] = None,
          speaker: Optional[SpeakerAgent] = None) -> Seq2SeqAgent:
    """listener / auglistener training (train.py:157-393,
    ``dasa_tpu/train/trainer.py:175``): ``cfg.iters`` optimizer
    iterations in intervals of ``log_every``, validation every
    ``val_every``, checkpoints every ``save_every`` and at the end.  With
    an aug env each iteration accumulates the org env's pass pair at
    ``ml_weight_org`` and the aug env's at ``ml_weight_aug``; under
    ``self_train`` a speaker (``speaker``, or one built here and loaded
    from ``cfg.speaker``) relabels the aug env's batches first.  Under
    ``rollout_mode="stream"`` an iteration is one streamed window per env,
    each env keeping its own stream.  ``agent`` reuses an agent built by
    :func:`make_agent`."""
    world = world or World(cfg)
    agent = agent or make_agent(cfg, world, device=device)
    train_env = world.envs["train"]
    aug_env = world.envs.get("aug")
    if cfg.self_train and speaker is None:
        speaker = make_speaker(cfg, world, device=agent.device)
        if cfg.speaker is not None:
            speaker.load(cfg.speaker)
    snap_dir = os.path.join(cfg.snap_dir, cfg.name, "state_dict")
    os.makedirs(snap_dir, exist_ok=True)
    writer = MetricsWriter(_log_dir(cfg, agent))

    start_iter = 0
    if cfg.load is not None:
        start_iter = agent.load(cfg.load)
        print(f"Loaded listener from {cfg.load} at iter {start_iter}")

    best: dict = {}
    log_every = 40 if cfg.fast_train else cfg.log_every
    start = time.time()
    killer = GracefulKiller()
    timer = Timer()
    try:
        for idx in range(start_iter, start_iter + cfg.iters, log_every):
            agent.logs = defaultdict(list)
            interval = min(log_every, start_iter + cfg.iters - idx)
            it = idx + interval

            timer.tic("train")
            if aug_env is None:
                agent.env = train_env
                agent.train(interval, feedback=cfg.feedback)
            else:
                for _ in range(interval // 2):
                    agent.zero_grad()
                    agent.env = train_env
                    agent.accumulate_gradient(cfg.feedback,
                                              ml_weight=cfg.ml_weight_org)
                    agent.env = aug_env
                    agent.accumulate_gradient(cfg.feedback,
                                              ml_weight=cfg.ml_weight_aug,
                                              speaker=speaker)
                    agent.optim_step()
            timer.toc("train")
            timer.step()

            # the scalar logs (the stream's per-half counters are not)
            logs = {key: [float(v) for v in vals]
                    for key, vals in agent.logs.items()
                    if key != "stream_consumed"}
            total = max(sum(logs.get("total", [])), 1)
            for tag in ("loss", "ml_loss", "forth_loss", "rl_loss",
                        "back_loss", "pm_loss", "kl_loss"):
                if logs.get(tag):
                    writer.add_scalar(f"loss/{tag}", float(np.mean(logs[tag])),
                                      it)
            if logs.get("critic_loss"):
                writer.add_scalar("loss/critic",
                                  sum(logs["critic_loss"]) / total, it)
            if logs.get("entropy"):
                writer.add_scalar("policy/entropy",
                                  sum(logs["entropy"]) / total, it)

            if it % cfg.val_every == 0:
                loss_str = run_validation(agent, world, writer, it, best,
                                          snap_dir)
                print("PROGRESS: %d/%d (%.0fs)%s" % (
                    it, start_iter + cfg.iters, time.time() - start,
                    loss_str), flush=True)
            if it % cfg.save_every == 0:
                agent.save(it, os.path.join(snap_dir, f"LAST_iter{it}"))
            writer.flush()
            if killer.kill_now:  # SIGINT/SIGTERM: checkpoint and stop
                agent.save(it, os.path.join(snap_dir, f"LAST_iter{it}"))
                print(f"PROGRESS: interrupted at {it}, checkpoint saved",
                      flush=True)
                break
        agent.save(start_iter + cfg.iters, os.path.join(
            snap_dir, f"LAST_iter{start_iter + cfg.iters}"))
    finally:
        killer.restore()
        writer.close()
    return agent


def beam_valid(cfg: Config, world: Optional[World] = None, device=None,
               agent: Optional[Seq2SeqAgent] = None,
               speaker: Optional[SpeakerAgent] = None) -> Dict[str, dict]:
    """Search-based validation with speaker / listener score mixing
    (train.py:424-517, ``dasa_tpu/train/trainer.py:264``): every val
    split searched, by Dijkstra (agent_dg.py:1038-1325) or, under
    ``search_type="state_factored"``, the speaker-follower's search
    (follower.py:987-999), each path rescored by the speaker, and the
    path with the best ``cal_score`` picked; its trajectory follows the
    exploration path.  ``param_search`` scores every alpha in 0..1 by
    0.05 for each averaging choice and returns the logs; otherwise
    ``alpha`` with both averages, and ``submit`` writes the picks.  The
    speaker is built on the train env at the Config's speaker widths and
    loaded from ``cfg.speaker`` when set; ``agent`` and ``speaker`` reuse
    ones already built."""
    from dasa_tpu_torch.agents.search import (
        beam_search_test,
        cal_score,
        state_factored_search_test,
    )

    world = world or World(cfg)
    agent = agent or make_agent(cfg, world, device=device)
    if speaker is None:
        speaker = make_speaker(cfg, world, device=agent.device)
        if cfg.speaker is not None:
            speaker.load(cfg.speaker)
    if cfg.load is not None:
        print("Loaded listener at iter %d" % agent.load(cfg.load))

    out = {}
    for env_name, env in world.envs.items():
        if env_name in ("train", "aug"):
            continue
        agent.env = env
        speaker.env = env
        if cfg.search_type == "state_factored":
            results = state_factored_search_test(
                agent, speaker, cfg.candidates, cfg.successor_size,
                max_expansions=cfg.max_expansions or 80)
        else:
            results = beam_search_test(agent, speaker, cfg.candidates)
        evaluator = world.evaluators[env_name]

        def pick(alpha, avg_speaker, avg_listener):
            picked = []
            for key, res in results.items():
                best = max(res["paths"],
                           key=lambda p: cal_score(p, alpha, avg_speaker,
                                                   avg_listener))
                picked.append({
                    "instr_id": key,
                    "trajectory": [(vp, 0, 0) for vp in res["dijk_path"]]
                    + best["trajectory"],
                })
            return picked

        if cfg.param_search:
            logs = []
            for avg_speaker in (False, True):
                for avg_listener in (False, True):
                    for alpha in np.arange(0.0, 1.0001, 0.05):
                        summary, _ = evaluator.score(
                            pick(alpha, avg_speaker, avg_listener),
                            allow_partial=True)
                        logs.append((avg_speaker, avg_listener,
                                     float(alpha),
                                     summary["success_rate"]))
            best = max(logs, key=lambda x: x[3])
            print(f"{env_name}: best avg_speaker={best[0]} "
                  f"avg_listener={best[1]} alpha={best[2]:.2f} "
                  f"SR={best[3]:.4f}", flush=True)
            out[env_name] = {"best": best, "logs": logs}
        else:
            picked = pick(cfg.alpha, True, True)
            summary, _ = evaluator.score(picked, allow_partial=True)
            print("Env name: %s, %s" % (env_name, ", ".join(
                "%s: %.4f" % (m, v) for m, v in summary.items())),
                flush=True)
            out[env_name] = summary
            if cfg.submit:
                _write_submit(cfg, env_name, picked)
    return out


def train_speaker(cfg: Config, world: Optional[World] = None, device=None,
                  speaker: Optional[SpeakerAgent] = None) -> SpeakerAgent:
    """Speaker training (train.py:110-155, ``dasa_tpu/train/trainer.py:
    347``): ``cfg.iters`` teacher-forcing steps in intervals of
    ``log_every``; every ``val_every`` both val splits are captioned and
    scored, and the best BLEU and the best loss of each are checkpointed
    (``best_{split}_bleu``, ``best_{split}_loss``), with a last checkpoint
    at the end.  ``speaker`` reuses a speaker built by
    :func:`make_speaker`."""
    world = world or World(cfg)
    speaker = speaker or make_speaker(cfg, world, device=device)
    snap_dir = os.path.join(cfg.snap_dir, cfg.name, "state_dict")
    os.makedirs(snap_dir, exist_ok=True)
    writer = MetricsWriter(os.path.join(cfg.log_dir, cfg.name))
    best_bleu = defaultdict(lambda: 0.0)
    best_loss = defaultdict(lambda: 1e9)
    log_every = 40 if cfg.fast_train else cfg.log_every
    try:
        for idx in range(0, cfg.iters, log_every):
            it = idx + min(log_every, cfg.iters - idx)
            speaker.env = world.envs["train"]
            losses = speaker.train(it - idx)
            writer.add_scalar("speaker/train_loss", float(np.mean(losses)),
                              it)
            if it % cfg.val_every == 0:
                for env_name, out in _speaker_scores(speaker, world):
                    bleu, loss = out["bleu"], out["loss"]
                    writer.add_scalar(f"speaker/{env_name}_bleu", bleu, it)
                    writer.add_scalar(f"speaker/{env_name}_loss", loss, it)
                    if bleu > best_bleu[env_name]:
                        best_bleu[env_name] = bleu
                        speaker.save(it, os.path.join(
                            snap_dir, f"best_{env_name}_bleu"))
                    if loss < best_loss[env_name]:
                        best_loss[env_name] = loss
                        speaker.save(it, os.path.join(
                            snap_dir, f"best_{env_name}_loss"))
                    print(f"SPEAKER iter {it} {env_name}: bleu {bleu:.4f} "
                          f"loss {loss:.4f} word_accu "
                          f"{out['word_accu']:.4f}", flush=True)
                writer.flush()
        speaker.save(cfg.iters, os.path.join(snap_dir,
                                             f"LAST_iter{cfg.iters}"))
    finally:
        writer.close()
    return speaker


def _speaker_scores(speaker: SpeakerAgent, world: World):
    """(split, {bleu, loss, word_accu, sent_accu, path2inst}) of each val
    split the world has: every path captioned, BLEU against the split's
    references."""
    for env_name in ("val_seen", "val_unseen"):
        if env_name not in world.envs:
            continue
        speaker.env = world.envs[env_name]
        path2inst, loss, word_accu, sent_accu = speaker.valid()
        bleu, _precisions = world.evaluators[env_name].bleu_score(
            path2inst, world.tok)
        yield env_name, {"bleu": bleu, "loss": loss, "word_accu": word_accu,
                         "sent_accu": sent_accu, "path2inst": path2inst}


def valid_speaker(cfg: Config, world: Optional[World] = None, device=None,
                  speaker: Optional[SpeakerAgent] = None) -> Dict[str, dict]:
    """validspeaker (``dasa_tpu/train/trainer.py:387``): caption and score
    both val splits after loading ``cfg.load`` when set.  Returns
    {split: {bleu, loss, word_accu, sent_accu, path2inst}}."""
    world = world or World(cfg)
    speaker = speaker or make_speaker(cfg, world, device=device)
    if cfg.load:
        speaker.load(cfg.load)
    out = {}
    for env_name, scores in _speaker_scores(speaker, world):
        out[env_name] = scores
        print(f"{env_name}: bleu {scores['bleu']:.4f} loss "
              f"{scores['loss']:.4f}", flush=True)
    return out


def valid(cfg: Config, world: Optional[World] = None, device=None,
          agent: Optional[Seq2SeqAgent] = None) -> Dict[str, dict]:
    """validlistener (train.py:396-421, ``dasa_tpu/train/trainer.py:
    415``): argmax-evaluate every split but train/aug and score it, after
    loading ``cfg.load`` when set; under ``cfg.submit`` (the host rollout
    with the visited-candidate mask) write each split's results to
    ``{log_dir}/{name}/submit_{split}.json``.  ``agent`` reuses an agent
    built by :func:`make_agent`."""
    world = world or World(cfg)
    agent = agent or make_agent(cfg, world, device=device)
    if cfg.load is not None:
        it = agent.load(cfg.load)
        print(f"Loaded listener at iter {it} from {cfg.load}")
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
        if cfg.submit and (agent.mesh is None or agent.mesh.rank == 0):
            _write_submit(cfg, env_name, results)
    return out


def _write_submit(cfg: Config, env_name: str, results) -> None:
    """``{log_dir}/{name}/submit_{split}.json``: the results as the
    leaderboard reads them."""
    os.makedirs(os.path.join(cfg.log_dir, cfg.name), exist_ok=True)
    path = os.path.join(cfg.log_dir, cfg.name, f"submit_{env_name}.json")
    with open(path, "w") as f:
        json.dump(results, f, sort_keys=True, indent=2)
