"""Pretraining: ``--train pretrain``.

Counterpart of ``dasa_tpu/pretrain/trainer.py`` (reference
tasks/R2R/nav_dic_pretrain.py: AdamW + WarmupLinearSchedule at 210-224,
DDP at 250-256, checkpoints at 366-382).  Data parallel as the JAX
Pretrainer's mesh (trainer.py:158-173, 236-260): with a ``mesh`` of D
ranks each rank takes its B / D rows of every batch (``shard_inputs``),
divides its loss by the whole batch's counts and sums the gradients with
one all-reduce before the clip, so the update is the single-device one;
the weights are broadcast from rank 0 and only rank 0 saves.  The model is
``DicAddActionPreTrain`` with ``update_lang_bert`` and
``update_add_layer`` forced on (the whole model trains, as the
reference's pretrain config has it), its MLM head sized to the word
tokenizer (``<MASK>`` appended to the world's tokenizer in place).

The optimizer is the JAX chain (``build_adamw``, trainer.py:48-67): the
global gradient norm clipped to 1.0 (scaled by ``1 / norm`` only when the
norm exceeds 1, no epsilon), Adam, decoupled weight decay 0.01 except on
the no-decay set, then the learning rate ``warmup_linear(count)`` read
BEFORE the count advances, so the first step's rate is 0.  The no-decay
set is decided, as in JAX, on each parameter's JAX path
(``utils/jax_params.py:jax_path_of``): ``layernorm`` anywhere in it, or
a path ending in ``bias`` or ``/b``.  A parameter without a gradient in
a step is stepped with a zero one (``train/optim.py:fill_missing_grads_``).

Snapshots are ``snap/<name>/pretrain/checkpoint-N``: a torch file of
``{"step", "state_dict"}``.  :meth:`Pretrainer.load` also reads the JAX
package's ``checkpoint-N``, a pickle of ``{"step", "params": flax
bytes}`` (``dasa_tpu/pretrain/trainer.py:213-227``).  Dropout draws its masks from a
``torch.Generator`` seeded from ``cfg.seed``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from dasa_tpu_torch.config import Config
from dasa_tpu_torch.models.featurize import assemble_pano
from dasa_tpu_torch.models.policy import bert_config_from
from dasa_tpu_torch.parallel import DataMesh, rank_seed
from dasa_tpu_torch.pretrain.data import (
    PretrainBatcher,
    generate_pretrain_records,
)
from dasa_tpu_torch.pretrain.model import DicAddActionPreTrain
from dasa_tpu_torch.train.optim import fill_missing_grads_
from dasa_tpu_torch.utils import flax_msgpack
from dasa_tpu_torch.utils.angles import all_point_angle_feature
from dasa_tpu_torch.utils.device import resolve_device
from dasa_tpu_torch.utils.jax_params import (
    jax_path_of,
    pretrain_state_dict_from_jax,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CLIP_NORM = 1.0
WEIGHT_DECAY = 0.01


def warmup_linear(lr: float, warmup_steps: int,
                  total_steps: int) -> Callable[[int], float]:
    """WarmupLinearSchedule (nav_dic_pretrain.py:222-224): linear from 0
    over ``warmup_steps``, then linear down to 0 at ``total_steps``."""

    def fn(step: int) -> float:
        if step < warmup_steps:
            return lr * step / max(warmup_steps, 1)
        return lr * max(0.0, (total_steps - step)
                        / max(total_steps - warmup_steps, 1))

    return fn


def decays(jax_path: str) -> bool:
    """The JAX chain's weight-decay mask on one param path
    (trainer.py:53-58)."""
    name = jax_path.lower()
    return not ("layernorm" in name or name.endswith("bias")
                or name.endswith("/b"))


class AdamWChain:
    """``optax.chain(clip_by_global_norm(1.0), scale_by_adam(),
    add_decayed_weights(0.01, mask), scale_by_learning_rate(schedule))``
    over a model's parameters.  ``torch.optim.AdamW`` is the last three
    (decay ``lr * 0.01 * p`` beside the Adam step); the clip and the
    schedule's count are applied around it."""

    def __init__(self, model: nn.Module, schedule: Callable[[int], float]):
        self.schedule = schedule
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.decay = {name: decays(jax_path_of(model, name))
                      for name, p in model.named_parameters()
                      if p.requires_grad}
        named = dict(model.named_parameters())
        groups = [{"params": [named[n] for n, d in self.decay.items() if d],
                   "weight_decay": WEIGHT_DECAY},
                  {"params": [named[n] for n, d in self.decay.items()
                              if not d], "weight_decay": 0.0}]
        self.adamw = torch.optim.AdamW(groups, lr=0.0, betas=(0.9, 0.999),
                                       eps=1e-8)
        self.count = 0

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> None:
        fill_missing_grads_(self.params)
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float()) for g in grads]))
        # optax: where(norm < max, g, g / norm * max)
        scale = torch.where(norm < CLIP_NORM, torch.ones_like(norm),
                            CLIP_NORM / norm)
        torch._foreach_mul_(grads, scale)
        lr = self.schedule(self.count)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.count += 1


def build_adamw(cfg: Config, model: nn.Module,
                total_steps: int) -> AdamWChain:
    """AdamW with the no-decay split for bias / LayerNorm params
    (nav_dic_pretrain.py:210-219)."""
    return AdamWChain(model, warmup_linear(cfg.lr, cfg.warm_steps,
                                           total_steps))


class Pretrainer:
    """The MLM + next-action (+ isnext) objective: CUDA unless ``device``
    names another (the tests pass ``"cpu"``), on this rank's rows of a
    ``mesh`` when one is given.  Compute runs in ``cfg.compute_dtype`` on
    the card and in f32 on the CPU; parameters are f32, made from
    ``cfg.seed``."""

    def __init__(self, cfg: Config, feature_db, vocab_size: int,
                 device=None, mesh: Optional[DataMesh] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        dtype = (torch.float32 if self.device.type == "cpu"
                 else _DTYPES[cfg.compute_dtype])
        # pretraining trains the WHOLE model: the reference forces
        # update_lang_bert / update_add_layer on in its pretrain config
        # (prevalent_pretrain.py:224-225, nav_dic_pretrain.py:686)
        self.bert_config = dataclasses.replace(
            bert_config_from(cfg), vocab_size=vocab_size,
            update_lang_bert=True, update_add_layer=True)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            model = DicAddActionPreTrain(self.bert_config, dtype)
        # dropout is explicit (the generator), never nn.Module.training
        self.model = model.to(self.device).eval()
        if mesh is not None:
            mesh.replicate_module(self.model)
        self.optimizer = build_adamw(cfg, self.model, cfg.iters)

        def table(values):
            return torch.as_tensor(np.asarray(values)).to(self.device, dtype)

        self.feat_table = table(feature_db.values)
        self.angle_table = table(
            all_point_angle_feature(cfg.angle_feat_size))
        self.step_count = 0
        # per train_step: loss, accuracies and wall seconds (the step ends
        # when its loss reaches the host)
        self.history: List[dict] = []
        self._gen = torch.Generator(device=self.device)
        # a rank's own dropout stream where the ranks split the batch;
        # where they replicate it, every rank draws one device's masks
        self._gen.manual_seed(rank_seed(
            cfg.seed + 3, mesh if mesh is not None
            and mesh.divides(cfg.batch_size) else None))

    def shard_inputs(self, batch: dict) -> dict:
        """This rank's rows of a host batch (all of it without a mesh, or
        when the ranks do not divide the batch)."""
        return batch if self.mesh is None else self.mesh.shard_batch(batch)

    def _sharded(self, batch: dict) -> bool:
        n = len(batch["seq"])
        return self.mesh is not None and self.mesh.divides(n)

    def _tensors(self, batch: dict) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v)).to(self.device)
                for k, v in batch.items()}

    def _forward(self, t: Dict[str, torch.Tensor], gen, isnext: bool,
                 norm: Optional[dict] = None):
        img = assemble_pano(self.feat_table, self.angle_table,
                            t["feat_row"], t["view_index"])
        kw = {}
        if isnext:
            # the real-or-fake next-step pano (batch_loader.py:419-432)
            kw["next_img"] = assemble_pano(self.feat_table, self.angle_table,
                                           t["next_feat_row"], t["next_view"])
            kw["isnext"] = t["isnext"]
        return self.model(t["seq"], t["labels"], t["action"], img,
                          t["lang_mask"], gen=gen, norm=norm, **kw)

    @staticmethod
    def _accuracies(t, mlm_logits, action_logits) -> Dict[str, torch.Tensor]:
        labels = t["labels"].long()
        m = labels >= 0
        hit = (mlm_logits.argmax(-1) == labels) & m
        return {"mlm_acc": hit.sum() / m.sum().clamp(min=1),
                "act_acc": (action_logits.argmax(-1)
                            == t["action"].long()).float().mean()}

    def train_step(self, batch: dict):
        """One optimizer step with dropout on; returns (loss, {mlm_acc,
        act_acc[, isnext_acc]}) as floats, of the whole batch under data
        parallel."""
        start = time.perf_counter()
        isnext = self.cfg.pretrain_isnext
        mesh = self.mesh if self._sharded(batch) else None
        t = self._tensors(self.shard_inputs(batch) if mesh else batch)
        norm = None
        if mesh is not None:
            counts = mesh.allsum(torch.stack([
                (t["labels"] >= 0).sum(), (t["action"] >= 0).sum()]).float())
            norm = {"mlm": counts[0], "action": counts[1],
                    "rows": float(len(batch["seq"]))}
        self.optimizer.zero_grad()
        out = self._forward(t, self._gen, isnext, norm)
        out[0].backward()
        if mesh is not None:
            mesh.all_reduce_grads(self.optimizer.params)
        self.optimizer.step()
        with torch.no_grad():
            labels = t["labels"].long()
            m = labels >= 0
            sums = [out[0].detach().float(),
                    ((out[1].argmax(-1) == labels) & m).sum().float(),
                    m.sum().float(),
                    (out[2].argmax(-1) == t["action"].long()).sum().float()]
            if isnext:
                sums.append((out[3].argmax(-1) == t["isnext"].long()
                             ).sum().float())
            sums = torch.stack(sums)
            if mesh is not None:
                sums = mesh.allsum(sums)
            rows = float(len(batch["seq"]) if mesh else labels.shape[0])
            aux = {"mlm_acc": sums[1] / sums[2].clamp(min=1),
                   "act_acc": sums[3] / rows}
            if isnext:
                aux["isnext_acc"] = sums[4] / rows
            vals = torch.stack([sums[0], *aux.values()]).tolist()
        self.step_count += 1
        aux = dict(zip(aux, vals[1:]))
        self.history.append({"loss": vals[0], **aux,
                             "seconds": time.perf_counter() - start})
        return vals[0], aux

    @torch.no_grad()
    def eval_outputs(self, batch: dict):
        """(loss, mlm_logits, action_logits) of one batch, dropout off, no
        isnext term (the JAX eval step's)."""
        return self._forward(self._tensors(batch), None, False)

    @torch.no_grad()
    def eval_batch(self, batch: dict) -> List[float]:
        """(loss, mlm_acc, act_acc) of one batch, dropout off, no isnext
        term (the JAX eval step's)."""
        t = self._tensors(batch)
        loss, mlm_logits, action_logits = self._forward(t, None, False)
        acc = self._accuracies(t, mlm_logits, action_logits)
        return torch.stack([loss.float(), acc["mlm_acc"].float(),
                            acc["act_acc"]]).tolist()

    def evaluate(self, batcher: PretrainBatcher,
                 max_batches: int = 50) -> dict:
        """Held-out MLM / action accuracy, averaged over up to
        ``max_batches`` batches."""
        tot = np.zeros(3)
        n = 0
        for batch in batcher.epoch():
            tot += np.array(self.eval_batch(batch))
            n += 1
            if n >= max_batches:
                break
        tot /= max(n, 1)
        return {"loss": tot[0], "mlm_acc": tot[1], "act_acc": tot[2]}

    def save(self, path: str) -> None:
        """A ``checkpoint-N`` snapshot; rank 0 writes it
        (``dasa_tpu/pretrain/trainer.py:213-220``), and under data
        parallel every rank waits for it."""
        if self.mesh is not None and self.mesh.rank != 0:
            self.mesh.barrier()
            return
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.save({"step": self.step_count,
                    "state_dict": {k: v.detach().cpu() for k, v in
                                   self.model.state_dict().items()}}, path)
        if self.mesh is not None:
            self.mesh.barrier()

    def load(self, path: str) -> None:
        """Restore a :meth:`save` snapshot, or the JAX Pretrainer's (its
        params carried over by ``pretrain_state_dict_from_jax``).  Neither
        file holds optimizer state."""
        if flax_msgpack.file_format(path) == "torch":
            blob = torch.load(path, map_location=self.device,
                              weights_only=True)
            state = blob["state_dict"]
        else:
            blob = flax_msgpack.load_plain_pickle(path)
            tree = flax_msgpack.msgpack_restore(blob["params"])
            state = {k: torch.as_tensor(v) for k, v in
                     pretrain_state_dict_from_jax(
                         tree.get("params", tree)).items()}
        self.model.load_state_dict(state)
        self.step_count = int(blob["step"])

    def export_bert_params(self) -> Dict[str, torch.Tensor]:
        """The DicModel's weights, the listener encoder's ``bert`` (the
        reference's ``encoder.bert = premodel.bert``)."""
        return self.model.bert.state_dict()


def run_pretrain(cfg: Config, world=None, device=None) -> Pretrainer:
    """CLI mode ``pretrain``: step records from the train split's teacher
    paths, ``cfg.iters`` steps of the objective, validation every
    ``val_every`` steps on a held-out twentieth (at least a batch),
    ``checkpoint-N`` every ``save_every`` steps and at the end.  As the
    JAX pretrainer always runs on a mesh of all its devices, this runs on
    the data axis of the job's ranks (one rank without launcher
    variables)."""
    from dasa_tpu_torch.train.trainer import World, make_mesh_if_requested

    world = world or World(cfg)
    tok = world.tok
    if "<MASK>" not in tok.word_to_index:
        tok.add_word("<MASK>")
    records = generate_pretrain_records(world.envs["train"],
                                        max_steps=cfg.max_action)
    print(f"pretrain records: {len(records)}")
    n_val = max(cfg.batch_size, len(records) // 20)
    val_records, records = records[:n_val], records[n_val:]
    mask = tok.word_to_index["<MASK>"]
    batcher = PretrainBatcher(records, cfg.batch_size, len(tok), mask,
                              seed=cfg.seed, mask_rate=cfg.word_mask_rate)
    val_batcher = PretrainBatcher(val_records, cfg.batch_size, len(tok),
                                  mask, seed=cfg.seed + 1,
                                  mask_rate=cfg.word_mask_rate)
    if len(batcher) == 0:
        raise ValueError(f"{len(records)} training records make no batch of "
                         f"{cfg.batch_size}")
    pt = Pretrainer(cfg, world.feature_db, len(tok), device=device,
                    mesh=make_mesh_if_requested(
                        cfg.replace(data_parallel=True)))
    snap_dir = os.path.join(cfg.snap_dir, cfg.name, "pretrain")
    start = time.time()
    it = 0
    saved = None
    while it < cfg.iters:
        for batch in batcher.epoch():
            loss, aux = pt.train_step(batch)
            it += 1
            if it % cfg.log_every == 0:
                metrics = " ".join(f"{k} {v:.3f}"
                                   for k, v in sorted(aux.items()))
                print(f"pretrain iter {it}: loss {loss:.4f} {metrics} "
                      f"({time.time() - start:.0f}s)", flush=True)
            if it % cfg.val_every == 0:
                val = pt.evaluate(val_batcher, max_batches=10)
                print(f"pretrain VAL iter {it}: loss {val['loss']:.4f} "
                      f"mlm_acc {val['mlm_acc']:.3f} "
                      f"act_acc {val['act_acc']:.3f}", flush=True)
            if it % cfg.save_every == 0 or it >= cfg.iters:
                pt.save(os.path.join(snap_dir, f"checkpoint-{it}"))
                saved = it
            if it >= cfg.iters:
                break
    if saved != it:
        pt.save(os.path.join(snap_dir, f"checkpoint-{it}"))
    return pt
