"""Speaker agent: training, validation, inference, back-translation.

Counterpart of ``dasa_tpu/agents/speaker.py`` (reference
r2r_src/speaker.py:10-388).  Trajectories are collected on the host as
index records by teacher-driving the graph env, and their features are
gathered on the device from the resident tables.  Where the JAX agent
runs teacher forcing and the 120-step decode as single jitted programs,
the port runs them as Python loops over words; the decode stops once
every row has ended (the words are the same: an ended row emits PAD).
Both BiLSTMs of the encoder run through the LSTM kernels (K1 forward, K2
backward, ``ops/lstm.py:BiLstmScanFn``) unless ``use_pallas="never"``.

Dropout, featdrop and sampled words draw from a ``torch.Generator``
reseeded per call from (seed, call counter), as the JAX agent folds its
counter into ``_rng``; the two frameworks' streams differ, so parity with
the JAX package holds for greedy and beam decoding and with dropout off.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from dasa_tpu_torch.config import Config
from dasa_tpu_torch.data.features import FeatureDB
from dasa_tpu_torch.env import R2REnv
from dasa_tpu_torch.models.featurize import angle_feature, assemble_pano
from dasa_tpu_torch.models.layers import NEG_INF
from dasa_tpu_torch.models.speaker import SpeakerModel
from dasa_tpu_torch.train.optim import (
    CLIP_NORM,
    clip_grad_global_norm_,
    fill_missing_grads_,
    make_optimizer,
    restore_optax_state,
)
from dasa_tpu_torch.utils import flax_msgpack
from dasa_tpu_torch.utils.angles import all_point_angle_feature
from dasa_tpu_torch.utils.device import resolve_device
from dasa_tpu_torch.utils.jax_params import speaker_state_dict_from_jax
from dasa_tpu_torch.utils.vocab import PAD_IDX, Tokenizer

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
REC_KEYS = ("feat_row", "view_index", "cand_point_id", "cand_heading",
            "cand_elevation", "has_cand")


class SpeakerAgent:
    """The speaker of ``cfg``'s widths (``rnn_dim``, ``wemb``,
    ``max_decode``, ``bidir``, ``featdropout``) over ``env``.

    Runs on CUDA unless ``device`` names another device; computes in
    ``cfg.compute_dtype`` on the card and in f32 on the CPU, with f32
    parameters made from ``rng_seed``.  One optimizer over all parameters
    (``_build_tx``, ``dasa_tpu/agents/speaker.py:107-120``): the global-norm
    clip at 40, then ``cfg.optim`` at the constant ``cfg.lr`` without
    weight decay."""

    def __init__(self, cfg: Config, env: Optional[R2REnv],
                 feature_db: FeatureDB, vocab_size: int, tok: Tokenizer,
                 rng_seed: int = 0, device=None):
        self.cfg = cfg
        self.env = env
        self.tok = tok
        self.device = resolve_device(device)
        dtype = _DTYPES[cfg.compute_dtype]
        self.dtype = torch.float32 if self.device.type == "cpu" else dtype
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed + 31 + rng_seed)
            model = SpeakerModel(cfg, vocab_size, compute_dtype=self.dtype)
        # dropout is explicit (a generator per call), never nn.Module.training
        self.model = model.to(self.device).eval()
        self._lstm_kernel = cfg.use_pallas != "never"
        self.params = [p for p in self.model.parameters()
                       if p.requires_grad]
        self.optimizer = make_optimizer(cfg.replace(weight_decay=0.0),
                                        self.params)
        self.feat_table = torch.as_tensor(np.asarray(feature_db.values)).to(
            self.device, self.dtype)
        self.angle_table = torch.as_tensor(
            all_point_angle_feature(cfg.angle_feat_size)).to(self.device,
                                                            self.dtype)
        self._seed = cfg.seed + 17 + rng_seed
        self._gen = torch.Generator(device=self.device)
        self._counter = 0
        self._bos = tok.word_to_index["<BOS>"]
        self._eos = tok.word_to_index["<EOS>"]
        self._unk = tok.word_to_index["<UNK>"]

    def load_jax_params(self, params) -> None:
        """Load the JAX ``SpeakerModel`` param tree (nested dicts of
        arrays, with or without the top-level ``params`` key)."""
        self.model.load_state_dict(
            {k: torch.as_tensor(v)
             for k, v in speaker_state_dict_from_jax(params).items()})

    def _generator(self) -> torch.Generator:
        self._gen.manual_seed(self._seed * 1_000_003 + self._counter)
        self._counter += 1
        return self._gen

    # ------------------------------------------------------------------
    # trajectory collection (host): from_shortest_path (speaker.py:164-199)
    # with index records instead of feature blocks
    # ------------------------------------------------------------------
    def collect_teacher_path(self, max_steps: Optional[int] = None
                             ) -> Tuple[dict, np.ndarray]:
        """Teacher-drive the env's current batch; returns the (B, T) index
        records and each row's length.  T is padded up to a multiple of 4
        (at most ``max_steps``) by repeating the last step with
        ``has_cand`` False, exactly as the JAX agent buckets its program
        shapes: the encoder's BiLSTMs run over the padding."""
        env = self.env
        obs = env._get_obs()
        b = obs.batch_size()
        max_steps = max_steps or self.cfg.max_action
        ended = np.zeros(b, bool)
        lengths = np.zeros(b, np.int64)
        rec = {k: [] for k in REC_KEYS}
        rows = np.arange(b)
        for _ in range(max_steps):
            if ended.all():
                break
            teacher = np.where(obs.teacher >= obs.cand_n, -1,
                               obs.teacher).astype(np.int64)
            teacher = np.where(ended, -1, teacher)
            safe_t = np.maximum(teacher, 0)
            rec["feat_row"].append(obs.feat_row.copy())
            rec["view_index"].append(obs.view_index.copy())
            rec["cand_point_id"].append(obs.cand_point_id[rows, safe_t])
            rec["cand_heading"].append(obs.cand_heading[rows, safe_t])
            rec["cand_elevation"].append(obs.cand_elevation[rows, safe_t])
            rec["has_cand"].append(teacher >= 0)
            lengths += (~ended).astype(np.int64)
            obs = env.step(teacher)
            ended |= teacher == -1
        stacked = {k: np.stack(v, axis=1) for k, v in rec.items()}
        t = stacked["feat_row"].shape[1]
        t_pad = min(max_steps, -(-t // 4) * 4)
        if t_pad > t:
            for k, v in stacked.items():
                tail = np.repeat(v[:, -1:], t_pad - t, axis=1)
                if k == "has_cand":
                    tail = np.zeros_like(tail)
                stacked[k] = np.concatenate([v, tail], axis=1)
        return stacked, lengths

    def _gather_traj_feats(self, rec):
        """(B, T) index records -> img_feats (B, T, 36, F), can_feats
        (B, T, F) on the device."""
        cfg = self.cfg

        def put(key):
            return torch.as_tensor(rec[key]).to(self.device).reshape(-1)

        b, t = rec["feat_row"].shape
        feat_row = put("feat_row").long()
        img = assemble_pano(self.feat_table, self.angle_table, feat_row,
                            put("view_index"))
        img = img.reshape(b, t, cfg.views, -1)
        vis = self.feat_table[feat_row, put("cand_point_id").long()]
        ang = angle_feature(put("cand_heading"), put("cand_elevation"),
                            cfg.angle_feat_size).to(vis.dtype)
        can = torch.cat([vis, ang], dim=-1)
        can = torch.where(put("has_cand")[:, None], can, 0.0)
        return img, can.reshape(b, t, -1)

    def _ctx_mask(self, t: int, lengths) -> torch.Tensor:
        """(B, T) True past each row's length."""
        lengths = torch.as_tensor(np.asarray(lengths)).to(self.device)
        return torch.arange(t, device=self.device)[None, :] >= lengths[:, None]

    def _encode(self, img, can, already_dropfeat: bool = False, gen=None):
        return self.model.encoder(can, img, already_dropfeat=already_dropfeat,
                                  gen=gen, kernel=self._lstm_kernel)

    def _zeros(self, rows: int) -> torch.Tensor:
        return torch.zeros(rows, self.cfg.rnn_dim, dtype=self.dtype,
                           device=self.device)

    def _tf_logits(self, img, can, insts, ctx_mask, gen=None):
        """Teacher-forced f32 logits (B, Lw, V) of ``insts`` (B, Lw)."""
        ctx = self._encode(img, can, gen=gen)
        h0 = self._zeros(can.shape[0])
        return self.model.decoder(insts, ctx, ctx_mask, h0, h0,
                                  gen=gen).float()

    def _tf_loss(self, img, can, insts, ctx_mask, gen=None):
        """The teacher-forcing loss (mean CE of insts[:, 1:] from
        logits[:, :-1] over non-PAD targets), word and sentence
        accuracy."""
        logits = self._tf_logits(img, can, insts, ctx_mask, gen)[:, :-1]
        tgt = insts[:, 1:]
        logp = torch.log_softmax(logits, dim=-1)
        ce = -logp.gather(-1, tgt[..., None])[..., 0]
        w = (tgt != PAD_IDX).float()
        loss = (ce * w).sum() / w.sum().clamp(min=1.0)
        correct = (logits.argmax(-1) == tgt) & (tgt != PAD_IDX)
        word_accu = correct.sum() / w.sum().clamp(min=1.0)
        sent_accu = (correct.sum(1) == w.sum(1)).float().mean()
        return loss, word_accu, sent_accu

    def _batch(self):
        """Teacher trajectories of the env's current batch: (img, can,
        ctx_mask)."""
        rec, lengths = self.collect_teacher_path()
        img, can = self._gather_traj_feats(rec)
        t = rec["feat_row"].shape[1]
        return img, can, self._ctx_mask(t, lengths)

    # ------------------------------------------------------------------
    # decoding
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _decode(self, img, can, ctx_mask, sampling: bool, featdropmask,
                gen) -> torch.Tensor:
        """Greedy or sampled decode of up to ``max_decode`` words (B,
        max_decode); UNK masked out, PAD after a row's EOS."""
        if featdropmask is not None:
            a = self.cfg.angle_feat_size
            mask = featdropmask.to(self.device, self.dtype)
            img = torch.cat([img[..., :-a] * mask, img[..., -a:]], -1)
            can = torch.cat([can[..., :-a] * mask, can[..., -a:]], -1)
        ctx = self._encode(img, can, already_dropfeat=True)
        b = can.shape[0]
        h = c = self._zeros(b)
        word = torch.full((b,), self._bos, dtype=torch.long,
                          device=self.device)
        ended = torch.zeros(b, dtype=torch.bool, device=self.device)
        words = torch.full((b, self.cfg.max_decode), PAD_IDX,
                           dtype=torch.long, device=self.device)
        for i in range(self.cfg.max_decode):
            logit, h, c = self.model.decoder.step(word, ctx, ctx_mask, h, c)
            logit = logit.float()
            logit[:, self._unk] = NEG_INF
            if sampling:
                nxt = torch.multinomial(torch.softmax(logit, -1), 1,
                                        generator=gen)[:, 0]
            else:
                nxt = logit.argmax(-1)
            word = torch.where(ended, PAD_IDX, nxt)
            words[:, i] = word
            ended = ended | (word == self._eos)
            if bool(ended.all()):
                break
        return words

    @torch.no_grad()
    def first_step_logits(self) -> torch.Tensor:
        """f32 logits (B, V) of the first decode step (from BOS) of the env's
        current batch: the comparison point between kernel settings."""
        img, can, ctx_mask = self._batch()
        ctx = self._encode(img, can, already_dropfeat=True)
        b = can.shape[0]
        bos = torch.full((b,), self._bos, dtype=torch.long,
                         device=self.device)
        h0 = self._zeros(b)
        return self.model.decoder.step(bos, ctx, ctx_mask, h0, h0)[0].float()

    def infer_batch(self, sampling: bool = False,
                    featdropmask: Optional[torch.Tensor] = None
                    ) -> np.ndarray:
        """Decode instructions for the env's current batch's teacher
        trajectories: (B, max_decode) word ids.  ``featdropmask``
        (feature_size,) scales the visual channels first (selfTrain's
        shared env-drop mask)."""
        img, can, ctx_mask = self._batch()
        words = self._decode(img, can, ctx_mask, sampling, featdropmask,
                             self._generator())
        return words.cpu().numpy()

    @torch.no_grad()
    def beam_infer_batch(self, beam_size: int = 3
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Beam-decode instructions for the current batch's teacher
        trajectories (``dasa_tpu/agents/speaker.py:_beam_infer_fn``: the
        context repeated per beam, only beam 0 live at the start, an ended
        beam continues only through PAD at no cost).  Returns (words
        (B, K, max_decode), scores (B, K)), best first."""
        img, can, ctx_mask = self._batch()
        k = beam_size
        ctx = self._encode(img, can, already_dropfeat=True)
        b = can.shape[0]
        ctx_e = ctx.repeat_interleave(k, 0)
        mask_e = ctx_mask.repeat_interleave(k, 0)
        h = c = self._zeros(b * k)
        dev = self.device
        word = torch.full((b, k), self._bos, dtype=torch.long, device=dev)
        logp = torch.where(torch.arange(k, device=dev) == 0, 0.0,
                           NEG_INF).expand(b, k)
        ended = torch.zeros(b, k, dtype=torch.bool, device=dev)
        seqs = torch.full((b, k, self.cfg.max_decode), PAD_IDX,
                          dtype=torch.long, device=dev)
        for i in range(self.cfg.max_decode):
            logit, h, c = self.model.decoder.step(word.reshape(b * k), ctx_e,
                                                  mask_e, h, c)
            logit = logit.float()
            logit[:, self._unk] = NEG_INF
            lp = torch.log_softmax(logit, -1).reshape(b, k, -1)
            v = lp.shape[-1]
            pad_only = torch.full((v,), NEG_INF, device=dev)
            pad_only[PAD_IDX] = 0.0
            cand = logp[:, :, None] + torch.where(ended[:, :, None],
                                                  pad_only, lp)
            logp, flat_ix = cand.reshape(b, k * v).topk(k, dim=-1)
            parent = flat_ix // v

            def by_parent(x):
                x = x.reshape(b, k, -1)
                idx = parent[:, :, None].expand(-1, -1, x.shape[-1])
                return x.gather(1, idx)

            h = by_parent(h).reshape(b * k, -1)
            c = by_parent(c).reshape(b * k, -1)
            seqs = by_parent(seqs)
            ended = ended.gather(1, parent)
            word = torch.where(ended, PAD_IDX, flat_ix % v)
            seqs[:, :, i] = word
            ended = ended | (word == self._eos)
            if bool(ended.all()):
                # every beam now continues through PAD at no cost: the
                # remaining steps change neither words nor scores
                break
        return seqs.cpu().numpy(), logp.cpu().numpy()

    # ------------------------------------------------------------------
    # public API (speaker.py contract)
    # ------------------------------------------------------------------
    def train(self, iters: int):
        """``iters`` teacher-forcing steps on fresh env batches; returns
        the losses."""
        losses = []
        for _ in range(iters):
            obs = self.env.reset()
            img, can, ctx_mask = self._batch()
            insts = torch.as_tensor(obs.instr).to(self.device).long()
            loss, _wa, _sa = self._tf_loss(img, can, insts, ctx_mask,
                                           self._generator())
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            fill_missing_grads_(self.params)
            clip_grad_global_norm_(self.params, CLIP_NORM)
            self.optimizer.step()
            losses.append(loss.detach())
        return [float(x) for x in losses]

    @torch.no_grad()
    def teacher_forcing_eval(self):
        """(loss, word accuracy, sentence accuracy) of the env's current
        batch, dropout off."""
        obs = self.env._get_obs()
        img, can, ctx_mask = self._batch()
        insts = torch.as_tensor(obs.instr).to(self.device).long()
        return tuple(float(x) for x in self._tf_loss(img, can, insts,
                                                     ctx_mask))

    def get_insts(self):
        """Caption every item (speaker.py:62-74): path_id -> word ids."""
        self.env.reset_epoch(shuffle=True)
        path2inst = {}
        for _ in range(self.env.size() // self.env.batch_size + 1):
            self.env.reset()
            insts = self.infer_batch()
            for item, inst in zip(self.env.batch, insts):
                if item["path_id"] not in path2inst:
                    path2inst[item["path_id"]] = self.tok.shrink(list(inst))
        return path2inst

    def valid(self):
        """(path2inst, loss, word accuracy, sentence accuracy): every path
        captioned, then teacher forcing averaged over 3 batches (1 under
        ``fast_train``)."""
        path2inst = self.get_insts()
        self.env.reset_epoch(shuffle=True)
        n = 1 if self.cfg.fast_train else 3
        metrics = np.zeros(3)
        for _ in range(n):
            self.env.reset()
            metrics += np.array(self.teacher_forcing_eval())
        return (path2inst, *(metrics / n))

    @torch.no_grad()
    def score_instruction(self, rec: dict, insts: np.ndarray) -> np.ndarray:
        """Per-word CE of instructions given trajectory index records, the
        speaker side of beam rescoring (speaker.py:249-253).  ``rec``
        holds (B, T) stacks as :meth:`collect_teacher_path` gives them;
        returns (B, L-1) losses, PAD targets zeroed."""
        img, can = self._gather_traj_feats(rec)
        t = rec["feat_row"].shape[1]
        ctx_mask = self._ctx_mask(t, rec["has_cand"].sum(1))
        insts = torch.as_tensor(np.asarray(insts)).to(self.device).long()
        logits = self._tf_logits(img, can, insts, ctx_mask)[:, :-1]
        tgt = insts[:, 1:]
        ce = -torch.log_softmax(logits, -1).gather(-1, tgt[..., None])[..., 0]
        return torch.where(tgt != PAD_IDX, ce, 0.0).cpu().numpy()

    def relabel_batch(self, env: R2REnv,
                      env_noise: Optional[torch.Tensor]):
        """Back-translation for the listener's selfTrain path
        (agent_dg.py:656-675): greedily decode instructions for the env's
        current batch (the visual features scaled by the listener's
        env-drop noise), swap re-encoded copies of the batch's items in and
        reset the env with them; ``env.data`` is left untouched.  Returns
        the env's observation.  (The JAX agent's signature also takes the
        rollout's ``base_rng``, which its greedy decode never reads.)"""
        self.env = env
        batch = [dict(item) for item in env.batch]
        insts = self.infer_batch(featdropmask=env_noise)
        max_input = self.cfg.max_input
        for datum, inst in zip(batch, insts):
            nz = np.nonzero(inst == PAD_IDX)[0]
            inst = list(inst[:int(nz[0]) if len(nz) else len(inst)])
            if inst and inst[-1] == self._eos:
                inst = inst[:-1]
            datum["instructions"] = self.tok.decode_sentence(inst)
            enc = self.tok.encode_sentence(datum["instructions"],
                                           max_length=max_input)
            if enc is None:
                enc = np.zeros(max_input, np.int64)
                enc[0], enc[1] = self._bos, self._eos
            datum["instr_encoding"] = enc
        return env.reset(batch)

    # ------------------------------------------------------------------
    def save(self, epoch: int, path: str) -> None:
        """The port's checkpoint: epoch, the model's state_dict (the
        reference's names under ``encoder.`` and ``decoder.``) and the
        optimizer's state."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.save({"epoch": epoch, "model": self.model.state_dict(),
                    "optimizer": self.optimizer.state_dict()}, path)

    def load(self, path: str) -> int:
        """Restore a :meth:`save` checkpoint (the optimizer's state too
        under ``load_optim``), or the JAX package's speaker file (a pickle
        of ``{"epoch", "params": flax bytes, "opt_state"}``, whose optax
        state ``train/optim.py:restore_optax_state`` carries into the
        optimizer under ``load_optim``); returns its epoch."""
        fmt = flax_msgpack.file_format(path)
        if fmt == "pickle":
            blob = flax_msgpack.load_plain_pickle(path)
            self.load_jax_params(flax_msgpack.msgpack_restore(blob["params"]))
            if self.cfg.load_optim:
                if blob.get("opt_state") is None:
                    print("NOTICE: optimizer state not restored (the file "
                          "holds no opt_state)", flush=True)
                else:
                    restore_optax_state(
                        self.optimizer,
                        {p: n for n, p in self.model.named_parameters()},
                        flax_msgpack.msgpack_restore(blob["opt_state"]),
                        speaker_state_dict_from_jax)
            return int(blob["epoch"])
        if fmt != "torch":
            raise ValueError(f"{path!r}: a {fmt} file is no speaker "
                             "checkpoint")
        blob = torch.load(path, map_location=self.device)
        self.model.load_state_dict(blob["model"])
        if self.cfg.load_optim:
            self.optimizer.load_state_dict(blob["optimizer"])
        return int(blob["epoch"])
