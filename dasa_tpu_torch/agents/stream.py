"""Streaming rollouts: continuous batching for training and evaluation.

Counterpart of ``dasa_tpu/agents/stream.py``.  One optimizer window is
``stream_steps`` policy steps over 2B persistent slots (teacher-ML half
``[0, B)``, sampled-RL half ``[B, 2B)``).  The step after a slot's
episode ends, the slot refills with a fresh episode from a device-side
pool; episodes still mid-flight when the window closes carry their whole
state (graph position, decoder state, env-drop row, step count) into the
next window.  The window is a fixed loop of ``S`` steps: nothing in it
waits on the host, so the host only dispatches.

The semantics are the JAX package's (tests/test_stream.py holds them
there, tests/test_torch_stream.py holds the port to the JAX package):

- a streamed episode takes the actions of its standalone rollout (a
  refill restarts the decoder through the ``is_first`` blend);
- A2C returns never cross an episode (:func:`stream_returns` cuts at
  STOP and at a maxAction bookkeeping row) and an episode crossing the
  window edge bootstraps with the critic's value there; gradients stop
  at the edge (the carry is detached: truncated BPTT);
- every staged episode is consumed once: the host streams fresh episodes
  in fixed-shape chunks, the window reports (admitted, consumed,
  leftover) per half, and the host re-queues what the pool had no room
  for.  It reads window k's counters while window k + 1 is queued (a
  non-blocking copy to pinned memory behind a CUDA event), so the
  training loop never waits on the card inside a window.

Data parallel (an agent with a ``mesh`` of D ranks) is the JAX mesh
window (``_stream_shard_map``, stream.py:698-759): rank d runs the window
over its own B / D slots a half and its own pool shard (the device-major
layout: global slot ``d * W + j`` is rank d's slot j), the sums that
normalise or report the loss are summed over the ranks where JAX
``psum``s (stream.py:264-268), the gradients ride the agent's one
all-reduce in ``optim_step``, and each rank draws its window's noise from
a stream of its own, where JAX folds the device index into the window's
key (stream.py:275-281).  Every rank keeps the same host queue: each
stages the same FIFO, takes its own segment of every fresh chunk (JAX's
``P(None, d)`` shard) and reads every rank's counters, all-gathered on
the device and fetched one window late as on one device, so all ranks
re-queue alike.  The streamed ``test()`` gathers the records of every
rank.  selfTrain under stream does not stream: its relabelled passes
fall back to the host act/replay pair
(``Seq2SeqAgent.accumulate_gradient``), as in the JAX agent.  Not ported:
``precompile_stream`` (JAX AOT; eager torch compiles nothing).
``stream_unroll`` is a ``lax.scan`` codegen knob with no effect here.
``remat`` recomputes the per-step percept (``percept``) or the whole
step (``always`` and ``dots``, ``auto`` past 16 steps) in the backward,
where the JAX window checkpoints them
(``dasa_tpu/agents/stream.py:332-333, 493-498``).  The auxiliary loss
terms (back head, progress monitor, agent_advanced's
progress head, the MT agent's KL) ride the teacher half's ML loss, per
episode like the rest of it (``dasa_tpu/agents/stream.py:454-562``).
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from dasa_tpu_torch.env.device_env import (
    device_obs,
    device_transition,
    episode_inputs,
)
from dasa_tpu_torch.models.layers import NEG_INF, checkpointed
from dasa_tpu_torch.models.policy import DecoderState, decoder_state_width
from dasa_tpu_torch.sim.engine import micro_trajectory
from dasa_tpu_torch.utils.misc import Timer

# Per-episode fields staged through the pool and carried across windows:
# instr (L,) and valid (L,), the rest scalars (seq_len, global node / view
# ids, and ``uid``, a host-assigned episode id, -1 for the placeholder).
RAW_FIELDS = ("instr", "valid", "seq_len", "node0", "view0", "goal",
              "start", "uid")
_SCALARS = RAW_FIELDS[2:]
# the flow counters the host reads back, lagged
FLOW_KEYS = ("admitted", "consumed", "leftover")


def stream_returns(rewards, values, done, trunc, real, g_init,
                   gamma: float) -> torch.Tensor:
    """Per-step A2C returns over a streamed (S, W) slot-time grid
    (``dasa_tpu/agents/stream.py:78``): the reverse recurrence cut at
    ``done`` (STOP: no successor), at ``trunc`` (a maxAction bookkeeping
    row holding the critic's bootstrap), passing the accumulator through
    rows that are not ``real``; ``g_init`` is the bootstrap at the window
    edge (the critic's value for slots still mid-flight, 0 elsewhere)."""
    g = g_init
    out = []
    for t in reversed(range(rewards.shape[0])):
        g_next = torch.where(done[t], torch.zeros_like(g), g)
        G = rewards[t] + gamma * g_next
        g = torch.where(trunc[t], values[t], torch.where(real[t], G, g))
        out.append(G)
    return torch.stack(out[::-1])


class StreamGeom:
    """Geometry of a stream window: B slots per half (W = 2B), S steps,
    E pool rows per half, each PER RANK of a data-parallel job of D ranks
    (1 without one), whose global widths are D times theirs."""

    def __init__(self, batch: int, steps: int, pool: int, n_data: int = 1):
        self.B = batch
        self.W = 2 * batch
        self.S = steps
        self.E = pool
        self.D = n_data

    @property
    def W_glob(self) -> int:
        return self.D * self.W


class _StreamHost:
    """Host state of one env's stream: the device carry, the episode FIFO
    and the lagged flow-control ledger (counters (D, 2): rank x half)."""

    def __init__(self, geom: StreamGeom, carry: dict, template: dict,
                 consumed_est: float):
        self.geom = geom
        self.carry = carry
        self.template = template
        self.fifo: deque = deque()
        # (sent[h][d] item lists, flow counters in flight)
        self.inflight: deque = deque()
        self.leftover_settled = np.zeros((geom.D, 2), np.int64)
        self.consumed_est = np.full((geom.D, 2), consumed_est)
        self.next_uid = 0
        self.staged: Dict[int, dict] = {}  # uid -> episode row
        self.records: List[dict] = []      # per-window records (record=True)

    def inventory_est(self) -> np.ndarray:
        inv = self.leftover_settled.astype(np.float64)
        for sent, _flow in self.inflight:
            inv += np.array([[len(sent[h][d]) for h in (0, 1)]
                             for d in range(self.geom.D)],
                            np.float64) - self.consumed_est
        return np.maximum(inv, 0.0)


class _Flow:
    """A window's flow counters on their way to the host, every rank's
    (all-gathered on the device under data parallel): a non-blocking copy
    into pinned memory and the CUDA event that completes it (on the CPU a
    plain copy)."""

    def __init__(self, logs: dict, mesh=None):
        counters = torch.stack([logs[k] for k in FLOW_KEYS])[None]
        if mesh is not None:
            counters = mesh.all_gather(counters)           # (D, 3, 2)
        counters = counters.transpose(0, 1).contiguous()   # (3, D, 2)
        if counters.is_cuda:
            self.host = torch.empty(counters.shape, dtype=counters.dtype,
                                    pin_memory=True)
            self.host.copy_(counters, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = counters.clone(), None

    def read(self) -> Dict[str, np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        values = self.host.numpy()
        return {k: values[i] for i, k in enumerate(FLOW_KEYS)}


class StreamMixin:
    """The stream window and its host staging, mixed into Seq2SeqAgent."""

    @property
    def stream_timer(self) -> Timer:
        """Host wall time by phase of the window path: ``settle_sync``
        (waiting for a lagged window's counters), ``refill_fifo`` and
        ``stage_arrays`` (host work), ``dispatch`` (the window's launches
        and its backward)."""
        t = getattr(self, "_stream_timer", None)
        if t is None:
            t = self._stream_timer = Timer()
        return t

    # ------------------------------------------------------------------
    # gating and geometry
    # ------------------------------------------------------------------
    def use_stream_rollout(self) -> bool:
        """Streaming needs the device rollout path; under a mesh the ranks
        must split the batch into slot shards."""
        return (self.cfg.rollout_mode == "stream"
                and self.use_device_rollout()
                and (self.mesh is None or self._dp is not None))

    def _stream_geom(self) -> StreamGeom:
        cfg = self.cfg
        D = self._n_shards()
        S = cfg.stream_steps or cfg.max_action
        B = cfg.batch_size // D
        if cfg.stream_pool:
            E = -(-cfg.stream_pool // D)
        else:
            E = int(np.ceil(1.3 * B * S / max(self._stream_mean_len(), 2.0)))
        return StreamGeom(B, S, max(E, 2), D)

    def _stream_mean_len(self) -> float:
        """Steady-state episode length estimate: the dataset's mean path
        node count (hops + STOP)."""
        if self.env is None or not getattr(self.env, "data", None):
            return float(self.cfg.max_action)
        return float(np.mean([len(it["path"]) for it in self.env.data]))

    # ------------------------------------------------------------------
    # the window
    # ------------------------------------------------------------------
    def _stream_window(self, feedback: str, use_noise: bool,
                       geom: StreamGeom, carry: dict, fresh: dict,
                       fresh_n: torch.Tensor, gen, ml_w: float,
                       rl_w: float, ent_w: float, record: bool = False,
                       eval_mode: bool = False):
        """One window (``_make_stream_loss_fn``, stream.py:228): admit
        fresh episodes into the pool, encode every text the window can
        touch, run S steps with per-step refill, bootstrap the edge, and
        the losses over the slot-time grid.  Returns (loss, logs,
        new_carry); the loss is None in ``eval_mode`` (inference: no
        dropout, no noise, the policy's action in every slot).  Under data
        parallel ``geom`` is this rank's shard: its counters and records
        are its own, the loss's denominators and its logs are summed over
        the ranks."""
        from dasa_tpu_torch.agents.seq2seq import (
            _entropy,
            back_ce,
            make_step_inputs,
            mt_kl_rows,
        )

        cfg, policy = self.cfg, self.policy
        dev = self._device_env_tables()
        arrays = dev.arrays()
        dist_t, node_base_t = arrays[6], arrays[8]
        B, W, S, E = geom.B, geom.W, geom.S, geom.E
        T = cfg.max_action
        k = cfg.max_candidates
        keep_p = 1.0 - cfg.featdropout
        device = self.device
        slots = torch.arange(W, device=device)
        is_sample = slots >= B
        ml_rows = ~is_sample

        # ---- pool regions: carried leftovers first, then as much of the
        # fresh chunk as fits (the admit clamp; the host re-queues the rest)
        pool_n = carry["pool_n"]                                  # (2,)
        adm = torch.minimum(fresh_n, E - pool_n)
        avail = pool_n + adm
        idx = torch.arange(E, device=device)

        def build_region(h):
            from_carry = idx < pool_n[h]
            fi = (idx - pool_n[h]).clamp(0, E - 1)
            out = {}
            for f in RAW_FIELDS:
                c = carry["pool"][f][h]
                m = from_carry.reshape((E,) + (1,) * (c.dim() - 1))
                out[f] = torch.where(m, c, fresh[f][h][fi])
            return out

        region = [build_region(0), build_region(1)]
        # virtual table: [carried slot episodes W][teacher E][sample E]
        table = {f: torch.cat([carry["slot_raw"][f], region[0][f],
                               region[1][f]]) for f in RAW_FIELDS}
        goal_local_tab = table["goal"] - node_base_t[table["goal"]]
        total_dist_tab = dist_t[table["node0"], goal_local_tab]
        pm_target_tab = 1.0 - total_dist_tab / (total_dist_tab + 1e-10)

        # ---- one batched text encode over every episode of the table;
        # the encoder's gradients come from every step of this window
        cached_tab = policy.encode_text(
            table["instr"], table["valid"], table["seq_len"],
            self._lstm_kernel, deterministic=eval_mode, gen=gen)

        remat_percept = not eval_mode and self._recompute("percept", S)
        remat_step = not eval_mode and self._recompute("step", S)

        def forward(g, slot_ep, node, view, state, is_first, noise):
            """The policy step of the slots' current episodes."""
            valid_e = table["valid"][slot_ep]
            seqlen_e = table["seq_len"][slot_ep]
            sobs = device_obs(arrays, node, view, table["goal"][slot_ep],
                              table["start"][slot_ep],
                              total_dist_tab[slot_ep], k)
            sobs["is_first"] = is_first
            inputs = make_step_inputs(cfg, self.tables, sobs)
            percept = checkpointed(
                lambda gp: policy.percept_step(
                    {key: x[slot_ep] for key, x in cached_tab.items()},
                    valid_e, seqlen_e, inputs, lstm_kernel=self._lstm_kernel,
                    deterministic=eval_mode, is_test=eval_mode,
                    env_noise=noise[:, None, :] if use_noise else None,
                    gen=gp),
                g, remat_percept)
            new_state, logit, value, aux = policy.decode_from_percept(
                percept, valid_e, state, is_first,
                deterministic=eval_mode, already_dropfeat=use_noise,
                gen=g)
            masked = logit.float().masked_fill(sobs["logit_mask"], NEG_INF)
            return sobs, new_state, masked, value, aux

        def step(g, slot_ep, alive, age, node, view, state, noise, cur):
            """One window step: the refill, the policy, the transition and
            the step's outs.  Returns (the next step's carry, outs)."""
            out = {}
            # ---- refill dead slots from the pool, half by half
            need = ~alive
            take = torch.zeros_like(need)
            took = []
            for h, rows in ((0, ml_rows), (1, is_sample)):
                nh = need & rows
                rank = torch.cumsum(nh.long(), 0) - nh.long()
                take_h = nh & (cur[h] + rank < avail[h])
                newix = (W + h * E + cur[h] + rank).clamp(
                    W + h * E, W + (h + 1) * E - 1)
                slot_ep = torch.where(take_h, newix, slot_ep)
                take = take | take_h
                took.append(take_h.sum())
            took = torch.stack(took)
            cur = cur + took
            starved = (need & ~take).sum()
            node = torch.where(take, table["node0"][slot_ep], node)
            view = torch.where(take, table["view0"][slot_ep], view)
            age = torch.where(take, torch.zeros_like(age), age)
            alive = alive | take
            if use_noise:
                # a fresh env-drop row per episode, drawn on refill
                keep = torch.rand(noise.shape, generator=g,
                                  device=device) < keep_p
                noise = torch.where(take[:, None],
                                    keep.to(noise.dtype) / keep_p, noise)

            # maxAction truncation: one bookkeeping row holds the critic's
            # bootstrap, then the slot dies and refills
            trunc = alive & (age >= T)
            real = alive & ~trunc

            sobs, state, masked, value, aux = forward(g, slot_ep, node, view,
                                                      state, take, noise)
            logp = torch.log_softmax(masked, dim=-1)
            if feedback == "sample":
                a_pol = torch.multinomial(torch.softmax(masked.detach(), -1),
                                          1, generator=g)[:, 0]
            elif feedback == "argmax":
                a_pol = masked.detach().argmax(dim=-1)
            else:
                raise ValueError(feedback)
            a = a_pol if eval_mode else torch.where(is_sample, a_pol,
                                                    sobs["teacher"])
            a_rec = torch.minimum(a, sobs["cand_n"])

            # ---- transition and reward shaping of the real rows
            new_node, new_view, stop = device_transition(arrays, node, view,
                                                         a, ~real)
            dist_new = dist_t[new_node, goal_local_tab[slot_ep]]
            delta = sobs["distance"] - dist_new
            move_r = (delta > 0).float() - (delta < 0).float()
            stop_r = torch.where(dist_new < 3.0, 2.0, -2.0)
            done = stop & real
            reward = torch.where(real, torch.where(done, stop_r, move_r),
                                 0.0)
            out.update(reward=reward, done=done, trunc=trunc, real=real,
                       env_steps=real.sum(), refills=took, starved=starved)
            if not eval_mode:
                ce = -logp.gather(1, sobs["teacher"][:, None])[:, 0]
                out.update(ce=torch.where(real, ce, torch.zeros_like(ce)),
                           logp_a=logp.gather(1, a_rec[:, None])[:, 0],
                           ent=_entropy(logp, logp.exp()),
                           value=value.float())
                if cfg.pred_back:
                    bce = back_ce(aux, sobs)
                    out["back_ce"] = torch.where(real, bce,
                                                 torch.zeros_like(bce))
                if cfg.pred_pm:
                    out["pm_sq"] = (aux["pm_score"].float()
                                    - pm_target_tab[slot_ep]) ** 2
                if cfg.agent_type == "advanced":
                    out["adv_sq"] = (aux["pred_progress"].float()
                                     - pm_target_tab[slot_ep]) ** 2
                if cfg.agent_type == "mt":
                    # the teacher half's live rows; a per-step local mean
                    kl_row, cnt_row = mt_kl_rows(
                        logp, sobs["teacher"], sobs["cand_point_id"],
                        sobs["cand_n"],
                        real & ml_rows & (sobs["teacher"] < sobs["cand_n"]))
                    out["kl"] = kl_row.sum() / cnt_row.sum().clamp(min=1.0)
            if record:
                out.update(rec_action=a_rec, rec_node=node, rec_view=view,
                           rec_uid=table["uid"][slot_ep], rec_take=take)

            alive = real & ~stop
            age = torch.where(real, age + 1, age)
            return (slot_ep, alive, age, new_node, new_view, state, noise,
                    cur), out

        step_carry = (slots.clone(), carry["alive"], carry["age"],
                      carry["node"], carry["view"],
                      DecoderState(carry["h"], carry["c"], carry["h1"]),
                      carry["noise"],
                      torch.zeros(2, dtype=torch.long, device=device))
        outs: Dict[str, list] = {}
        for _t in range(S):
            step_carry, out = checkpointed(step, gen, remat_step, *step_carry)
            for key, val in out.items():
                outs.setdefault(key, []).append(val)
        slot_ep, alive, age, node, view, state, noise, cur = step_carry
        grid = {key: torch.stack(val) for key, val in outs.items()}

        n_eps = torch.stack([(carry["alive"] & ml_rows).sum(),
                             (carry["alive"] & is_sample).sum()]) \
            + grid["refills"].sum(0)
        mlm = (grid["real"] & ml_rows).float()
        rlm = (grid["real"] & is_sample).float()
        # the window's counts over every rank's slots, in one all-reduce
        counts = [n_eps[0], n_eps[1], grid["env_steps"].sum(),
                  grid["starved"].sum()]
        if not eval_mode:
            counts.append(rlm.sum())
        counts = self._allsum(torch.stack([c.float() for c in counts]))
        n_eps = counts[:2].long()
        logs = {"env_steps": counts[2].long(),
                "admitted": adm, "consumed": cur, "leftover": avail - cur,
                "starved": counts[3].long(), "n_eps": n_eps}
        if record:
            logs.update({key: val for key, val in grid.items()
                         if key.startswith("rec_")})
            logs.update(rec_real=grid["real"], rec_done=grid["done"],
                        rec_trunc=grid["trunc"],
                        # the end-of-window slot state closes episodes
                        # the edge kills
                        rec_node_end=node, rec_view_end=view,
                        rec_uid_end=table["uid"][slot_ep])

        loss = None
        if eval_mode:
            # slots exactly at T are finished; the next window refills them
            alive = alive & (age < T)
        else:
            # ---- window-edge bootstrap: the critic's value for slots
            # still mid-flight (a constant of the loss)
            with torch.no_grad():
                _, _, _, v_edge, _ = forward(gen, slot_ep, node, view, state,
                                             torch.zeros_like(alive), noise)
            g_init = torch.where(alive, v_edge.float(), 0.0)
            alive = alive & (age < T)

            n_ml = n_eps[0].float().clamp(min=1.0)
            forth_loss = (grid["ce"] * mlm).sum()
            ml_loss = forth_loss
            if cfg.pred_back:
                back_total = cfg.back_weight * (grid["back_ce"] * mlm).sum()
                ml_loss = ml_loss + back_total
                logs["back_loss"] = back_total / n_ml
            if cfg.pred_pm:
                # per episode, as the rest of the window's ML loss (the
                # episodic passes take a per-step batch mean)
                pm_total = cfg.pm_weight * (grid["pm_sq"] * mlm).sum()
                ml_loss = ml_loss + pm_total
                logs["pm_loss"] = pm_total / n_ml
            if cfg.agent_type == "advanced":
                adv = (grid["adv_sq"] * mlm).sum()
                ml_loss = ml_loss + 10.0 * adv
                logs["pm_loss"] = adv / n_ml
            if cfg.agent_type == "mt":
                kl_total = grid["kl"].sum()
                ml_loss = ml_loss + kl_total
                logs["kl_loss"] = kl_total / n_ml
            loss = ml_w * ml_loss / n_ml
            G = stream_returns(grid["reward"], grid["value"], grid["done"],
                               grid["trunc"], grid["real"], g_init,
                               cfg.gamma)
            adv = (G - grid["value"]).detach()
            critic = (0.5 * (G - grid["value"]) ** 2 * rlm).sum()
            rl_loss = ((-grid["logp_a"] * adv * rlm).sum() + critic
                       + (-ent_w * grid["ent"] * rlm).sum())
            total = counts[4]
            if cfg.normalize_loss == "total":
                rl_loss = rl_loss / total.clamp(min=1.0)
                critic = critic / total.clamp(min=1.0)
            elif cfg.normalize_loss == "batch":
                nb = n_eps[1].float().clamp(min=1.0)
                rl_loss = rl_loss / nb
                critic = critic / nb
            loss = loss + rl_w * rl_loss
            losses = {key: logs.pop(key) for key in ("back_loss", "pm_loss",
                                                     "kl_loss")
                      if key in logs}
            losses.update(forth_loss=forth_loss,
                          entropy=(grid["ent"] * rlm).sum(),
                          ml_loss=ml_loss / n_ml, rl_loss=rl_w * rl_loss,
                          critic_loss=rl_w * critic, loss=loss)
            logs.update(self._reduce_logs(losses), total=total)

        # ---- the next window's carry, detached (truncated BPTT)
        def leftover_rows(h):
            ix = (cur[h] + idx).clamp(0, E - 1)
            return {f: region[h][f][ix] for f in RAW_FIELDS}

        lo = [leftover_rows(0), leftover_rows(1)]
        new_carry = {
            "slot_raw": {f: table[f][slot_ep] for f in RAW_FIELDS},
            "alive": alive, "age": age, "node": node, "view": view,
            "h": state.h, "c": state.c, "h1": state.h1, "noise": noise,
            "pool": {f: torch.stack([lo[0][f], lo[1][f]])
                     for f in RAW_FIELDS},
            "pool_n": avail - cur,
        }
        new_carry = _detach(new_carry)
        return loss, logs, new_carry

    # ------------------------------------------------------------------
    # host staging
    # ------------------------------------------------------------------
    def _stream_template_row(self) -> dict:
        """A safe placeholder episode: one valid token (an all-padding
        mask would NaN the text attention, and the NaN would reach the
        gradients through the masking), node 0 with itself as goal."""
        L = self.cfg.max_input
        valid = np.zeros(L, bool)
        valid[0] = True
        return {"instr": np.zeros(L, np.int64), "valid": valid,
                "seq_len": np.int64(1), "node0": np.int64(0),
                "view0": np.int64(12), "goal": np.int64(0),
                "start": np.int64(0), "uid": np.int64(-1)}

    def _stream_init_carry(self, geom: StreamGeom) -> dict:
        cfg = self.cfg
        W, E = geom.W, geom.E
        tpl = self._stream_template_row()
        width = decoder_state_width(cfg)
        dev = self.device

        def rows(*lead):
            return {f: torch.as_tensor(np.broadcast_to(
                tpl[f], lead + np.shape(tpl[f])).copy()).to(dev)
                for f in RAW_FIELDS}

        def zeros():
            return torch.zeros(W, width, dtype=self.dtype, device=dev)

        return {
            "slot_raw": rows(W),
            "alive": torch.zeros(W, dtype=torch.bool, device=dev),
            "age": torch.zeros(W, dtype=torch.long, device=dev),
            "node": torch.zeros(W, dtype=torch.long, device=dev),
            "view": torch.full((W,), 12, dtype=torch.long, device=dev),
            "h": zeros(), "c": zeros(), "h1": zeros(),
            "noise": torch.ones(W, cfg.feature_size, dtype=self.dtype,
                                device=dev),
            "pool": rows(2, E),
            "pool_n": torch.zeros(2, dtype=torch.long, device=dev),
        }

    def _new_stream_host(self) -> _StreamHost:
        geom = self._stream_geom()
        return _StreamHost(geom, self._stream_init_carry(geom),
                           self._stream_template_row(),
                           consumed_est=geom.E / 1.3)

    def _stream_host(self) -> _StreamHost:
        """The stream state of the CURRENT env: the trainer swaps the org
        and aug envs, and each keeps its own carry, FIFO and ledger."""
        cache = getattr(self, "_stream_cache", None)
        if cache is None:
            cache = self._stream_cache = {}
        key = id(self.env)
        if key not in cache:
            cache[key] = (self.env, self._new_stream_host())
        return cache[key][1]

    def _stream_refill_fifo(self, st: _StreamHost, need: int) -> None:
        env = self.env
        dev = self._device_env_tables()
        self.stream_timer.tic("refill_fifo")
        while len(st.fifo) < need:
            env.reset()
            ep = episode_inputs(env, dev)
            static = env._static
            for i in range(len(env.batch)):
                st.fifo.append({
                    "instr": static["instr"][i].astype(np.int64),
                    "valid": ~static["pad_mask"][i],
                    "seq_len": np.int64(static["seq_len"][i]),
                    "node0": np.int64(ep["node0"][i]),
                    "view0": np.int64(ep["view0"][i]),
                    "goal": np.int64(ep["goal"][i]),
                    "start": np.int64(ep["start"][i]),
                    "uid": np.int64(st.next_uid),
                    "instr_id": env.batch[i].get("instr_id"),
                })
                st.staged[st.next_uid] = st.fifo[-1]
                st.next_uid += 1
        self.stream_timer.toc("refill_fifo")

    def _settle_stream_window(self, st: _StreamHost) -> None:
        """Read one lagged window's flow counters and reconcile: chunk
        tails the pool had no room for go back to the FIFO's front (the
        window never saw them), and the exact leftover / consumed counts
        re-anchor the inventory estimate."""
        sent, flow = st.inflight.popleft()
        self.stream_timer.tic("settle_sync")
        counts = flow.read()
        self.stream_timer.toc("settle_sync")
        adm = counts["admitted"]                               # (D, 2)
        # the exact reverse of the staging order (half-major, then rank)
        for h in (1, 0):
            for d in reversed(range(st.geom.D)):
                for it in reversed(sent[h][d][int(adm[d, h]):]):
                    st.fifo.appendleft(it)
        st.leftover_settled = counts["leftover"].astype(np.int64)
        st.consumed_est = np.maximum(counts["consumed"].astype(np.float64),
                                     1.0)

    def _stage_stream_fresh(self, st: _StreamHost):
        """This window's fixed-shape fresh chunks, one segment per rank
        and half, aimed at full pools under the lagged inventory
        estimate; this rank's segments go over in one packed
        host-to-device copy."""
        E, D = st.geom.E, st.geom.D
        rank = 0 if self._dp is None else self._dp.rank
        while len(st.inflight) >= 2:  # settle all but the running window
            self._settle_stream_window(st)
        f_n = np.clip(E - st.inventory_est(), 0, E).astype(np.int64)
        self._stream_refill_fifo(st, int(f_n.sum()))
        sent = [[[st.fifo.popleft() for _ in range(int(f_n[d, h]))]
                 for d in range(D)] for h in (0, 1)]

        self.stream_timer.tic("stage_arrays")
        L = self.cfg.max_input
        packed = np.empty((2, E, 2 * L + len(_SCALARS)) , np.int64)
        packed[:] = _pack_row(st.template)
        for h in (0, 1):
            for i, it in enumerate(sent[h][rank]):
                packed[h, i] = _pack_row(it)
        host = torch.from_numpy(np.concatenate(
            [packed.reshape(-1), f_n[rank]]))
        if self.device.type == "cuda":
            host = host.pin_memory()
        flat = host.to(self.device, non_blocking=True)
        rows = flat[:-2].reshape(packed.shape)
        fresh = {"instr": rows[..., :L], "valid": rows[..., L:2 * L].bool()}
        for j, f in enumerate(_SCALARS):
            fresh[f] = rows[..., 2 * L + j]
        self.stream_timer.toc("stage_arrays")
        return fresh, flat[-2:], sent

    # ------------------------------------------------------------------
    # training entry
    # ------------------------------------------------------------------
    def device_rollout_stream(self, train_ml: Optional[float],
                              feedback: str = "sample",
                              record: bool = False) -> None:
        """One streamed window (the stream analog of one
        ``accumulate_gradient("sample")`` pair): the window and its
        backward, whose gradients add into ``.grad``.  Fetches nothing
        (the flow counters are read lagged); ``record=True`` also keeps
        the slot-time grids in ``st.records``, as tensors on the device
        (tests, and the on-card check that no episode is taken twice)."""
        cfg = self.cfg
        st = self._stream_host()
        fresh, f_n, sent = self._stage_stream_fresh(st)
        gen = self._pass_generator(self._rollout_generator())
        self.stream_timer.tic("dispatch")
        with self._cast_params_once():
            loss, logs, st.carry = self._stream_window(
                feedback, cfg.consistent_drop, st.geom, st.carry, fresh,
                f_n, gen, float(train_ml or 0.0), 1.0,
                0.01 if feedback == "sample" else 0.0, record=record)
            loss.backward()
        self.stream_timer.toc("dispatch")
        self.stream_timer.step()
        st.inflight.append((sent, _Flow(logs, self._dp)))
        if record:  # kept on the device: no sync
            st.records.append({key: val for key, val in logs.items()
                               if key.startswith("rec_")})
        self._env_steps_log.append(logs["env_steps"])
        # episodes started this window, fetched lazily: steps / starts
        # estimates the mean episode length without a sync per window
        self.logs["stream_consumed"].append(logs["consumed"])
        for key in ("forth_loss", "entropy", "ml_loss", "rl_loss",
                    "critic_loss", "total", "loss", "back_loss", "pm_loss",
                    "kl_loss"):
            if key in logs:
                self.logs[key].append(logs[key].detach())
        self.losses.append(logs["loss"].detach())

    # ------------------------------------------------------------------
    # streamed evaluation
    # ------------------------------------------------------------------
    @torch.no_grad()
    def stream_test_loop(self) -> None:
        """Streamed evaluation (``stream_test_loop``, stream.py:1007): the
        whole split flows through the slots in eval mode; fills
        ``self.results`` as ``_device_test_batch`` does (under data
        parallel from every rank's records).  Fresh host state per call:
        evaluation must not touch the training carries."""
        cfg, env = self.cfg, self.env
        T = cfg.max_action
        dev = self._device_env_tables()
        st = self._new_stream_host()
        geom = st.geom
        segs: Dict[int, dict] = {}

        node2vp = {}
        for scan in env.scans:
            gids, base = env.graphs[scan].ids, dev.base[scan]
            for ix, vid in enumerate(gids):
                node2vp[base + ix] = vid

        def angles(view):
            return ((int(view) % 12) * (np.pi / 6),
                    (int(view) // 12 - 1) * (np.pi / 6))

        def finish(seg):
            states = seg["states"]
            tr = [(node2vp[states[0][0]], *angles(states[0][1]))]
            for (n0, v0), (n1, v1) in zip(states, states[1:]):
                micro_trajectory(node2vp[n0], int(v0), int(v1), tr)
                tr.append((node2vp[n1], *angles(v1)))
            iid = seg["instr_id"]
            self.results[iid] = {"instr_id": iid, "trajectory": tr}

        def close(seg, node, view):
            seg["states"].append((int(node), int(view)))
            seg["complete"] = True
            finish(seg)

        def process(rec):
            S, W = rec["rec_action"].shape
            for w in range(W):
                for t in range(S):
                    uid = int(rec["rec_uid"][t, w])
                    if uid < 0:
                        continue
                    seg = segs.get(uid)
                    if rec["rec_trunc"][t, w]:
                        # bookkeeping row: the state after the T-th step
                        if seg is not None and not seg["complete"]:
                            close(seg, rec["rec_node"][t, w],
                                  rec["rec_view"][t, w])
                        continue
                    if not rec["rec_real"][t, w]:
                        continue
                    if seg is None:
                        seg = segs[uid] = {
                            "states": [], "steps": 0, "complete": False,
                            "instr_id": st.staged[uid]["instr_id"]}
                    if seg["complete"]:
                        continue
                    seg["states"].append((int(rec["rec_node"][t, w]),
                                          int(rec["rec_view"][t, w])))
                    seg["steps"] += 1
                    self.total_env_steps += 1
                    if rec["rec_done"][t, w]:
                        seg["complete"] = True
                        finish(seg)
            # slots the edge kills at exactly T real steps have no trunc
            # row: the end-of-window slot state closes them
            for w in range(W):
                seg = segs.get(int(rec["rec_uid_end"][w]))
                if seg is not None and not seg["complete"] \
                        and seg["steps"] >= T:
                    close(seg, rec["rec_node_end"][w],
                          rec["rec_view_end"][w])

        def records(logs):
            """The window's records over every rank's slots (the slot axis
            is the last one), still on the device."""
            recs = {key: val for key, val in logs.items()
                    if key.startswith("rec_")}
            if self._dp is not None:
                recs = {key: self._dp.all_gather(val, dim=val.dim() - 1)
                        for key, val in recs.items()}
            return recs

        size = env.size()
        max_windows = 4 + 3 * -(-size * T // max(geom.W_glob * geom.S, 1))
        pending = None
        for _ in range(max_windows):
            fresh, f_n, sent = self._stage_stream_fresh(st)
            _, logs, st.carry = self._stream_window(
                "argmax", False, geom, st.carry, fresh, f_n, None, 0.0, 0.0,
                0.0, record=True, eval_mode=True)
            st.inflight.append((sent, _Flow(logs, self._dp)))
            if pending is not None:  # lagged fetch: no sync per window
                process({key: val.cpu().numpy()
                         for key, val in pending.items()})
                if len(self.results) >= size:
                    pending = None
                    break
            pending = records(logs)
        if pending is not None:
            process({key: val.cpu().numpy() for key, val in pending.items()})


def _pack_row(row: dict) -> np.ndarray:
    """One episode row as int64: instr, valid, then the scalar fields."""
    return np.concatenate([np.asarray(row["instr"], np.int64),
                           np.asarray(row["valid"], np.int64),
                           np.array([row[f] for f in _SCALARS], np.int64)])


def _detach(tree):
    if isinstance(tree, dict):
        return {key: _detach(val) for key, val in tree.items()}
    return tree.detach()
