"""The reference's stream training window and its optimizer step.

A frozen copy of the port's window arithmetic (``agents/stream.py``:
``_stream_window`` in training, ``stream_returns``; ``train/optim.py``:
the per-component RMSprop, clipping and schedule) in float32.  It takes
from the program only what the program decides and the reference cannot
decide again: which episodes the host staged into each window's fresh
chunk (by instruction id) and the sampled half's actions.  It works out
the rest again: each episode's tokens and start state from the raw
items, the pool, the refills, the observations, the teacher's actions,
the transitions, the rewards, the losses, the gradients and the update.
It draws the same noise as the program (same generator seed, same draws
in the same order), and makes its own draw of every sampled action, which
the comparison sets against the program's.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from port_bench.reference.policy import (
    DecoderState,
    ReferencePolicy,
    StepInputs,
    masked_logits,
)
from port_bench.reference.world import Tables, step_features, tokenize

FIELDS = ("instr", "valid", "seq_len", "node0", "view0", "goal", "start",
          "uid")
COMPONENTS = ("encoder", "decoder", "critic", "adain")
SCHEDULED = ("decoder", "critic", "adain")
CLIPPED = ("encoder", "decoder")
CLIP_NORM = 40.0
RMS_ALPHA, RMS_EPS = 0.99, 1e-8


def pool_rows(batch: int, steps: int, mean_len: float, pool: int = 0) -> int:
    """The pool's rows a half: ``pool`` where the configuration sets it,
    else 1.3 times the episodes a half's slots start in a window at the
    items' mean path length."""
    if not pool:
        pool = int(np.ceil(1.3 * batch * steps / max(mean_len, 2.0)))
    return max(pool, 2)


def rollout_seed(seed: int, window: int) -> int:
    return seed * 1_000_003 + window


class Episodes:
    """Episode rows worked out from the raw items, by instruction id."""

    def __init__(self, items: Sequence[dict], vocab: List[str],
                 tables: Tables, max_input: int):
        self.rows: Dict[str, dict] = {}
        for item in items:
            for j, text in enumerate(item["instructions"]):
                iid = f"{item['path_id']}_{j}"
                enc = tokenize(text, vocab, max_input)
                nz = np.nonzero(enc == 0)[0]
                node0, view0, goal = tables.start_state(item)
                self.rows[iid] = {
                    "instr": enc, "valid": enc != 0,
                    "seq_len": int(nz[0]) if len(nz) else len(enc),
                    "node0": node0, "view0": view0, "goal": goal,
                    "start": node0}

    @staticmethod
    def template(max_input: int) -> dict:
        valid = np.zeros(max_input, bool)
        valid[0] = True
        return {"instr": np.zeros(max_input, np.int64), "valid": valid,
                "seq_len": 1, "node0": 0, "view0": 12, "goal": 0,
                "start": 0, "uid": -1}

    def chunk(self, staged: Sequence[Sequence], pool: int, max_input: int,
              device) -> Dict[str, torch.Tensor]:
        """The fresh chunk of a window: per half, the staged (instr_id,
        uid) episodes, then template rows up to ``pool``."""
        out = {f: [] for f in FIELDS}
        tpl = self.template(max_input)
        for half in staged:
            rows = [dict(self.rows[iid], uid=uid) for iid, uid in half]
            rows += [tpl] * (pool - len(rows))
            for f in FIELDS:
                out[f].append(np.stack([np.asarray(r[f]) for r in rows]))
        res = {f: torch.as_tensor(np.stack(v), device=device)
               for f, v in out.items()}
        res["valid"] = res["valid"].bool()
        for f in FIELDS:
            if f != "valid":
                res[f] = res[f].long()
        return res


def init_carry(W: int, E: int, width: int, feat: int, max_input: int,
               device) -> dict:
    tpl = Episodes.template(max_input)

    def rows(*lead):
        out = {f: torch.as_tensor(np.broadcast_to(
            np.asarray(tpl[f]), lead + np.shape(tpl[f])).copy(),
            device=device) for f in FIELDS}
        out["valid"] = out["valid"].bool()
        for f in FIELDS:
            if f != "valid":
                out[f] = out[f].long()
        return out

    zeros = torch.zeros(W, width, device=device)
    return {"slot_raw": rows(W),
            "alive": torch.zeros(W, dtype=torch.bool, device=device),
            "age": torch.zeros(W, dtype=torch.long, device=device),
            "node": torch.zeros(W, dtype=torch.long, device=device),
            "view": torch.full((W,), 12, dtype=torch.long, device=device),
            "h": zeros, "c": zeros, "h1": zeros,
            "noise": torch.ones(W, feat, device=device),
            "pool": rows(2, E),
            "pool_n": torch.zeros(2, dtype=torch.long, device=device)}


def recomputed(fn, gen, *args):
    """``fn(gen, *args)`` with its activations recomputed in the backward
    (to fit the float32 window in memory), the recompute drawing from a
    copy of ``gen`` restored to its state before the forward, so both
    passes see the same dropout masks."""
    if not torch.is_grad_enabled():
        return fn(gen, *args)
    state = gen.get_state()
    calls = []

    def run(*inner):
        calls.append(None)
        g = gen
        if len(calls) > 1:
            g = torch.Generator(device=gen.device)
            g.set_state(state)
        return fn(g, *inner)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


def stream_returns(rewards, values, done, trunc, real, g_init, gamma):
    g = g_init
    out = []
    for t in reversed(range(rewards.shape[0])):
        g_next = torch.where(done[t], torch.zeros_like(g), g)
        G = rewards[t] + gamma * g_next
        g = torch.where(trunc[t], values[t], torch.where(real[t], G, g))
        out.append(G)
    return torch.stack(out[::-1])


def window(policy: ReferencePolicy, sizes: dict, tables: Tables, feats,
           carry: dict, fresh: dict, fresh_n: torch.Tensor, gen,
           sampled: torch.Tensor):
    """One training window.  ``sampled`` (S, W) holds the program's
    actions; the sampled half takes them, the teacher half takes the
    reference's teacher.  Returns (loss, records, new carry)."""
    feat, dfeat, angles = feats
    B = sizes["batch_size"]
    W, S, T = 2 * B, sizes["stream_steps"], sizes["max_action"]
    E = carry["pool"]["instr"].shape[1]
    keep_p = 1.0 - sizes["featdropout"]
    device = feat.device
    slots = torch.arange(W, device=device)
    is_sample = slots >= B
    ml_rows = ~is_sample

    pool_n = carry["pool_n"]
    adm = torch.minimum(fresh_n, E - pool_n)
    avail = pool_n + adm
    idx = torch.arange(E, device=device)

    def region(h):
        from_carry = idx < pool_n[h]
        fi = (idx - pool_n[h]).clamp(0, E - 1)
        out = {}
        for f in FIELDS:
            c = carry["pool"][f][h]
            m = from_carry.reshape((E,) + (1,) * (c.dim() - 1))
            out[f] = torch.where(m, c, fresh[f][h][fi])
        return out

    regions = [region(0), region(1)]
    table = {f: torch.cat([carry["slot_raw"][f], regions[0][f],
                           regions[1][f]]) for f in FIELDS}
    text = policy.encode_text(table["instr"], table["valid"], gen)

    def forward(g, slot_ep, node, view, state, is_first, noise):
        obs = tables.obs(node, view, table["goal"][slot_ep])
        act, f_t, d_t, cand, cand_d = step_features(
            feat, dfeat, angles, obs, sizes["angle_feat_size"])
        valid_e = table["valid"][slot_ep]
        percept = recomputed(
            lambda gp, txt, nz: policy.percept_step(
                txt, valid_e, table["seq_len"][slot_ep],
                StepInputs(act, f_t, d_t, cand, cand_d), nz[:, None, :], gp),
            g, text[slot_ep], noise)
        state, logit, value = policy.decode_from_percept(
            percept, valid_e, state, is_first, g)
        return obs, state, masked_logits(logit, obs["logit_mask"]), value

    slot_ep, alive, age = slots.clone(), carry["alive"], carry["age"]
    node, view, noise = carry["node"], carry["view"], carry["noise"]
    state = DecoderState(carry["h"], carry["c"], carry["h1"])
    cur = torch.zeros(2, dtype=torch.long, device=device)
    grid: Dict[str, list] = {}
    for t in range(S):
        need = ~alive
        take = torch.zeros_like(need)
        took = []
        for h, rows in ((0, ml_rows), (1, is_sample)):
            nh = need & rows
            rank = torch.cumsum(nh.long(), 0) - nh.long()
            take_h = nh & (cur[h] + rank < avail[h])
            newix = (W + h * E + cur[h] + rank).clamp(W + h * E,
                                                      W + (h + 1) * E - 1)
            slot_ep = torch.where(take_h, newix, slot_ep)
            take = take | take_h
            took.append(take_h.sum())
        cur = cur + torch.stack(took)
        node = torch.where(take, table["node0"][slot_ep], node)
        view = torch.where(take, table["view0"][slot_ep], view)
        age = torch.where(take, torch.zeros_like(age), age)
        alive = alive | take
        keep = torch.rand(noise.shape, generator=gen, device=device) < keep_p
        noise = torch.where(take[:, None], keep.float() / keep_p, noise)
        trunc = alive & (age >= T)
        real = alive & ~trunc

        obs, state, masked, value = forward(gen, slot_ep, node, view, state,
                                            take, noise)
        logp = torch.log_softmax(masked, dim=-1)
        own = torch.multinomial(torch.softmax(masked.detach(), -1), 1,
                                generator=gen)[:, 0]
        a = torch.where(is_sample, sampled[t], obs["teacher"])
        a_rec = torch.minimum(a, obs["cand_n"])
        new_node, new_view, stop = tables.step(node, view, a, ~real)
        dist_new = tables.goal_dist(new_node, table["goal"][slot_ep])
        delta = obs["distance"] - dist_new
        move_r = (delta > 0).float() - (delta < 0).float()
        stop_r = torch.where(dist_new < 3.0, 2.0, -2.0)
        done = stop & real
        ce = -logp.gather(1, obs["teacher"][:, None])[:, 0]
        p = logp.exp()
        out = {"reward": torch.where(real, torch.where(done, stop_r, move_r),
                                     0.0),
               "done": done, "trunc": trunc, "real": real,
               "ce": torch.where(real, ce, torch.zeros_like(ce)),
               "logp_a": logp.gather(1, a_rec[:, None])[:, 0],
               "ent": -torch.where(p > 0, p * logp, 0.0).sum(-1),
               "value": value.float(), "refills": torch.stack(took),
               "action": a_rec, "own": torch.minimum(own, obs["cand_n"]),
               "node": node, "uid": table["uid"][slot_ep]}
        for key, val in out.items():
            grid.setdefault(key, []).append(val)
        alive = real & ~stop
        age = torch.where(real, age + 1, age)
        node, view = new_node, new_view
    g = {key: torch.stack(val) for key, val in grid.items()}

    with torch.no_grad():
        _, _, _, v_edge = forward(gen, slot_ep, node, view, state,
                                  torch.zeros_like(alive), noise)
    g_init = torch.where(alive, v_edge.float(), 0.0)
    alive = alive & (age < T)

    n_ml = ((carry["alive"] & ml_rows).sum()
            + g["refills"][:, 0].sum()).float().clamp(min=1.0)
    mlm = (g["real"] & ml_rows).float()
    rlm = (g["real"] & is_sample).float()
    ml_loss = (g["ce"] * mlm).sum()
    loss = sizes["ml_weight"] * ml_loss / n_ml
    G = stream_returns(g["reward"], g["value"], g["done"], g["trunc"],
                       g["real"], g_init, sizes["gamma"])
    adv = (G - g["value"]).detach()
    critic = (0.5 * (G - g["value"]) ** 2 * rlm).sum()
    rl_loss = ((-g["logp_a"] * adv * rlm).sum() + critic
               + (-0.01 * g["ent"] * rlm).sum())
    loss = loss + rl_loss / rlm.sum().clamp(min=1.0)

    def leftover(h):
        ix = (cur[h] + idx).clamp(0, E - 1)
        return {f: regions[h][f][ix] for f in FIELDS}

    lo = [leftover(0), leftover(1)]
    new_carry = {
        "slot_raw": {f: table[f][slot_ep] for f in FIELDS},
        "alive": alive, "age": age, "node": node, "view": view,
        "h": state.h.detach(), "c": state.c.detach(),
        "h1": state.h1.detach(), "noise": noise,
        "pool": {f: torch.stack([lo[0][f], lo[1][f]]) for f in FIELDS},
        "pool_n": avail - cur}
    records = {key: g[key] for key in ("action", "own", "node", "uid",
                                       "real")}
    records["is_sample"] = is_sample
    return loss, records, new_carry


class ReferenceOptimizer:
    """Per-component RMSprop (alpha 0.99, eps 1e-8), the encoder's and
    the decoder's gradients clipped to a global norm of 40 each, the
    warm-up and step-decay multiplier on the decoder, critic and AdaIN."""

    def __init__(self, policy: ReferencePolicy, sizes: dict):
        self.lr = sizes["lr"]
        self.warm, self.decay_start = sizes["warm_steps"], sizes[
            "decay_start"]
        self.decay_int, self.decay = sizes["decay_intervals"], sizes[
            "lr_decay"]
        self.groups = {name: [p for p in getattr(policy, name).parameters()
                              if p.requires_grad] for name in COMPONENTS}
        self.sq = {id(p): torch.zeros_like(p) for ps in self.groups.values()
                   for p in ps}
        self.iteration = 0

    def _mult(self, it: int) -> float:
        if self.warm > 0 and it < self.warm:
            return (1.0 + it) / self.warm
        if it < self.decay_start:
            return 1.0
        return self.decay ** ((it - self.decay_start) // self.decay_int)

    @torch.no_grad()
    def step(self) -> Dict[int, torch.Tensor]:
        """Apply the gradients; returns each parameter's gradient as the
        update took it (after clipping)."""
        taken = {}
        for name, params in self.groups.items():
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            if name in CLIPPED:
                norm = torch.linalg.vector_norm(torch.stack(
                    [torch.linalg.vector_norm(g) for g in grads]))
                scale = (CLIP_NORM / norm).clamp(max=1.0)
                grads = [g * scale for g in grads]
            lr = self.lr * (self._mult(self.iteration) if name in SCHEDULED
                            else 1.0)
            for p, g in zip(params, grads):
                sq = self.sq[id(p)]
                sq.mul_(RMS_ALPHA).addcmul_(g, g, value=1.0 - RMS_ALPHA)
                p.addcdiv_(g, sq.sqrt().add_(RMS_EPS), value=-lr)
                taken[id(p)] = g
                p.grad = None
        self.iteration += 1
        return taken


def gap(prog: float, ref: float, floor: float) -> float:
    """|program - reference| against the larger of |reference| and the
    floor."""
    return abs(prog - ref) / max(abs(ref), floor, 1e-30)


def median(values) -> float:
    vals = sorted(values)
    return vals[len(vals) // 2] if vals else 0.0
