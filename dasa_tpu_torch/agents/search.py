"""Search inference with speaker rescoring: Dijkstra ("beam") search and
the speaker-follower's state-factored search.

Counterpart of ``dasa_tpu/agents/search.py`` (reference agent_dg.py:
1038-1325, train.py:424-517; tasks/R2R/speaker/follower.py:720-999).  The
search expands, per episode, the best-scoring (sum of action
log-probabilities) unexpanded state; one batched policy step on the
device scores every episode's frontier state at once, after the host env
has teleported each episode there.  Paths keep index records (feature
row, view, the chosen candidate's geometry), and the speaker's rescoring
gathers their features on the device, one path at a time.

Kernel routing: a search step is a single forward with no replay to stay
consistent with, so the listener's encoder LSTMs (in the text encode and
in the step) take their kernel (K1) unless ``use_pallas="never"`` (the
agent's ``_lstm_kernel``, as in its device evaluation), and under
``always`` the AdaIN gate (K3) and the shift attention (K4) run theirs.  The speaker's rescoring runs its
BiLSTMs through K1 at one row (``SpeakerAgent.score_instruction``).
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Tuple

import numpy as np
import torch

from dasa_tpu_torch.agents.seq2seq import Seq2SeqAgent, make_step_inputs
from dasa_tpu_torch.models.layers import NEG_INF
from dasa_tpu_torch.models.policy import DecoderState, decoder_state_width
from dasa_tpu_torch.utils.angles import (
    ELEVATION_INC,
    HEADING_COUNT,
    HEADING_INC,
)

START_ACTION = -95  # sentinel of the root state (agent_dg.py:1096)
STOP_ACTION = -1


def _view_pose(view_index: int) -> Tuple[float, float]:
    return ((view_index % HEADING_COUNT) * HEADING_INC,
            (view_index // HEADING_COUNT - 1) * ELEVATION_INC)


def _begin(agent: Seq2SeqAgent):
    """Reset the env to its next minibatch: the observation, the
    instruction tensors, the cached text encoding, the result skeletons
    and the root decoder state (zeros)."""
    env = agent.env
    obs = env.reset()
    put = agent._put
    instr, valid = put(obs.instr).long(), put(~obs.pad_mask)
    seq_len = put(obs.seq_len).long()
    with torch.no_grad():
        cached = agent.policy.encode_text(instr, valid, seq_len,
                                          agent._lstm_kernel)
    start_vps = env.current_viewpoints()
    results = [{
        "scan": env.batch[i]["scan"],
        "instr_id": env.batch[i]["instr_id"],
        "instr_encoding": np.asarray(obs.instr[i]),
        "dijk_path": [start_vps[i]],
        "paths": [],
    } for i in range(obs.batch_size())]
    zero = (np.zeros(decoder_state_width(agent.cfg), np.float32),) * 3
    return obs, (cached, valid, seq_len), start_vps, results, zero


@torch.no_grad()
def _search_step(agent: Seq2SeqAgent, text, running, is_first, obs):
    """One batched policy step over the frontier (``_search_fn``,
    search.py:34-51): each row's running decoder state (h, c, h1) and
    ``is_first`` at the pose the env was teleported to; the masked
    log-softmax over the candidate slots.  Returns (new states (3, B, H),
    log-probabilities (B, K)) on the host, f32."""
    cached, valid, seq_len = text
    state = DecoderState(*(
        torch.as_tensor(np.stack([r[k] for r in running])).to(
            agent.device, agent.dtype) for k in range(3)))
    sobs = agent._to_sobs(obs, np.zeros(len(running), bool), None, False)
    sobs["is_first"] = np.asarray(is_first, bool)
    sobs = agent._put_sobs(sobs)
    new_state, logit, _value, _aux = agent.policy.policy_step(
        cached, valid, seq_len, make_step_inputs(agent.cfg, agent.tables,
                                                 sobs),
        state, sobs["is_first"], lstm_kernel=agent._lstm_kernel)
    masked = logit.float().masked_fill(sobs["logit_mask"], NEG_INF)
    out = torch.cat([torch.stack(new_state, dim=1).float().flatten(1),
                     torch.log_softmax(masked, dim=-1)], dim=1).cpu().numpy()
    width = new_state.h.shape[1]
    return (out[:, :3 * width].reshape(len(running), 3, width)
            .transpose(1, 0, 2), out[:, 3 * width:])


def _record(obs, i: int, j: int, n: int) -> dict:
    """The index record of taking slot ``j`` (STOP when j == n) at row
    ``i``'s pose, as the speaker reads it."""
    has = j < n
    return {
        "feat_row": int(obs.feat_row[i]),
        "view_index": int(obs.view_index[i]),
        "cand_point_id": int(obs.cand_point_id[i, j]) if has else 0,
        "cand_heading": float(obs.cand_heading[i, j]) if has else 0.0,
        "cand_elevation": float(obs.cand_elevation[i, j]) if has else 0.0,
        "has_cand": has,
    }


def _stitch(env, result: dict, vp: str) -> None:
    """Extend the exploration path to ``vp`` by a shortest path (the
    reference stitches through an incremental Floyd graph; full shortest
    paths give the same or shorter connectors)."""
    g = env.graphs[result["scan"]]
    last = result["dijk_path"][-1]
    if last != vp:
        hop = g.shortest_path(g.id2ix[last], g.id2ix[vp])
        result["dijk_path"].extend(g.ids[n] for n in hop[1:])


def dijkstra_search(agent: Seq2SeqAgent, n_candidates: int = 1,
                    max_expansions: int = 300) -> List[dict]:
    """Exact top-``n_candidates`` min-neg-log-prob paths per episode
    (``dijkstra_search``, search.py:54-232): states keyed by (viewpoint,
    arriving slot); each round pops every episode's best unvisited state
    and expands it by one batched policy step."""
    env = agent.env
    obs, text, start_vps, results, zero_state = _begin(agent)
    batch = obs.batch_size()

    def sid(viewpoint, action):
        return f"{viewpoint}_{action}"

    id2state: List[Dict[str, dict]] = [{
        sid(start_vps[i], START_ACTION): {
            "next_viewpoint": start_vps[i],
            "view_index": int(obs.view_index[i]),
            "running_state": zero_state,
            "is_first": True,
            "from": None,
            "score": 0.0,
            "scores": [],
            "actions": [],
            "record": None,
        }} for i in range(batch)]
    visited = [set() for _ in range(batch)]
    finished = [set() for _ in range(batch)]
    ended = np.zeros(batch, bool)

    for _ in range(max_expansions):
        frontier = []
        for i in range(batch):
            if ended[i]:
                frontier.append(next(iter(id2state[i].items())))
                continue
            best = max(((k, s) for k, s in id2state[i].items()
                        if k not in visited[i]),
                       key=lambda kv: kv[1]["score"])
            frontier.append(best)
            visited[i].add(best[0])
            if int(best[0].rsplit("_", 1)[1]) == STOP_ACTION:
                finished[i].add(best[0])
                if len(finished[i]) >= n_candidates:
                    ended[i] = True

        for i, (_state_id, st) in enumerate(frontier):
            obs = env.teleport(i, st["next_viewpoint"], st["view_index"])
        new_states, log_probs = _search_step(
            agent, text, [f[1]["running_state"] for f in frontier],
            [f[1]["is_first"] for f in frontier], obs)
        vps = env.current_viewpoints()

        for i in range(batch):
            state_id, cur = frontier[i]
            if int(state_id.rsplit("_", 1)[1]) == STOP_ACTION or ended[i]:
                continue
            vp = vps[i]
            _stitch(env, results[i], vp)
            g = env.graphs[results[i]["scan"]]
            n = int(obs.cand_n[i])
            run_state = (new_states[0, i], new_states[1, i],
                         new_states[2, i])
            for j in range(n + 1):
                lp = float(log_probs[i, j])
                new_score = cur["score"] + lp
                if j < n:
                    nxt_vp = g.ids[int(obs.cand_nbr_ix[i, j])]
                    next_id = sid(vp, j)
                    view = int(obs.cand_point_id[i, j])
                else:
                    nxt_vp, next_id = vp, sid(vp, STOP_ACTION)
                    view = int(obs.view_index[i])
                old = id2state[i].get(next_id)
                if old is None or new_score > old["score"]:
                    id2state[i][next_id] = {
                        "next_viewpoint": nxt_vp,
                        "view_index": view,
                        "running_state": run_state,
                        "is_first": False,
                        "from": state_id,
                        "score": new_score,
                        "scores": cur["scores"] + [lp],
                        "actions": cur["actions"] + [n + 1],
                        "record": _record(obs, i, j, n),
                    }
            if len(visited[i]) == len(id2state[i]):
                ended[i] = True
        if ended.all():
            break

    for i in range(batch):  # walk back to the start: close the loop
        _stitch(env, results[i], results[i]["dijk_path"][0])

    for i, result in enumerate(results):  # the from-chains
        for state_id in finished[i]:
            path = {"trajectory": [], "action": [], "records": [],
                    "listener_scores": id2state[i][state_id]["scores"],
                    "listener_actions": id2state[i][state_id]["actions"]}
            cur_id = state_id
            while True:
                st = id2state[i][cur_id]
                path["trajectory"].append(
                    (st["next_viewpoint"], *_view_pose(st["view_index"])))
                action = int(cur_id.rsplit("_", 1)[1])
                if action == START_ACTION:
                    break
                path["action"].append(action)
                path["records"].append(st["record"])
                cur_id = st["from"]
            for key in ("trajectory", "action", "records"):
                path[key] = path[key][::-1]
            result["paths"].append(path)
    return results


def state_factored_search(agent: Seq2SeqAgent, completion_size: int = 1,
                          successor_size: int = 4,
                          max_expansions: int = 80) -> List[dict]:
    """Physical-state-factored best-first search
    (``state_factored_search``, search.py:235-501; the speaker-follower's
    follower.py:720-980): at most one inference state per pose
    (viewpoint, view index), the best-scoring path that reaches it; each
    round expands the top ``successor_size`` unexpanded poses per episode,
    one batched policy step per beam rank; a successor that stops (or
    reaches ``max_action`` steps) waits in a holding pool and completes
    when it is selected over the open frontier.  Ends once every episode
    holds ``completion_size`` completions or its frontier is empty.  The
    output is :func:`dijkstra_search`'s."""
    env = agent.env
    cfg = agent.cfg
    obs, text, start_vps, results, zero_state = _begin(agent)
    batch = obs.batch_size()

    roots = [{
        "next_viewpoint": start_vps[i],
        "view_index": int(obs.view_index[i]),
        "running_state": zero_state,
        "is_first": True,
        "parent": None,
        "action": START_ACTION,
        "lp": 0.0,
        "n_actions": 0,
        "score": 0.0,
        "count": 0,
        "record": None,
    } for i in range(batch)]

    def key_of(st):
        return (st["next_viewpoint"], st["view_index"])

    # per episode: pose -> [state, expanded?]  (follower.py:738-747)
    cache = [{key_of(roots[i]): [roots[i], True]} for i in range(batch)]
    holding: List[Dict[tuple, list]] = [{} for _ in range(batch)]
    completed: List[Dict[tuple, dict]] = [{} for _ in range(batch)]
    beams: List[List[dict]] = [[roots[i]] for i in range(batch)]

    for _ in range(max_expansions):
        if all(len(completed[i]) >= completion_size or not beams[i]
               for i in range(batch)):
            break
        width = max(len(b) for b in beams)
        for s in range(width):
            rows = [beams[i][s] if s < len(beams[i]) else None
                    for i in range(batch)]
            if all(r is None for r in rows):
                continue
            for i, st in enumerate(rows):
                if st is None:
                    # a padding row (a beam shorter than this rank): the
                    # env stays where it was and the row's outputs are
                    # discarded
                    continue
                obs = env.teleport(i, st["next_viewpoint"],
                                   st["view_index"])
                # the exploration path grows where a state is expanded
                # (follower.py update_traversed_lists)
                _stitch(env, results[i], st["next_viewpoint"])
            cur_rows = [rows[i] or roots[i] for i in range(batch)]
            new_states, log_probs = _search_step(
                agent, text, [r["running_state"] for r in cur_rows],
                [r["is_first"] for r in cur_rows], obs)

            for i in range(batch):
                cur = rows[i]
                if cur is None:
                    continue
                g = env.graphs[results[i]["scan"]]
                vp = cur["next_viewpoint"]
                n = int(obs.cand_n[i])
                run_state = (new_states[0, i], new_states[1, i],
                             new_states[2, i])
                for j in range(n + 1):
                    lp = float(log_probs[i, j])
                    count = cur["count"] + 1
                    stop = j >= n
                    if stop:
                        nxt_vp, view = vp, int(obs.view_index[i])
                    else:
                        nxt_vp = g.ids[int(obs.cand_nbr_ix[i, j])]
                        view = int(obs.cand_point_id[i, j])
                    succ = {
                        "next_viewpoint": nxt_vp,
                        "view_index": view,
                        "running_state": run_state,
                        "is_first": False,
                        "parent": cur,
                        "action": STOP_ACTION if stop else j,
                        "lp": lp,
                        "n_actions": n + 1,
                        "score": cur["score"] + lp,
                        "count": count,
                        "record": _record(obs, i, j, n),
                    }
                    pool = (holding[i] if stop or count >= cfg.max_action
                            else cache[i])
                    old = pool.get(key_of(succ))
                    if old is None or succ["score"] > old[0]["score"]:
                        pool[key_of(succ)] = [succ, False]

        # the next frontier: the best unexpanded poses across the open
        # cache and the holding pool (follower.py:902-931)
        for i in range(batch):
            if len(completed[i]) >= completion_size:
                beams[i] = []
                continue
            consider = ([(k, v, False) for k, v in cache[i].items()
                         if not v[1]]
                        + [(k, v, True) for k, v in holding[i].items()
                           if not v[1]])
            consider.sort(key=lambda kvh: kvh[1][0]["score"], reverse=True)
            new_beam = []
            for k, v, held in consider[:successor_size]:
                v[1] = True
                if held:
                    old = completed[i].get(k)
                    if old is None or v[0]["score"] > old["score"]:
                        completed[i][k] = v[0]
                else:
                    new_beam.append(v[0])
            beams[i] = ([] if len(completed[i]) >= completion_size
                        else new_beam)

    # a budget that ran out before a STOP: the best held (or frontier)
    # state becomes the episode's path, with a warning, where the
    # reference would have searched on
    exhausted = [
        i for i in range(batch)
        if len(completed[i]) < completion_size
        and (beams[i]
             or any(not v[1] for v in cache[i].values())
             or any(not v[1] for v in holding[i].values()))]
    for i in range(batch):
        if not completed[i]:
            pool = holding[i] or cache[i]
            k, v = max(pool.items(), key=lambda kv: kv[1][0]["score"])
            completed[i][k] = v[0]
    if exhausted:
        warnings.warn(
            f"state_factored_search: {len(exhausted)}/{batch} episodes "
            f"exhausted max_expansions={max_expansions} before holding "
            f"{completion_size} completions (best-effort states "
            f"emitted); raise max_expansions", stacklevel=2)

    for i, result in enumerate(results):
        final = sorted(completed[i].values(), key=lambda s: s["score"],
                       reverse=True)[:completion_size]
        # the exploration path reaches each completion, then closes at
        # the start (the reference's ends at the last completion; the
        # closing stitch keeps dijkstra_search's output contract)
        for st in final:
            _stitch(env, result, st["next_viewpoint"])
        _stitch(env, result, result["dijk_path"][0])
        for st in final:
            path = {"trajectory": [], "action": [], "records": [],
                    "listener_scores": [], "listener_actions": []}
            cur = st
            while cur is not None:
                path["trajectory"].append(
                    (cur["next_viewpoint"], *_view_pose(cur["view_index"])))
                if cur["parent"] is None:
                    break
                path["action"].append(cur["action"])
                path["records"].append(cur["record"])
                path["listener_scores"].append(cur["lp"])
                path["listener_actions"].append(cur["n_actions"])
                cur = cur["parent"]
            for k in path:
                path[k] = path[k][::-1]
            result["paths"].append(path)
    return results


def _speaker_rescore(results: List[dict], speaker) -> List[dict]:
    """Score each candidate path with the speaker (agent_dg.py:1251-1310):
    the negated per-word CE of the episode's instruction given the path,
    one path (one row) a call."""
    for result in results:
        for path in result["paths"]:
            recs = path.pop("records")
            if not recs:
                path["speaker_scores"] = np.zeros(0, np.float32)
                continue
            stacked = {k: np.asarray([r[k] for r in recs])[None]
                       for k in recs[0]}
            inst = np.asarray(result["instr_encoding"])[None]
            path["speaker_scores"] = -speaker.score_instruction(stacked,
                                                                inst)[0]
    return results


def beam_search(agent: Seq2SeqAgent, speaker,
                n_candidates: int = 1) -> List[dict]:
    """Dijkstra search + speaker rescoring (agent_dg.py:1251-1310)."""
    return _speaker_rescore(dijkstra_search(agent, n_candidates), speaker)


def beam_search_test(agent: Seq2SeqAgent, speaker,
                     n_candidates: int = 1) -> Dict[str, dict]:
    """Search every item once (agent_dg.py:1312-1325)."""
    agent.results = {}
    env = agent.env
    env.reset_epoch()
    for _ in range(env.size() // env.batch_size + 2):
        for traj in beam_search(agent, speaker, n_candidates):
            agent.results.setdefault(traj["instr_id"], traj)
        if len(agent.results) >= env.size():
            break
    return agent.results


def state_factored_search_test(agent: Seq2SeqAgent, speaker,
                               completion_size: int = 1,
                               successor_size: int = 4,
                               max_expansions: int = 80
                               ) -> Dict[str, dict]:
    """State-factored search + speaker rescoring over every item
    (follower.py:987-999, test with beam_size > 1)."""
    agent.results = {}
    env = agent.env
    env.reset_epoch()
    for _ in range(env.size() // env.batch_size + 2):
        results = _speaker_rescore(
            state_factored_search(agent, completion_size, successor_size,
                                  max_expansions=max_expansions),
            speaker)
        for traj in results:
            agent.results.setdefault(traj["instr_id"], traj)
        if len(agent.results) >= env.size():
            break
    return agent.results


def cal_score(path: dict, alpha: float, avg_speaker: bool,
              avg_listener: bool) -> float:
    """Score mixing (train.py:442-451)."""
    sp = float(np.sum(path["speaker_scores"])) * alpha
    if avg_speaker and len(path["speaker_scores"]):
        sp /= len(path["speaker_scores"])
    li = float(np.sum(path["listener_scores"])) * (1 - alpha)
    if avg_listener and len(path["listener_scores"]):
        li /= len(path["listener_scores"])
    return sp + li
