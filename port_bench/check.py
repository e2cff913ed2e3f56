"""What decides ``correct``: the reference follows the program's first
training windows and the two are compared.

``reference_run`` works the windows out again in float32 (or, for the
control, with every weight product rounded to fp8) from the benchmark's
inputs, taking from the program only the episodes each window's chunk
staged and the sampled half's actions.  ``compare`` turns a program's (or
the control's) readings and the reference's into the numbers each limit
holds:

- ``loss_gap``: the largest relative gap of a window's loss;
- ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient as the optimizer took it, against the larger of the
  reference's norm of that leaf and of the median leaf;
- ``change_gap``: the same of the parameters' change after the windows;
- ``sample_disagree``: the share of the sampled half's live rows whose
  action differs from the reference's own draw with the same noise;
- ``trajectory_mismatch``: live rows whose episode, node or teacher
  action differs from the reference's (exact: limit 0).

Leaves whose reference gradient is under a thousandth of the median
nonzero leaf's (the frozen BERT, which the optimizer steps with zero
gradients) are left out of both gaps by that rule.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np
import torch

from port_bench import data
from port_bench.reference.layers import fp8_matmuls
from port_bench.reference.policy import ReferencePolicy
from port_bench.reference.stream import (
    Episodes,
    ReferenceOptimizer,
    gap,
    init_carry,
    median,
    pool_rows,
    rollout_seed,
    window,
)
from port_bench.reference.world import Tables, all_point_angles

LEAF_FLOOR = 1e-3


def load_items(task: dict, traffic: dict) -> List[dict]:
    with open(task["items_file"]) as f:
        items = json.load(f)
    return data.ndh_to_r2r(items) if traffic["task"] == "ndh" else items


def reference_run(sizes: dict, task: dict, traffic: dict, seeds: dict,
                  staged: List, actions: List[np.ndarray], device,
                  fp8: bool = False) -> dict:
    """The reference's readings over the checked windows: losses, each
    leaf's first gradient norm and change norm, its own sampled draws,
    and its records."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    items = load_items(task, traffic)
    tables = Tables(task["connectivity"], task["scans"],
                    task["feature_ids"], sizes["max_candidates"], device)
    episodes = Episodes(items, task["vocab"], tables, sizes["max_input"])
    mean_len = float(np.mean([len(it["path"]) for it in items]))
    B, S = sizes["batch_size"], sizes["stream_steps"]
    E = pool_rows(B, S, mean_len, sizes.get("stream_pool", 0))
    feat, dfeat = data.feature_tables(
        len(task["feature_ids"]), 36, sizes["feature_size"],
        seeds["features"], device, seeds["table_dtype"])
    angles = all_point_angles(sizes["angle_feat_size"], device)
    policy = ReferencePolicy(sizes).to(device)
    shapes = {k: tuple(v.shape) for k, v in policy.state_dict().items()}
    policy.load_state_dict(data.weights(shapes, seeds["weights"], device))
    p0 = {k: v.detach().clone() for k, v in policy.named_parameters()}
    opt = ReferenceOptimizer(policy, sizes)
    names = {id(p): k for k, p in policy.named_parameters()}
    carry = init_carry(2 * B, E, sizes["d_hidden_size"],
                       sizes["feature_size"], sizes["max_input"], device)
    losses, grads, recs = [], {}, []
    for k, chunk in enumerate(staged):
        gen = torch.Generator(device=device)
        gen.manual_seed(rollout_seed(seeds["rollout"], k))
        fresh = episodes.chunk(chunk, E, sizes["max_input"], device)
        fresh_n = torch.tensor([len(chunk[0]), len(chunk[1])],
                               device=device)
        sampled = torch.as_tensor(actions[k], device=device).long()
        if fp8:
            with fp8_matmuls():
                loss, rec, carry = window(policy, sizes, tables,
                                          (feat, dfeat, angles), carry,
                                          fresh, fresh_n, gen, sampled)
                loss.backward()
        else:
            loss, rec, carry = window(policy, sizes, tables,
                                      (feat, dfeat, angles), carry, fresh,
                                      fresh_n, gen, sampled)
            loss.backward()
        losses.append(float(loss.detach()))
        taken = opt.step()
        if k == 0:
            grads = {names[i]: float(torch.linalg.vector_norm(g))
                     for i, g in taken.items()}
        recs.append({key: val.cpu().numpy() for key, val in rec.items()})
        del loss
    changes = {k: float(torch.linalg.vector_norm(p.detach() - p0[k]))
               for k, p in policy.named_parameters() if k in grads}
    return {"losses": losses, "grads": grads, "changes": changes,
            "records": recs}


def as_program(readings: dict) -> dict:
    """A reference run's readings in the program's shape, for the control
    put in the program's place: its own draws in the sampled half."""
    recs = []
    for r in readings["records"]:
        recs.append({"rec_action": np.where(r["is_sample"][None, :],
                                            r["own"], r["action"]),
                     "rec_uid": r["uid"], "rec_node": r["node"],
                     "rec_real": r["real"]})
    return dict(readings, records=recs)


def leaf_set(ref_grads: Dict[str, float]):
    nonzero = [v for v in ref_grads.values() if v > 0.0]
    med = median(nonzero)
    return [k for k, v in ref_grads.items() if v >= LEAF_FLOOR * med], med


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers the limits hold (see the module docstring).  ``prog``
    holds the program's losses, grads and changes by leaf, and its
    records (``rec_action``, ``rec_uid``, ``rec_node``, ``rec_real``)."""
    out = {}
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError("the two sides ran different numbers of windows")
    out["loss_gap"] = max(gap(p, r, 0.0) for p, r in
                          zip(prog["losses"], ref["losses"]))
    leaves, med = leaf_set(ref["grads"])
    missing = [k for k in leaves if k not in prog["grads"]]
    if missing:
        raise KeyError(f"the program has no leaves {missing[:3]}")
    out["grad_gap"] = max(gap(prog["grads"][k], ref["grads"][k], med)
                          for k in leaves)
    cmed = median([ref["changes"][k] for k in leaves])
    out["change_gap"] = max(gap(prog["changes"][k], ref["changes"][k], cmed)
                            for k in leaves)
    disagree = total = mismatch = 0
    for pr, rr in zip(prog["records"], ref["records"]):
        real = rr["real"]
        if pr["rec_action"].shape != rr["action"].shape:
            mismatch += int(real.sum()) or 1
            continue
        sample = real & rr["is_sample"][None, :]
        teach = real & ~rr["is_sample"][None, :]
        total += int(sample.sum())
        disagree += int((sample & (pr["rec_action"] != rr["own"])).sum())
        mismatch += int((real & (pr["rec_uid"] != rr["uid"])).sum())
        mismatch += int((real & (pr["rec_node"] != rr["node"])).sum())
        mismatch += int((teach & (pr["rec_action"] != rr["action"])).sum())
        mismatch += int((real != pr["rec_real"]).sum())
    out["sample_disagree"] = disagree / max(total, 1)
    out["trajectory_mismatch"] = float(mismatch)
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]): every number at most its limit
    and finite."""
    rows = [(k, numbers[k], limits[k]) for k in limits]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows


def load_limits(root: str, workload: str) -> Dict[str, float]:
    with open(os.path.join(root, "port_bench", "limits",
                           f"{workload}.json")) as f:
        return json.load(f)["limits"]
