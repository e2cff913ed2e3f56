"""The rank processes of tests/test_torch_parallel.py: two gloo ranks on
the CPU, started with ``torch.multiprocessing``.

``run(rank, spec)`` sets torchrun's launcher variables for its rank, joins
the job over gloo through ``dasa_tpu_torch.parallel.distributed.initialize``
(the trainer's ``make_mesh_if_requested`` then finds the group), runs the
spec's configuration and writes what it measured to ``{out}/rank{rank}.pt``.
Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

import dasa_tpu_torch.models.policy as port_policy
import dasa_tpu_torch.pretrain.trainer as port_trainer
from dasa_tpu_torch.agents import Seq2SeqAgent
from dasa_tpu_torch.config import Config
from dasa_tpu_torch.data.datasets import expand_instructions, load_datasets
from dasa_tpu_torch.data.features import FeatureDB
from dasa_tpu_torch.env import R2REnv
from dasa_tpu_torch.parallel.distributed import initialize, shutdown
from dasa_tpu_torch.train.trainer import make_mesh_if_requested
from dasa_tpu_torch.utils import Tokenizer, read_vocab


def run(rank: int, spec: dict) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost",
                      MASTER_PORT=str(spec["port"]))
    torch.set_num_threads(1)
    initialize(backend="gloo")
    for mod in (port_policy, port_trainer):
        base = mod.bert_config_from
        mod.bert_config_from = (lambda cfg, base=base: dataclasses.replace(
            base(cfg), **spec["narrow"]))
    out = KINDS[spec["kind"]](rank, spec)
    torch.save(out, os.path.join(spec["out"], f"rank{rank}.pt"))
    shutdown()


def _world(spec: dict, split: str = "train", batch_size=None):
    conn, data = spec["conn"], spec["data"]
    tok = Tokenizer(read_vocab(spec["vocab"]),
                    encoding_length=spec["cfg"]["max_input"])
    items = expand_instructions(load_datasets([split], data), tok,
                                max_input=spec["cfg"]["max_input"])
    feat = FeatureDB.synthetic(spec["scans"], conn, dim=spec["dim"])
    depth = FeatureDB.synthetic(spec["scans"], conn, dim=spec["dim"], salt=7)
    env = R2REnv(feat, items,
                 batch_size=batch_size or spec["cfg"]["batch_size"],
                 connectivity_dir=conn, max_candidates=16,
                 max_input=spec["cfg"]["max_input"], depth_db=depth, name=split)
    return env, feat, depth


def _agent(spec: dict, **overrides) -> Seq2SeqAgent:
    cfg = Config(**{**spec["cfg"], **overrides}, data_parallel=True,
                 connectivity_dir=spec["conn"], data_dir=spec["data"])
    env, feat, depth = _world(spec, batch_size=cfg.batch_size)
    agent = Seq2SeqAgent(cfg, env, feat, depth_db=depth, device="cpu",
                         mesh=make_mesh_if_requested(cfg))
    agent.policy.load_state_dict(torch.load(spec["weights"]))
    return agent


def _grads(agent) -> dict:
    return {n: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
            for n, p in agent.policy.named_parameters()}


def _stepped(agent) -> dict:
    """``optim_step``, with the gradients it applies (after the
    all-reduce) captured."""
    captured = {}
    step = agent.optimizer.step

    def spy():
        captured.update(_grads(agent))
        step()

    agent.optimizer.step = spy
    agent.optim_step()
    del agent.optimizer.step
    return captured


def episodic(rank: int, spec: dict) -> dict:
    """The teacher + fused argmax pair and ``optim_step``; the host act /
    replay pair and its step; the device pair at a batch the ranks do not
    divide (``odd``: every rank runs all of it); a rank-0 ``save`` and a
    ``load`` of it; argmax ``test()``."""
    noise = torch.as_tensor(spec["noise"])
    out, agents = {}, {}
    for mode in ("device", "host", "odd"):
        agent = agents[mode] = _agent(
            spec, device_rollout="never" if mode == "host" else "auto",
            **({"batch_size": spec["odd_batch"]} if mode == "odd" else {}))
        run_pass = agent.rollout if mode == "host" else agent.device_rollout
        agent.zero_grad()
        run_pass(train_ml=0.2, train_rl=False, feedback="teacher",
                 env_noise=noise)
        run_pass(train_ml=0.2, train_rl=True, feedback="argmax",
                 env_noise=noise)
        grads = _stepped(agent)
        out[mode] = {
            "losses": [float(x) for x in agent.losses],
            "env_steps": [int(x) for x in agent._env_steps_log],
            "total": [float(x) for x in agent.logs["total"]],
            "grads": grads,
            "params": {k: v.clone() for k, v in
                       agent.policy.state_dict().items()}}
    agent = agents["device"]
    # rank 0 writes: each rank names its own file, and both load rank 0's
    agent.save(1, os.path.join(spec["out"], f"ckpt_rank{rank}"))
    agents["host"].load(os.path.join(spec["out"], "ckpt_rank0"))
    out["loaded"] = {k: v.clone() for k, v in
                     agents["host"].policy.state_dict().items()}
    agent.env = _world(spec, "val_unseen")[0]
    out["test"] = {r["instr_id"]: r["trajectory"]
                   for r in agent.test(feedback="argmax")}
    return out


def stream(rank: int, spec: dict) -> dict:
    """Recorded stream windows with argmax feedback: each window's slot-time
    grids, counters, logs and summed gradients; then the streamed argmax
    ``test()``."""
    agent = _agent(spec)
    st = agent._stream_host()
    windows = []
    for _ in range(spec["windows"]):
        agent.zero_grad()
        agent.device_rollout_stream(0.2, feedback="argmax", record=True)
        agent._dp.all_reduce_grads(agent.policy.parameters())
        windows.append({
            "rec": {k: v.numpy().copy() for k, v in st.records[-1].items()},
            "flow": st.inflight[-1][1].read(),
            "sent": [[len(st.inflight[-1][0][h][d]) for d in range(2)]
                     for h in (0, 1)],
            "logs": {k: float(agent.logs[k][-1]) for k in spec["log_keys"]},
            "grads": _grads(agent)})
    agent.env = _world(spec, "val_unseen")[0]
    return {"windows": windows, "geom": (st.geom.B, st.geom.W, st.geom.S,
                                         st.geom.E, st.geom.D),
            "test": {r["instr_id"]: r["trajectory"]
                     for r in agent.test(feedback="argmax")}}


def pretrain(rank: int, spec: dict) -> dict:
    """Two ``Pretrainer.train_step``s on this rank's rows, then a rank-0
    ``save``; then two steps at a batch the ranks do not divide
    (``odd``: every rank steps all of it), dropout on."""
    cfg = Config(**spec["cfg"])
    mesh = make_mesh_if_requested(cfg.replace(data_parallel=True))
    feat = FeatureDB.synthetic(spec["scans"], spec["conn"], dim=spec["dim"])
    pt = port_trainer.Pretrainer(cfg, feat, spec["vocab_size"], device="cpu",
                                 mesh=mesh)
    pt.model.load_state_dict(torch.load(spec["weights"]))
    batches = torch.load(spec["batches"], weights_only=False)
    steps = [pt.train_step({k: np.asarray(v) for k, v in b.items()})
             for b in batches]
    pt.save(os.path.join(spec["out"], f"pretrain_rank{rank}"))
    narrow = port_trainer.bert_config_from
    port_trainer.bert_config_from = lambda c: dataclasses.replace(
        narrow(c), **spec["odd_dropout"])
    odd = port_trainer.Pretrainer(cfg.replace(batch_size=spec["odd_batch"]),
                                  feat, spec["vocab_size"], device="cpu",
                                  mesh=mesh)
    odd.model.load_state_dict(torch.load(spec["weights"]))
    odd_steps = [odd.train_step({k: np.asarray(v)[:spec["odd_batch"]]
                                 for k, v in b.items()}) for b in batches]
    return {"steps": steps,
            "params": {k: v.clone() for k, v in pt.model.state_dict().items()},
            "odd_steps": odd_steps,
            "odd_params": {k: v.clone()
                           for k, v in odd.model.state_dict().items()}}


KINDS = {"episodic": episodic, "stream": stream, "pretrain": pretrain}
