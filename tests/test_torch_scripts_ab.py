"""The port's ``stream_quality_ab`` against the JAX package's
``scripts/stream_quality_ab.py``, both under ``--fast`` (tiny, f32, Adam,
the CPU) on a synthetic 2-scan world with a 64-wide BERT on both sides:
both regimes reach both milestones, and the JSON's keys, milestones, runs,
schedules and row structure equal the JAX script's, as do the table's
header and shape.  SR is not compared: the JAX ``--fast`` draws threefry
dropout streams that torch does not reproduce.  (The other scripts:
tests/test_torch_scripts.py.)
"""

import dataclasses
import json
import os
import sys

import pytest

import dasa_tpu.models.policy as jax_policy
import dasa_tpu_torch.models.policy as port_policy
from dasa_tpu_torch.data.datasets import load_datasets, make_synthetic_task
from dasa_tpu_torch.scripts import stream_quality_ab
from dasa_tpu_torch.testing import torch_threads, write_synthetic_connectivity
from dasa_tpu_torch.utils import build_vocab, write_vocab

SCANS = ("synthA", "synthB")
NARROW = dict(hidden_size=64, num_attention_heads=2, intermediate_size=128)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(autouse=True, scope="module")
def narrow_bert():
    """The 64-wide BERT on both sides (flax re-reads it at every apply)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_policy, port_policy):
            base = mod.bert_config_from
            mp.setattr(mod, "bert_config_from",
                       lambda cfg, base=base: dataclasses.replace(
                           base(cfg), **NARROW))
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_scripts_ab_world")
    conn, data = str(root / "connectivity"), str(root / "task")
    write_synthetic_connectivity(conn, SCANS, n_nodes=24, seed=0)
    make_synthetic_task(data, SCANS[:1], SCANS[1:], n_train=8, n_val=4,
                        connectivity_dir=conn)
    write_vocab(build_vocab(load_datasets(["train"], data), min_count=1),
                os.path.join(data, "train_vocab.txt"))
    return dict(conn=conn, data=data)


def outputs(capsys, fn, *args):
    capsys.readouterr()
    result = fn(*args)
    return result, capsys.readouterr().out


def run_jax(monkeypatch, argv):
    """``scripts/stream_quality_ab.py``'s main with ``sys.argv`` set, as
    tests/test_scripts.py runs the scripts."""
    from scripts.stream_quality_ab import main

    monkeypatch.setattr(sys, "argv", ["stream_quality_ab.py", *argv])
    return main()


def structure(value):
    """The JSON's shape: its keys and list lengths, numbers as one kind."""
    if isinstance(value, dict):
        return {k: structure(v) for k, v in value.items()}
    if isinstance(value, list):
        return [structure(v) for v in value]
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return "number"
    return type(value).__name__


def test_stream_quality_ab_fast_matches_jax_structure(world, tmp_path,
                                                      monkeypatch, capsys):
    """The port runs both regimes; the JAX script the stream regime (its
    compiles take most of a minute a regime on the CPU), whose run has the
    structure every run has."""
    monkeypatch.setenv("DASA_CONNECTIVITY_DIR", world["conn"])
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    argv = ["--fast", "--data_dir", world["data"], "--total_steps", "60",
            "--n_milestones", "2"]
    jpath, ppath = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    _, jout = outputs(capsys, run_jax, monkeypatch,
                      [*argv, "--regimes", "stream", "--out", jpath])
    out, pout = outputs(capsys, stream_quality_ab.main,
                        [*argv, "--out", ppath])
    with open(jpath) as f, open(ppath) as g:
        want, got = json.load(f), json.load(g)
    assert got == json.loads(json.dumps(out))
    assert got.keys() == want.keys() == {"milestones", "runs"}
    assert got["milestones"] == want["milestones"] == [30, 60]
    assert [r["regime"] for r in got["runs"]] == ["episodic", "stream"]
    (jrun,) = want["runs"]
    assert got["runs"][1]["regime"] == jrun["regime"]
    for run in got["runs"]:
        assert structure(run) == structure(jrun)
        assert run["schedule"] == jrun["schedule"]
        steps = [row["agent_steps"] for row in run["rows"]]
        assert steps[0] == 0
        assert all(s >= m for s, m in zip(steps[1:], got["milestones"]))
    # the table: a header, a rule and a row per run
    table = [x for x in pout.splitlines() if x.startswith("|")]
    jtable = [x for x in jout.splitlines() if x.startswith("|")]
    assert len(table) == 4 and table[:2] == jtable[:2]
    assert "compile skipped" in pout
