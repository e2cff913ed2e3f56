"""Shared fixtures of the benchmark's CPU tests: a tiny cell written into
a temporary root (the NDH cell's configuration and mix files with small
widths and few slots), run by ``port_bench.run.run_cell`` on the CPU."""

from __future__ import annotations

import json
import os
import shutil

import pytest

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)
TINY = dict(feature_size=64, angle_feat_size=8, d_enc_hidden_size=16,
            d_hidden_size=32, critic_dim=16, d_vl_layers=1, d_la_layers=1,
            aemb=8)
TINY_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-4, "change_gap": 1e-4,
               "sample_disagree": 0.0, "trajectory_mismatch": 0.0}


def write_tiny_root(root, task="ndh", batch=3, steps=4, max_input=24,
                    check_windows=2):
    """The NDH cell's configuration and mix at tiny sizes; ``task="r2r"``
    turns the mix into R2R instructions (the generator's other task)."""
    for d in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(root, "port_bench", d), exist_ok=True)
    shutil.copytree(os.path.join(PB, "metrics"),
                    os.path.join(root, "port_bench", "metrics"))
    with open(os.path.join(PB, "configs", "dasa-ndh.json")) as f:
        c = json.load(f)
    c["settings"].update(TINY)
    with open(os.path.join(root, "port_bench", "configs", "tiny.json"),
              "w") as f:
        json.dump(c, f)
    with open(os.path.join(PB, "traffic", "ndh-train-stream-b64.json")) as f:
        t = json.load(f)
    t["settings"].update(batch_size=batch, stream_steps=steps,
                         max_action=steps + 1, max_input=max_input,
                         stream_pool=2 * batch * steps)
    t["world"] = {"scans": 2, "viewpoints": 20}
    t["split"].update(paths=12, hops=[2, 3], words=[3, 10],
                      dialog_words=max_input + 4)
    if task == "r2r":
        t["task"] = "r2r"
        for key in ("train", "history", "path_type"):
            t["settings"].pop(key)
        t["split"].pop("dialog_words")
        t["split"]["instructions"] = 3
    t["check_windows"] = check_windows
    with open(os.path.join(root, "port_bench", "traffic", "tiny.json"),
              "w") as f:
        json.dump(t, f)
    with open(os.path.join(root, "port_bench", "limits", "tiny.train.json"),
              "w") as f:
        json.dump({"limits": TINY_LIMITS}, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [{"name": "tiny", "file":
                         "port_bench/configs/tiny.json"}]
    bench["workloads"] = [{"name": "tiny.train", "config": "tiny",
                           "traffic": "tiny", "chips": 1}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return write_tiny_root(str(tmp_path_factory.mktemp("tiny")))


@pytest.fixture(scope="module")
def tiny_r2r_root(tmp_path_factory):
    return write_tiny_root(str(tmp_path_factory.mktemp("tiny_r2r")),
                           task="r2r", max_input=10)
