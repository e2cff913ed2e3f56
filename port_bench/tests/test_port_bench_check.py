"""The comparison that decides ``correct``, driven through a whole run of
a tiny cell on the CPU (the harness's look for a card skipped): a sound
run is correct; the control (the reference with its weight products in
fp8, in the program's place) is not; and a run with each fault a training
cell can have planted under the timed path is not.  One more test runs
the real cells briefly where a card is present."""

from __future__ import annotations

import json
import os

import pytest

from port_bench import run
from port_bench.tests.conftest import ROOT


@pytest.fixture(scope="module")
def sound(tiny_root):
    return run.run_cell(tiny_root, "tiny.train", 2_200_000_011, 0.5, 0,
                        device="cpu", control=True)


def test_sound_run_is_correct(sound):
    assert sound["correct"], sound["compared"]
    assert sound["attempted"] >= 1 and sound["failed"] == 0
    assert set(sound["metrics"]) == {"train_agent_steps_per_s", "setup_s"}
    assert list(sound)[-1] == "compared"


def test_control_is_not_correct(sound, tiny_root):
    """The run's own verdict on the control, and by hand against the
    limits file."""
    assert sound["control"]["correct"] is False, sound["control"]
    limits = json.load(open(os.path.join(
        tiny_root, "port_bench", "limits", "tiny.train.json")))["limits"]
    failed = [k for k, row in sound["control"]["compared"].items()
              if row["value"] > limits[k]]
    assert failed, sound["control"]


def test_r2r_sound_run_is_correct(tiny_r2r_root):
    out = run.run_cell(tiny_r2r_root, "tiny.train", 77, 0.2, 0,
                       device="cpu")
    assert out["correct"], out["compared"]


@pytest.mark.parametrize("fault", ["frozen", "half", "token"])
def test_planted_fault_is_not_correct(tiny_root, fault):
    out = run.run_cell(tiny_root, "tiny.train", 31337, 0.2, 0,
                       device="cpu", fault=fault)
    assert not out["correct"], (fault, out["compared"])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["dasa-ndh.train-stream"])
def test_cell_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: python -m pytest "
                    "-m cuda port_bench/tests)")
    out = run.run_cell(ROOT, workload, 424242, 3.0, 1)
    assert out["correct"], out["compared"]
    assert out["device"]["busy_s"] > 0


def test_traced_line_counts_consumed_work(tiny_root):
    """``mfu.train`` counts the text stack once for each episode that ran
    in the window, not for every pool row the program encodes."""
    from port_bench import flops

    out = run.run_cell(tiny_root, "tiny.train", 4242, 0.2, 1, device="cpu")
    assert out["correct"], out["compared"]
    assert set(out["metrics"]) == {"mfu.train", "starved_share.train"}
    _cell, config, traffic, _m = run.find_cell(tiny_root, "tiny.train")
    s = {**config["settings"], **traffic["settings"]}
    w = out["window"]
    slots = 2 * s["batch_size"]
    assert w["calls"] <= w["episodes"] < w["calls"] * (
        slots + 2 * s["stream_pool"])
    want = 100.0 * flops.stream_window_flops(s, w["episodes"], w["calls"]) \
        / (w["wall_s"] * flops.PEAK_BF16)
    assert out["metrics"]["mfu.train"]["value"] == pytest.approx(want)
