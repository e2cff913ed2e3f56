"""The port's operational scripts (``dasa_tpu_torch/scripts/``) against the
JAX package's (``scripts/``).

On a synthetic 2-scan world (``testing.write_synthetic_connectivity`` and a
``scans.txt`` the fixture writes), each script of the port and of the JAX
package runs in this process with the same flags, each JAX script given an
explicit ``--connectivity`` / ``--connectivity_dir`` / ``--vocab``:

- ``make_task``, ``make_mini_dataset`` (an .npz image store and a TSV depth
  store), ``random_agent`` and ``interactive_agent`` (the same scripted
  stdin) write equal files and print equal lines;
- ``plot_curves``: ``load_series`` of a two-iteration CLI run of the port
  equals the JAX function's on the same files, and ``main`` writes its
  PNGs;
- ``make_aug_paths``: ``sample_new_paths`` equals the JAX function's
  exactly; with a trained JAX speaker's file given to both as ``--load``
  (greedy decoding, f32, dropout off) the written files are equal, word for
  word, and the port's loads through ``--aug`` into an ``auglistener``
  iteration with no item dropped;
- ``check_real_data``: on TSV image features and a listener checkpoint in
  the reference's per-component layout (``adaIn``), saved from a port
  agent, both print ``READY:`` and each split's metrics agree within rtol
  1e-5; the missing-asset cases exit 1 with equal ``FAILED:`` lines.  The
  JAX script assigns ``import_listener_checkpoint``'s (params, missed)
  pair to ``agent.params``; the JAX side runs here with that function
  wrapped to return the params alone;
- ``stream_quality_ab`` is held in tests/test_torch_scripts_ab.py.

The listeners run at a 64-wide BERT on both sides (``bert_config_from``
patched in both policy modules), the speaker at rnn_dim 32.
"""

import dataclasses
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

import dasa_tpu.models.policy as jax_policy
import dasa_tpu.utils.torch_import as jax_torch_import
import dasa_tpu_torch.models.policy as port_policy
from dasa_tpu.agents.speaker import SpeakerAgent as JaxSpeaker
from dasa_tpu.config import Config as JaxConfig
from dasa_tpu.data.features import FeatureDB as JaxFeatureDB
from dasa_tpu.env import R2REnv as JaxEnv
from dasa_tpu.utils import Tokenizer as JaxTokenizer
from dasa_tpu_torch import cli
from dasa_tpu_torch.config import parse_args
from dasa_tpu_torch.data.datasets import (
    expand_instructions,
    load_datasets,
    make_synthetic_task,
)
from dasa_tpu_torch.data.features import FeatureDB
from dasa_tpu_torch.scripts import (
    check_real_data,
    interactive_agent,
    make_aug_paths,
    make_mini_dataset,
    make_task,
    plot_curves,
    random_agent,
)
from dasa_tpu_torch.testing import (
    torch_threads,
    write_feature_tsv,
    write_synthetic_connectivity,
)
from dasa_tpu_torch.train import trainer
from dasa_tpu_torch.utils import build_vocab, write_vocab

SCANS = ("synthA", "synthB")
DIM = 24
L = 24
B = 4
NARROW = dict(hidden_size=64, num_attention_heads=2, intermediate_size=128)
# the speaker at test widths, f32, dropout off, the python sim engine (the
# native one's float geometry differs by ulps)
SPEAKER = dict(rnn_dim=32, wemb=16, angle_feat_size=8, feature_size=DIM,
               max_input=L, max_decode=L, dropout=0.0, featdropout=0.0,
               batch_size=B, sim_backend="python")
# the headline listener's family at test widths
LISTENER = dict(
    encoder_type="Dic", include_vision=True, adain_type="channel",
    ab_type="a", a_type="sigmoid", use_shift=True, shift_kernel_size=5,
    feature_size=DIM, angle_feat_size=8, d_enc_hidden_size=16,
    d_hidden_size=32, critic_dim=32, d_vl_layers=1, d_la_layers=1,
    max_input=L, max_action=5, batch_size=B, sim_backend="python")
# a plain listener for the CLI runs
PLAIN = dict(rnn_dim=32, wemb=16, aemb=8, critic_dim=32, angle_feat_size=8,
             feature_size=DIM, max_input=L, max_action=5, batch_size=B,
             sim_backend="python")
METRIC_RTOL = 1e-5


def flags(**kw):
    return [x for key, val in kw.items() for x in (f"--{key}", str(val))]


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
    root = tmp_path_factory.mktemp("torch_scripts_world")
    conn, data = str(root / "connectivity"), str(root / "task")
    write_synthetic_connectivity(conn, SCANS, n_nodes=24, seed=0)
    with open(os.path.join(conn, "scans.txt"), "w") as f:
        f.write("\n".join(SCANS) + "\n")
    make_synthetic_task(data, SCANS[:1], SCANS[1:], n_train=8, n_val=4,
                        connectivity_dir=conn)
    vocab = build_vocab(load_datasets(["train"], data), min_count=1)
    write_vocab(vocab, os.path.join(data, "train_vocab.txt"))
    return dict(root=root, conn=conn, data=data, vocab=vocab)


def run_jax(monkeypatch, name, argv):
    """``scripts/<name>.py``'s main with ``sys.argv`` set, as
    tests/test_scripts.py runs it."""
    module = __import__(f"scripts.{name}", fromlist=["main"])
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    return module.main()


def outputs(capsys, fn, *args):
    capsys.readouterr()
    result = fn(*args)
    return result, capsys.readouterr().out


def read_json_files(d):
    return {n: json.load(open(os.path.join(d, n)))
            for n in sorted(os.listdir(d)) if n.endswith(".json")}


# ---------------------------------------------------------------------------
# the host tools
# ---------------------------------------------------------------------------
def test_make_task_matches_jax(world, tmp_path, monkeypatch, capsys):
    argv = ["--connectivity", world["conn"], "--train_scans", "1",
            "--unseen_scans", "1", "--n_train", "6", "--n_val", "3",
            "--seed", "4"]
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _, jout = outputs(capsys, run_jax, monkeypatch, "make_task",
                      ["--out", jdir, *argv])
    _, pout = outputs(capsys, make_task.main, ["--out", pdir, *argv])
    assert pout.replace(pdir, jdir) == jout
    jfiles, pfiles = read_json_files(jdir), read_json_files(pdir)
    assert set(pfiles) == {f"R2R_{s}.json" for s in
                           ("train", "val_seen", "val_unseen", "aug")}
    assert pfiles == jfiles


def test_make_mini_dataset_matches_jax(world, tmp_path, monkeypatch, capsys):
    img = str(tmp_path / "img.npz")
    FeatureDB.synthetic(SCANS, world["conn"], dim=8).save(img)
    depth = str(tmp_path / "depth.tsv")
    write_feature_tsv(FeatureDB.synthetic(SCANS, world["conn"], dim=4,
                                          salt=3), depth)
    argv = ["--data_dir", world["data"], "--features", img, "--dfeatures",
            depth, "--max_items", "3"]
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _, jout = outputs(capsys, run_jax, monkeypatch, "make_mini_dataset",
                      [*argv, "--out", jdir])
    _, pout = outputs(capsys, make_mini_dataset.main, [*argv, "--out", pdir])
    assert pout == jout and "depth_features:" in pout
    assert read_json_files(pdir) == read_json_files(jdir)
    for name in ("img_features", "depth_features"):
        got = np.load(os.path.join(pdir, f"{name}.npz"))
        want = np.load(os.path.join(jdir, f"{name}.npz"))
        np.testing.assert_array_equal(got["ids"], want["ids"])
        np.testing.assert_array_equal(got["values"], want["values"])
        assert len(got["ids"]) > 0


def test_random_agent_matches_jax(world, monkeypatch, capsys):
    argv = ["--connectivity", world["conn"], "--scan", "synthB", "--steps",
            "15", "--seed", "3"]
    _, jout = outputs(capsys, run_jax, monkeypatch, "random_agent", argv)
    _, pout = outputs(capsys, random_agent.main, argv)
    assert pout == jout
    assert pout.count("\nstep ") == 14 and pout.endswith("done\n")


def test_interactive_agent_matches_jax(world, monkeypatch, capsys):
    argv = ["--connectivity_dir", world["conn"], "--scan", "synthA",
            "--seed", "2"]
    keys = "1\nl\nl\n1\nu\n99\nx\nq\n"
    monkeypatch.setattr(sys, "stdin", io.StringIO(keys))
    _, jout = outputs(capsys, run_jax, monkeypatch, "interactive_agent", argv)
    monkeypatch.setattr(sys, "stdin", io.StringIO(keys))
    _, pout = outputs(capsys, interactive_agent.main, argv)
    assert pout == jout
    assert "index out of range" in pout and "> ?\n" in pout
    assert pout.count("\nviewpoint ") == 8
    assert len({x.split()[1] for x in pout.splitlines()
                if x.startswith("viewpoint ")}) == 3  # two moves


def test_plot_curves_reads_a_port_run_as_jax_does(world, tmp_path,
                                                  monkeypatch):
    from scripts.plot_curves import load_series as jax_load_series

    log = str(tmp_path / "log")
    cli.main(["--device", "cpu", "--train", "listener", "--iters", "2",
              "--log_every", "1", "--val_every", "1", "--name", "plot",
              "--data_dir", world["data"], "--connectivity_dir",
              world["conn"], "--log_dir", log, "--snap_dir",
              str(tmp_path / "snap"), *flags(**PLAIN)])
    run = os.path.join(log, "plot")
    series = plot_curves.load_series(run)
    want = jax_load_series(run)
    assert dict(series) == dict(want)
    assert any("nav_error" in t for t in series)
    assert all(set(s) == {1, 2} for s, _v in series.values())
    plot_curves.main(["--run", run])
    for png in ("training.png", "error.png"):
        assert os.path.getsize(os.path.join(run, "plots", png)) > 0


# ---------------------------------------------------------------------------
# make_aug_paths
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,hops", [(0, (4, 6)), (7, (2, 3))])
def test_sample_new_paths_equals_jax(world, seed, hops):
    from scripts.make_aug_paths import sample_new_paths as jax_sample

    existing = {(it["scan"], tuple(it["path"]))
                for it in load_datasets(["train"], world["data"])}
    args = (set(SCANS), existing, world["conn"], 9, *hops, seed)
    got = make_aug_paths.sample_new_paths(*args)
    assert got == jax_sample(*args)
    assert len(got) == 18
    assert not {(it["scan"], tuple(it["path"])) for it in got} & existing


@pytest.fixture(scope="module")
def jax_speaker_file(world, tmp_path_factory):
    """A JAX speaker trained until its greedy decodes end in <EOS>, saved
    in the JAX package's format."""
    conn = world["conn"]
    tok = JaxTokenizer(world["vocab"], encoding_length=L)
    raw = load_datasets(["train"], world["data"])
    feat = JaxFeatureDB.synthetic(SCANS, conn, dim=DIM)
    env = JaxEnv(feat, expand_instructions(raw, tok, max_input=L),
                 batch_size=B, connectivity_dir=conn, max_candidates=16,
                 max_input=L, backend="python")
    cfg = {k: v for k, v in SPEAKER.items() if k != "sim_backend"}
    speaker = JaxSpeaker(JaxConfig(**cfg, lr=1e-2, optim="adam",
                                   connectivity_dir=conn),
                         env, feat, vocab_size=len(tok), tok=tok, rng_seed=5)
    speaker.train(80)
    path = str(tmp_path_factory.mktemp("torch_scripts_speaker") / "speaker")
    speaker.save(80, path)
    return path


def test_make_aug_paths_writes_what_jax_writes(world, jax_speaker_file,
                                               tmp_path, capsys):
    from scripts.make_aug_paths import main as jax_main

    argv = ["--n_per_scan", "10", *flags(**SPEAKER), "--data_dir",
            world["data"], "--connectivity_dir", world["conn"], "--load",
            jax_speaker_file]
    jpath, ppath = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jitems, jout = outputs(capsys, jax_main, ["--out", jpath, *argv])
    pitems, pout = outputs(capsys, make_aug_paths.main,
                           ["--out", ppath, "--device", "cpu", *argv])
    with open(jpath) as f, open(ppath) as g:
        want, got = json.load(f), json.load(g)
    assert got == want == jitems == pitems
    assert "".join(x for x in pout.splitlines(True) if not x.startswith(
        "decoded ")).replace(ppath, jpath) == jout
    # 10 items in batches of 4: the third batch wraps around to the first
    assert len(got) == 10 and "decoded 3 batches of 4" in pout
    assert len({it["path_id"] for it in got}) == 10
    words = [it["instructions"][0] for it in got]
    assert all(w != "placeholder" and len(w.split()) > 2 for w in words)

    # the file through --aug: one auglistener iteration (an org and an aug
    # pass pair), every item loaded
    cfg = parse_args([
        "--train", "auglistener", "--aug", ppath, "--iters", "2",
        "--log_every", "2", "--val_every", "1000", "--data_dir",
        world["data"], "--connectivity_dir", world["conn"], "--log_dir",
        str(tmp_path / "log"), "--snap_dir", str(tmp_path / "snap"),
        *flags(**PLAIN)])
    aug_world = trainer.World(cfg)
    assert len(aug_world.envs["aug"].data) == len(got)
    assert {it["instr_id"] for it in aug_world.envs["aug"].data} == {
        f"{it['path_id']}_0" for it in got}
    agent = trainer.train(cfg, aug_world, device="cpu")
    assert agent.iter_count == 1  # one optimizer step
    assert agent.env_steps_total() > 0


def test_make_aug_paths_without_load_warns(world, tmp_path, capsys):
    path = str(tmp_path / "smoke.json")
    items = make_aug_paths.main([
        "--out", path, "--n_per_scan", "3", "--device", "cpu",
        *flags(**SPEAKER), "--data_dir", world["data"], "--connectivity_dir",
        world["conn"]])
    err = capsys.readouterr().err
    assert "WARNING: no --load" in err
    assert len(items) == 3 and all(it["instructions"][0] for it in items)


# ---------------------------------------------------------------------------
# check_real_data
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def readiness_assets(world, tmp_path_factory):
    """TSV image features, an explicit vocab and a reference-layout listener
    checkpoint ({encoder, decoder, critic, adaIn}: {"epoch",
    "state_dict", "optimizer"}) saved from a port agent."""
    root = tmp_path_factory.mktemp("torch_scripts_readiness")
    tsv = str(root / "img.tsv")
    write_feature_tsv(FeatureDB.synthetic(SCANS, world["conn"], dim=DIM), tsv)
    vocab = str(root / "vocab.txt")
    write_vocab(world["vocab"], vocab)
    cfg = parse_args(["--data_dir", world["data"], "--connectivity_dir",
                      world["conn"], "--img_features_path", tsv,
                      "--vocab_path", vocab, *flags(**LISTENER)])
    agent = trainer.make_agent(cfg, trainer.World(cfg), device="cpu",
                               rng_seed=3)
    agent.save(7, str(root / "port_ckpt"))
    blob = torch.load(str(root / "port_ckpt"), weights_only=False)
    ref = {("adaIn" if name == "adain" else name):
           {k: v for k, v in entry.items() if k != "iteration"}
           for name, entry in blob.items()}
    ckpt = str(root / "reference_ckpt")
    torch.save(ref, ckpt)
    return dict(tsv=tsv, vocab=vocab, ckpt=ckpt, root=root)


def test_check_real_data_matches_jax(world, readiness_assets, monkeypatch,
                                     capsys):
    from dasa_tpu.train import evaluation as jax_evaluation

    a = readiness_assets
    listener = " ".join(flags(**LISTENER))
    argv = ["--data_dir", world["data"], "--img_features", a["tsv"],
            "--vocab", a["vocab"], "--checkpoint", a["ckpt"], "--flags",
            f"{listener} --connectivity_dir {world['conn']}"]
    importer = jax_torch_import.import_listener_checkpoint
    monkeypatch.setattr(jax_torch_import, "import_listener_checkpoint",
                        lambda params, path: importer(params, path)[0])
    # the JAX summaries, unrounded
    want, score = {}, jax_evaluation.Evaluation.score

    def capture(self, results):
        summary, extra = score(self, results)
        want[self.splits[0]] = summary
        return summary, extra

    monkeypatch.setattr(jax_evaluation.Evaluation, "score", capture)
    _, jout = outputs(capsys, run_jax, monkeypatch, "check_real_data", argv)
    report, pout = outputs(capsys, check_real_data.main,
                           [*argv, "--device", "cpu"])
    for out in (jout, pout):
        assert "assets: ok" in out and "\nREADY: " in out
    assert "loaded checkpoint" in pout and "(iter 7)" in pout
    assert set(report) == set(want) == {"val_seen", "val_unseen"}
    for split, entry in report.items():
        assert entry["summary"].keys() == want[split].keys()
        for key, val in want[split].items():
            np.testing.assert_allclose(entry["summary"][key], val,
                                       rtol=METRIC_RTOL, err_msg=key)
        ids = [r["instr_id"] for r in entry["results"]]
        assert sorted(ids) == sorted(
            it["instr_id"] for it in expand_instructions(
                load_datasets([split], world["data"])))
        line = next(x for x in pout.splitlines()
                    if x.startswith(f"{split}: "))
        assert line == next(x for x in jout.splitlines()
                            if x.startswith(f"{split}: "))


def missing_case(world, root, case):
    """(argv, what to remove) for one missing asset."""
    evalonly = os.path.join(root, "evalonly")
    os.makedirs(evalonly, exist_ok=True)
    with open(os.path.join(world["data"], "R2R_val_seen.json")) as f, open(
            os.path.join(evalonly, "R2R_val_seen.json"), "w") as g:
        g.write(f.read())
    feats = os.path.join(root, "img.tsv")
    return {
        "split": ["--data_dir", os.path.join(root, "empty"),
                  "--img_features", feats],
        "features": ["--data_dir", world["data"], "--img_features",
                     os.path.join(root, "nope.npz")],
        "vocab_fallback": ["--data_dir", evalonly, "--img_features", feats,
                           "--splits", "val_seen"],
        "vocab_file": ["--data_dir", world["data"], "--img_features", feats,
                       "--vocab", os.path.join(root, "nope_vocab.txt")],
    }[case]


@pytest.mark.parametrize("case", ["split", "features", "vocab_fallback",
                                  "vocab_file"])
def test_check_real_data_missing_assets_fail_as_jax(
        world, readiness_assets, monkeypatch, capsys, case):
    argv = missing_case(world, str(readiness_assets["root"]), case)
    monkeypatch.delenv("DASA_REFERENCE_DIR", raising=False)
    outs = []
    for run in (lambda: run_jax(monkeypatch, "check_real_data", argv),
                lambda: check_real_data.main([*argv, "--device", "cpu"])):
        capsys.readouterr()
        with pytest.raises(SystemExit) as exc:
            run()
        assert exc.value.code == 1
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert outs[1].splitlines()[-1].startswith("FAILED: ")
