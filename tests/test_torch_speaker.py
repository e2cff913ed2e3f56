"""The PyTorch port's speaker against the JAX package.

On a synthetic 2-scan world, the JAX ``SpeakerAgent`` and the port's carry
the same weights (``speaker_state_dict_from_jax``) at tiny widths, in f32
on the CPU, with every dropout rate 0.  The teacher-path records, the
greedy words and the relabelled encodings must be equal; the encoder
context, the teacher-forced logits, the loss and accuracies, the
gradients, the parameters after one training step, the beam scores and
``score_instruction`` agree at tests/test_ops.py's f32 tolerances (rtol
1e-4, atol 1e-5; gradients rtol 2e-4, atol 1e-6).  Then, within the port:
sampled decoding, checkpoints, the refused unidirectional encoder and the
``--train speaker`` / ``validspeaker`` CLI.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasa_tpu.agents.speaker import SpeakerAgent as JaxSpeaker
from dasa_tpu.agents.speaker import SpeakerModel as JaxSpeakerModel
from dasa_tpu.config import Config as JaxConfig
from dasa_tpu.data.features import FeatureDB as JaxFeatureDB
from dasa_tpu.env import R2REnv as JaxEnv
from dasa_tpu.utils import Tokenizer as JaxTokenizer
from dasa_tpu_torch.agents.speaker import SpeakerAgent
from dasa_tpu_torch.config import Config
from dasa_tpu_torch.data.datasets import (
    expand_instructions,
    load_datasets,
    make_synthetic_task,
)
from dasa_tpu_torch.data.features import FeatureDB
from dasa_tpu_torch.env import R2REnv
from dasa_tpu_torch.testing import write_synthetic_connectivity
from dasa_tpu_torch.utils import PAD_IDX, Tokenizer, build_vocab
from dasa_tpu_torch.utils.jax_params import speaker_state_dict_from_jax

SCANS = ("synthA", "synthB")
DIM = 24
L = 24
B = 4
CFG = dict(rnn_dim=32, wemb=16, angle_feat_size=8, feature_size=DIM,
           max_input=L, max_decode=L, max_candidates=16, max_action=8,
           dropout=0.0, featdropout=0.0, batch_size=B, lr=3e-3, optim="adam")
TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=1e-6)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_speaker_world")
    conn, data = str(root / "connectivity"), str(root / "task")
    write_synthetic_connectivity(conn, SCANS, n_nodes=24, seed=0)
    make_synthetic_task(data, SCANS[:1], SCANS[1:], n_train=8, n_val=3,
                        connectivity_dir=conn)
    vocab = build_vocab(load_datasets(["train"], data), min_count=1)
    return conn, data, vocab


def make_pair(world, use_pallas="never", **kw):
    """JAX and port speakers over the train split, same weights."""
    conn, data, vocab = world
    kw = {**CFG, **kw, "use_pallas": use_pallas}
    raw = load_datasets(["train"], data)
    jtok = JaxTokenizer(vocab, encoding_length=L)
    tok = Tokenizer(vocab, encoding_length=L)
    jfeat = JaxFeatureDB.synthetic(SCANS, conn, dim=DIM)
    jenv = JaxEnv(jfeat, expand_instructions(raw, tok, max_input=L),
                  batch_size=B, connectivity_dir=conn, max_candidates=16,
                  max_input=L, backend="python")
    jsp = JaxSpeaker(JaxConfig(**kw), jenv, jfeat, vocab_size=len(jtok),
                     tok=jtok, rng_seed=5)
    feat = FeatureDB.synthetic(SCANS, conn, dim=DIM)
    env = R2REnv(feat, expand_instructions(raw, tok, max_input=L),
                 batch_size=B, connectivity_dir=conn, max_candidates=16,
                 max_input=L, backend="python")
    sp = SpeakerAgent(Config(**kw, connectivity_dir=conn, data_dir=data),
                      env, feat, vocab_size=len(tok), tok=tok,
                      device="cpu")
    sp.load_jax_params(jax.tree_util.tree_map(np.asarray, jsp.params))
    return jsp, sp


def reset_both(jsp, sp):
    jsp.env.reset()
    sp.env.reset()


def jax_inputs(jsp, rec, lengths):
    img, can = jsp._gather_traj_feats(rec)
    t = rec["feat_row"].shape[1]
    return img, can, jnp.asarray(np.arange(t)[None, :] >= lengths[:, None])


def port_params(sp):
    return {k: v.detach().numpy().copy()
            for k, v in sp.model.state_dict().items()}


def assert_params_match(sp, jax_tree, tol):
    """Every port parameter against the JAX tree mapped onto the port's
    names (an LSTM's single JAX bias b is bias_ih; bias_hh stays zero)."""
    ref = speaker_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_tree))
    got = port_params(sp)
    assert got.keys() == ref.keys()
    for name in got:
        np.testing.assert_allclose(got[name], ref[name], err_msg=name, **tol)


def test_teacher_path_records_match_jax(world):
    jsp, sp = make_pair(world)
    for _ in range(2):
        reset_both(jsp, sp)
        jrec, jlen = jsp.collect_teacher_path()
        rec, lengths = sp.collect_teacher_path()
        np.testing.assert_array_equal(lengths, jlen)
        assert rec.keys() == jrec.keys()
        assert rec["feat_row"].shape[1] % 4 == 0
        for key in rec:
            np.testing.assert_array_equal(rec[key], jrec[key], err_msg=key)


@pytest.mark.parametrize("use_pallas", ["never", "always"])
def test_encoder_ctx_and_teacher_forced_logits_match_jax(world, use_pallas):
    """The gathered features, the encoder context (the BiLSTMs through
    the kernels' plain versions under ``always``) and the decoder's
    teacher-forced logits."""
    jsp, sp = make_pair(world, use_pallas)
    reset_both(jsp, sp)
    rec, lengths = sp.collect_teacher_path()
    img, can, ctx_mask = jax_inputs(jsp, rec, lengths)
    pimg, pcan = sp._gather_traj_feats(rec)
    np.testing.assert_allclose(pimg.numpy(), np.asarray(img), **TOL)
    np.testing.assert_allclose(pcan.numpy(), np.asarray(can), **TOL)
    ctx = jsp.model.apply(jsp.params, can, img, method=JaxSpeakerModel.encode)
    with torch.no_grad():
        pctx = sp._encode(pimg, pcan)
    np.testing.assert_allclose(pctx.numpy(), np.asarray(ctx), **TOL)
    insts = sp.env._get_obs().instr
    h0 = jnp.zeros((B, CFG["rnn_dim"]))
    logits = jsp.model.apply(jsp.params, jnp.asarray(insts), ctx, ctx_mask,
                             h0, h0, method=JaxSpeakerModel.decode)
    with torch.no_grad():
        plogits = sp._tf_logits(pimg, pcan, torch.as_tensor(insts).long(),
                                sp._ctx_mask(rec["feat_row"].shape[1],
                                             lengths))
    np.testing.assert_allclose(plogits.numpy(), np.asarray(logits), **TOL)


def test_loss_accuracy_and_gradients_match_jax(world):
    jsp, sp = make_pair(world, "always")
    reset_both(jsp, sp)
    rec, lengths = sp.collect_teacher_path()
    img, can, ctx_mask = jax_inputs(jsp, rec, lengths)
    insts = sp.env._get_obs().instr
    t = rec["feat_row"].shape[1]
    loss, (wa, sa) = jsp._tf_grad_fn(t, L, False)(
        jsp.params, img, can, jnp.asarray(insts), ctx_mask,
        jax.random.PRNGKey(0))
    model = jsp.model

    def jax_loss(inner):
        params = {"params": inner}
        ctx = model.apply(params, can, img, method=JaxSpeakerModel.encode)
        h0 = jnp.zeros((B, CFG["rnn_dim"]))
        logits = model.apply(params, jnp.asarray(insts), ctx, ctx_mask, h0,
                             h0, method=JaxSpeakerModel.decode)
        logp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        tgt = jnp.asarray(insts)[:, 1:]
        ce = -jnp.take_along_axis(logp, tgt[..., None], axis=-1)[..., 0]
        w = (tgt != PAD_IDX).astype(jnp.float32)
        return (ce * w).sum() / jnp.maximum(w.sum(), 1.0)

    grads = jax.grad(jax_loss)(jsp.params["params"])
    pimg, pcan = sp._gather_traj_feats(rec)
    ploss, pwa, psa = sp._tf_loss(pimg, pcan, torch.as_tensor(insts).long(),
                                  sp._ctx_mask(t, lengths))
    np.testing.assert_allclose(float(ploss.detach()), float(loss),
                               rtol=1e-4)
    np.testing.assert_allclose(float(pwa), float(wa), rtol=1e-6)
    np.testing.assert_allclose(float(psa), float(sa), rtol=1e-6)
    ploss.backward()
    ref = speaker_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, grads))
    for name, p in sp.model.named_parameters():
        if "bias_hh" in name:  # frozen, as the JAX cell has one bias
            assert p.grad is None
            continue
        np.testing.assert_allclose(p.grad.numpy(), ref[name], err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("optim", ["rms", "adam"])
def test_train_step_matches_jax(world, optim):
    """One ``train(1)``: the env batch, the loss, the clip at 40 and the
    optimizer step, from the same weights."""
    jsp, sp = make_pair(world, "always", optim=optim)
    jlosses = jsp.train(1)
    losses = sp.train(1)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert_params_match(sp, jsp.params, dict(rtol=1e-4, atol=1e-5))


@pytest.mark.parametrize("use_pallas", ["never", "always"])
def test_greedy_words_match_jax(world, use_pallas):
    jsp, sp = make_pair(world, use_pallas)
    for _ in range(2):
        reset_both(jsp, sp)
        np.testing.assert_array_equal(sp.infer_batch(), jsp.infer_batch())


def test_beam_words_and_scores_match_jax(world):
    jsp, sp = make_pair(world, "always")
    reset_both(jsp, sp)
    jwords, jscores = jsp.beam_infer_batch(beam_size=3)
    words, scores = sp.beam_infer_batch(beam_size=3)
    assert words.shape == (B, 3, L) and scores.shape == (B, 3)
    np.testing.assert_array_equal(words, jwords)
    np.testing.assert_allclose(scores, jscores, **TOL)
    assert (np.diff(scores, axis=1) <= 0).all()  # best first


def test_score_instruction_matches_jax(world):
    jsp, sp = make_pair(world, "always")
    reset_both(jsp, sp)
    rec, _lengths = sp.collect_teacher_path()
    insts = sp.env._get_obs().instr
    np.testing.assert_allclose(sp.score_instruction(rec, insts),
                               jsp.score_instruction(rec, insts), **TOL)


def test_score_instruction_is_a_pure_forward(world, monkeypatch):
    """score_instruction records no autograd graph: its logits do not
    require grad, and the BiLSTMs (the kernel route under ``always``)
    run without BiLstmScanFn, so no gate activations are written; the
    scores equal those of the same forward with autograd recording."""
    from dasa_tpu_torch.ops.lstm import BiLstmScanFn

    _jsp, sp = make_pair(world, "always")
    sp.env.reset()
    rec, _lengths = sp.collect_teacher_path()
    insts = sp.env._get_obs().instr
    img, can = sp._gather_traj_feats(rec)
    t = rec["feat_row"].shape[1]
    # the rescoring's context mask: the path's moves (has_cand)
    logits = sp._tf_logits(img, can, torch.as_tensor(insts).long(),
                           sp._ctx_mask(t, rec["has_cand"].sum(1)))[:, :-1]
    assert logits.requires_grad  # the recording forward, for reference
    tgt = torch.as_tensor(insts).long()[:, 1:]
    ce = -torch.log_softmax(logits, -1).gather(-1, tgt[..., None])[..., 0]
    want = torch.where(tgt != PAD_IDX, ce, 0.0).detach().numpy()

    seen = []
    tf_logits = sp._tf_logits

    def spy(*args, **kwargs):
        seen.append(tf_logits(*args, **kwargs))
        return seen[-1]

    def refuse(*args):
        raise AssertionError("BiLstmScanFn applied in a pure forward")

    monkeypatch.setattr(sp, "_tf_logits", spy)
    monkeypatch.setattr(BiLstmScanFn, "apply", refuse)
    got = sp.score_instruction(rec, insts)
    assert len(seen) == 1 and not seen[0].requires_grad
    np.testing.assert_array_equal(got, want)


def test_relabel_batch_matches_jax(world):
    """The greedy decode under the shared env-drop mask, PAD / EOS
    stripped, re-encoded to max_input; copies swapped into the batch."""
    jsp, sp = make_pair(world, "always")
    noise = ((np.random.default_rng(3).random(DIM) > 0.3) / 0.7).astype(
        np.float32)
    data_before = [np.asarray(it["instr_encoding"]).copy()
                   for it in sp.env.data]
    for _ in range(2):
        reset_both(jsp, sp)
        jobs = jsp.relabel_batch(jsp.env, jnp.asarray(noise),
                                 jax.random.PRNGKey(0))
        obs = sp.relabel_batch(sp.env, torch.from_numpy(noise))
        np.testing.assert_array_equal(obs.instr, jobs.instr)
        for item, jitem in zip(sp.env.batch, jsp.env.batch):
            assert item["instructions"] == jitem["instructions"]
            np.testing.assert_array_equal(item["instr_encoding"],
                                          jitem["instr_encoding"])
    for item, enc in zip(sp.env.data, data_before):
        np.testing.assert_array_equal(item["instr_encoding"], enc)


def test_sampled_decode_invariants(world):
    """Sampling never emits UNK, emits PAD after a row's EOS, and differs
    between calls (the generator advances)."""
    _jsp, sp = make_pair(world, "always")
    unk, eos = (sp.tok.word_to_index[w] for w in ("<UNK>", "<EOS>"))
    draws = []
    for _ in range(3):
        sp.env.reset_epoch()
        sp.env.reset()
        words = sp.infer_batch(sampling=True)
        assert words.shape == (B, L)
        assert not (words == unk).any()
        for row in words:
            ends = np.nonzero(row == eos)[0]
            if len(ends):
                assert (row[ends[0] + 1:] == PAD_IDX).all()
        draws.append(words)
    assert any(not np.array_equal(draws[0], d) for d in draws[1:])


def test_save_load_round_trip(world, tmp_path):
    _jsp, sp = make_pair(world, "always", optim="rms")
    sp.train(2)
    path = str(tmp_path / "speaker" / "ckpt")
    sp.save(7, path)
    _jsp2, fresh = make_pair(world, "always", optim="rms", load_optim=True)
    assert fresh.load(path) == 7
    for key, val in fresh.model.state_dict().items():
        torch.testing.assert_close(val, sp.model.state_dict()[key],
                                   atol=0, rtol=0)
    sq = [s["square_avg"] for s in fresh.optimizer.state.values()]
    assert len(sq) == len(fresh.params)


def test_unidirectional_encoder_raises(world):
    """``bidir=False`` builds (it raised before the one-direction LSTM was
    ported): the encoder's LSTMs are one direction of rnn_dim, their
    context equals the JAX encoder's once their ``reverse`` flag matches
    the JAX module's (which passes its dtype where ``LSTM`` takes
    ``reverse``, so it runs them time-reversed), and a training step gives
    a finite loss."""
    from dasa_tpu_torch.models.layers import LSTM

    jsp, sp = make_pair(world, bidir=False)
    enc = sp.model.encoder
    assert isinstance(enc.lstm, LSTM) and isinstance(enc.post_lstm, LSTM)
    assert enc.lstm.features == CFG["rnn_dim"]
    reset_both(jsp, sp)
    rec, lengths = sp.collect_teacher_path()
    img, can, _mask = jax_inputs(jsp, rec, lengths)
    ctx = jsp.model.apply(jsp.params, can, img, method=JaxSpeakerModel.encode)
    pimg, pcan = sp._gather_traj_feats(rec)
    enc.lstm.reverse = enc.post_lstm.reverse = True
    with torch.no_grad():
        pctx = sp._encode(pimg, pcan)
    np.testing.assert_allclose(pctx.numpy(), np.asarray(ctx), **TOL)
    enc.lstm.reverse = enc.post_lstm.reverse = False
    assert np.isfinite(sp.train(1)).all()


def test_cli_trains_and_validates_the_speaker(world, tmp_path, capsys):
    """python -m dasa_tpu_torch.cli --train speaker, then validspeaker
    --load on the checkpoint it wrote."""
    from dasa_tpu_torch.cli import main

    conn, data, _vocab = world
    args = ["--device", "cpu", "--connectivity_dir", conn, "--data_dir",
            data, "--snap_dir", str(tmp_path / "snap"), "--log_dir",
            str(tmp_path / "log"), "--name", "spk", "--iters", "2",
            "--log_every", "2", "--val_every", "2", "--batchSize", str(B)]
    for key, val in CFG.items():
        if key != "batch_size":
            args += [f"--{key}", str(val)]
    main(args + ["--train", "speaker"])
    snap = tmp_path / "snap" / "spk" / "state_dict"
    for name in ("LAST_iter2", "best_val_seen_loss", "best_val_unseen_loss"):
        assert (snap / name).exists(), name
    out = capsys.readouterr().out
    assert "SPEAKER iter 2 val_unseen: bleu" in out
    main(args + ["--train", "validspeaker", "--load",
                 str(snap / "LAST_iter2")])
    out = capsys.readouterr().out
    assert "val_seen: bleu" in out and "val_unseen: bleu" in out
