#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (dasa_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py            # every phase, as the check runs it
    python3 chip_smoke.py --phases build,kernels
    python3 chip_smoke.py --phases build,kernels,stream,stream-eval
    python3 chip_smoke.py --phases build,kernels,speaker,speaker-compare,selftrain
    python3 chip_smoke.py --phases build,kernels,host,search
    python3 chip_smoke.py --phases build,pretrain,pretrain-chain
    python3 chip_smoke.py --phases build,kernels,variants
    python3 chip_smoke.py --phases build,kernels,encoders
    python3 chip_smoke.py --phases build,kernels,ndh,knobs
    python3 chip_smoke.py --phases build,main,dp,offline,native
    python3 chip_smoke.py --phases build,scripts

Phases:
  1. build — print the card's name and power limit, build the CUDA
     kernels from ``dasa_tpu_torch/csrc`` and print the build time and
     the compiler's register report.
  2. kernels — each kernel against its plain PyTorch version on the card
     at the headline shapes, with the tolerance stated, for the episodic
     batch (B = 20) and again for the stream window's 2B = 40 slot rows
     (rows named ``[B40]``: K1 both directions with and without the gate
     activations, K2, K3 on 1440 / 640 rows, K4); K1 in one direction
     (``lstm_scan``: the top LSTM under ``d_bidirectional=False``) at both
     batches, with LstmScanFn's gradients, against a cuDNN
     ``nn.LSTM(bidirectional=False)``; times (CUDA
     events, median) of kernel, plain version and one yardstick PyTorch
     call, and the kernel / yardstick ratio, beside the least time the
     card could take.  Also the device time of kernel and yardstick
     alone (calls back to back, so the host's launch work drops out);
     the launch plans (the AdaIN gate's tiles, the LSTM forward's grid
     for one and two directions, the LSTM backward's chunks, the shift
     attention's slices) and the LSTM kernels' time per token.  The LSTM
     forward is timed for one direction, for both directions in one
     launch with and without the gate activations, and as two
     one-direction launches (at B = 40 both directions take one launch
     each).  Rows named ``[spk]`` hold K1 and K2 at the speaker's BiLSTM
     (H = 256 a direction, T = 35, every token valid) for selfTrain's
     relabel batch (B = 20) and speaker training's (``[spk,B64]``), with
     BiLstmScanFn's gradients, against a cuDNN ``nn.LSTM(2176, 256)``.
     Rows named ``[rsc,T..]`` hold K1 (both directions, with and without
     the gate activations) at the search's speaker rescoring: one path
     (B = 1), H = 256, T in {1, 2, 8, 35} moves, every token valid, with
     the ``[spk]`` limits.  Rows named ``[enc,B64]``, ``[enc1,B64]``,
     ``[mcan,B64]``, ``[joint,B20,T116]`` and ``[joint,B40,T116]`` hold
     K1 and K2 at phase 17's LSTMs (``ENC_ROWS``: H 256 both directions,
     H 512 one direction and H 384 both directions at B 64, T 80, ragged;
     H 1024 both directions at B 20 and at the stream window's 40 slot
     rows over the joint 116 tokens), with the BiLstmScanFn / LstmScanFn
     gradients, against a cuDNN ``nn.LSTM`` of the same input width and
     its backward.  Rows named ``[B64]`` hold K3 at phase 17's batch of
     64 (2304 panorama rows, 1024 candidate rows).  Rows named
     ``[ndh,B20,T300]`` and ``[ndh,B64,T300]`` hold K1 and K2 at NDH's
     300-token dialogs (H 1024 both directions, ragged; B 64 in the row
     chunks the launch plans allow, ``ops/lstm.py:max_chunk_rows``), with
     BiLstmScanFn's gradients.  Rows named ``[dp,B10]`` hold K1 both
     directions, K2, K3 (360 / 160 rows) and K4 at a rank's 10 rows of
     phase 20's batch of 20 at D = 2, with the LstmScanFn, BiLstmScanFn,
     AdainGateFn and ShiftAttendFn gradients (a rank's 20 stream slots
     are the ``B = 20`` rows).
  3. main — the launch counters set to 0, ``valid()`` (argmax evaluation
     of val_seen and val_unseen) at the full headline DASA width over a
     synthetic world, the counters read back; SR/SPL/NE per split,
     episodes/s and agent-steps/s.  Fails if a kernel of the path never
     launched, or if the world's envs do not run the native sim engine.
  4. compare — the same weights under ``use_pallas="always"`` and
     ``"never"``: first-step logits within the stated bf16 tolerance, and
     the share of episodes whose trajectories agree.
  5. train — the launch counters set to 0, ``train()`` (listener: a
     teacher-ML pass, a sampled A2C pass and an optimizer step per
     iteration) at the headline width and training settings under
     ``use_pallas="always"``, the counters read back.  Fails unless every
     kernel (K1-K4) launched, every loss is finite and the parameters
     moved; prints seconds per iteration, training agent-steps/s and the
     peak memory.
  6. train-compare — the same weights under ``always`` and ``never``,
     dropout off, one fused argmax pass with ``train_ml=0.2``: the loss
     within the stated tolerance, the cosine of the flattened gradients
     above the stated floor, and the share of equal trajectories.
  7. stream — the launch counters set to 0, ``train()`` under
     ``rollout_mode="stream"`` (4 windows of 40 slots x 35 steps, one
     optimizer step each) at headline width under ``use_pallas="always"``,
     the counters read back.  Fails unless every kernel launched, every
     loss is finite, the parameters moved and no episode was taken twice
     (the windows' slot-time grids, kept on the card); prints the starved
     share of slot-steps, seconds a window, training agent-steps/s, the
     host phases and the peak memory.
  8. stream-eval — ``valid()`` under the stream regime with phase 3's
     weights: every instr_id of a split covered once (phase 3 is held to
     the same), SR/SPL/NE, episodes/s, the agent-steps/s the slots walked
     and the share of trajectories equal to phase 3's.
  9. speaker — the launch counters set to 0, ``train_speaker()`` for 4
     iterations at batch 64 and ``valid_speaker()`` on both val splits at
     the speaker's Config widths (rnn_dim 512, wemb 256, max_decode 120)
     under ``use_pallas="always"``, over a world of 66 items a split, the
     counters read back.  Fails unless K1 and K2 launched, every loss is
     finite, the encoder's and decoder's parameters moved, each split's
     BLEU is finite and in [0, 1] and every path is captioned; prints
     seconds per iteration, the decode time per batch and the peak
     memory.
  10. speaker-compare — phase 9's weights under ``always`` and ``never``:
     the first decode step's logits within the stated bf16 tolerance, and
     the share of equal greedy instructions.
  11. selftrain — the launch counters set to 0, the README's headline
     command (``auglistener --selfTrain`` on the aug split, batch 20,
     episodic, ``use_pallas="always"``, 3 optimizer steps of an org and an
     aug pass pair, the aug batches relabelled by a speaker first), the
     counters read back.  Fails unless all four kernels launched, every
     relabel replaced instructions, the losses are finite, the listener's
     parameters moved and the speaker's did not; prints seconds per
     iteration, training agent-steps/s, the relabels' share of an
     iteration and the peak memory.
  12. host — the host act/replay rollout at headline width under
     ``use_pallas="always"`` (the AdaIN gate and the shift attention
     through their kernels, the top BiLSTM on its plain path): (a)
     ``valid()`` with ``submit`` over both val splits: every instr_id
     once, ``submit_{split}.json`` equal to the results, no move to a
     candidate the visited mask hid; (b) ``train()`` under
     ``device_rollout="never"``, 3 iterations: finite losses, the listener
     moved, s an iteration and the peak memory; a dropout-free teacher-ML
     pass on one batch against the device teacher pass (phase 6's
     limits); (c) phase 11's command under ``rollout_mode="stream"``, 2
     optimizer steps, the aug passes through the host fallback.
  13. search — ``beam_valid()`` at headline width with an untrained
     speaker at its Config widths (random weights from the seed):
     Dijkstra over both val splits (1 candidate), 3 candidates with
     ``param_search`` on val_seen, state-factored search on val_unseen.
     Fails unless every instr_id is searched once, every picked
     trajectory is a connected walk, every listener and speaker score is
     finite, K1, K3 and K4 launched and the rescoring launched K1 at one
     row; prints seconds a split and expansions a batch.  Then the first
     expansion's log-probabilities under always and never (phase 4's
     limit).
  14. pretrain — ``--train pretrain``'s ``run_pretrain`` at the headline
     BERT (la 9, vl 3, hidden 768, max_input 80) on the synthetic world,
     batch 20, dropout on: 10 AdamW steps (warm_steps 2, so steps 2-10
     move the weights), ``checkpoint-10`` saved.  Fails unless every loss
     is finite, the optimizer took 10 steps and the weights moved; prints
     the seconds a step (median after the first), samples/s, the peak
     memory, the loss at steps 1 and 10 and one ``evaluate()`` (loss,
     mlm_acc, act_acc) on the val_seen split's records; then one batch
     through the bf16 model and an f32 copy of the same weights: the
     loss, the masked positions' MLM logits and the action logits, each
     within its stated limit, and a control that takes the loss from
     bf16 logits in bf16.  The pretraining path launches none of K1-K4.
  15. pretrain-chain — the launch counters set to 0: (a) the headline
     listener built with ``pretrain_model_name`` = phase 14's snapshot
     directory: every ``encoder.bert.*`` tensor equals the Pretrainer's
     exactly (the word table's leading rows; the rest and every other
     tensor equal an un-grafted listener's of the same seed), then 2
     episodic ``train()`` iterations and one ``valid()`` under ``always``;
     (b) an HF-style ``pytorch_model.bin`` of the same weights
     (``DicAddActionPreTrain`` keys, the word table at the BERT vocab's
     30522 rows) grafted the same way, exactly; (c) the listener
     checkpoint of (a) loaded back into a fresh listener, exactly; the
     counters read back.  Fails unless K1-K4 launched.
  16. variants — the DASA variants on the Dic listener at headline width
     (bf16, ``use_pallas="always"``), eight configurations that build
     every agent type and every AdaIN type once (``VARIANTS``): (1) the
     BAttn decoder with the back head (pre), the progress monitor
     (att_hid) and DyReLU candidates, channel AdaIN (a, sigmoid); (2) the
     gumbel-sigmoid gate (ab), back (cur), progress (plain_att), the top
     LSTM in one direction and ctx_v; (3) double + COCO; (4) advanced +
     mean; (5) kvmem + rgb mean + back; (6) new + depth stat; (7) mutan +
     rgb stat; (8) mt + rgb channel.  Each: the launch counters set to 0,
     ``train()`` (one episodic iteration) and ``valid()`` on val_unseen
     (every instr_id once), 1 and 8 also one stream window, 1 one
     host-rollout iteration, the counters read back.  Fails unless every
     loss is finite, each configured auxiliary loss (back, pm, kl) is
     logged and nonzero, and exactly the configuration's kernels
     launched: K1 and K2 in all (K1 in one direction in 2), K3 in 1 and
     8, K4 in 1 and 2.  Prints s an iteration, peak memory and the
     launches; then (1)'s teacher pass under always and never (phase 6's
     limits, not counted).
  17. encoders — the encoder zoo (bf16, ``use_pallas="always"``), ten
     configurations (``ENCODERS``), each a fresh agent at its own widths:
     (1) EncoderLSTM at the Config defaults, the R2R baseline listener
     (batch 64, rnn_dim 512, wemb 256, aemb 64, dropout 0.5, featdropout
     0.3, no AdaIN); (2) the same with one LSTM direction, the masked max
     (``sub_out=max``), zero init states and channel AdaIN (a, sigmoid);
     (3) BEncoder on the headline BERT with the concat of its last two
     layers; (4) CEncoder with ``update_bert``; (5) Transformer and (6)
     Gpt (width 256, 2 layers, 8 heads); (7) BertImg, (8) BertAdd and (9)
     BertMix on the headline listener (its BERT, decoder and AdaIN,
     batch 20); (10) mcatt (768 wide, 2 layers, 8 heads, batch 64).  Each:
     the launch counters set to 0, ``train()`` (one episodic iteration)
     and ``valid()`` on val_unseen (every instr_id once), 1 also a stream
     window, a host-rollout iteration and a Dijkstra ``beam_valid()`` of
     val_unseen, 8 a stream window, the counters read back.  Fails unless
     every loss is finite, every trained component's parameters moved
     and exactly the configuration's kernels launched: K1 and K2 in all
     (K1 in one direction in 2), K3 in 2 and 7-9, K4 in 7-9.  Prints s an
     iteration, peak memory and the launches; then (1)'s teacher pass
     under always and never (phase 6's limits) and its text encode with
     the LSTM kernels and without (the cache within phase 4's limit, the
     gradients' cosine above phase 6's floor), not counted, and one
     MultiDicEncoder forward (3 sentences x B 20, the headline width) with
     the LSTM kernel and without, within phase 4's limit.
  18. ndh — NDH at headline width (``--train ndh --history all
     --path_type trusted_path``: max_input 300, max_action 40, batch 20,
     bf16, ``use_pallas="always"``) over CVDN dialogs written on a
     synthetic world (``testing.write_ndh_task``, every instruction
     filling the 300 tokens): the launch counters set to 0, ``train()``
     (2 episodic iterations), ``valid()`` of both val splits (the
     ``validndh`` path) and one stream window, the counters read back.
     Fails unless K1-K4 launched, the losses are finite, the trained
     components moved and every instr_id was evaluated once; prints s an
     iteration, agent-steps/s of ``valid()`` (an untrained policy stops
     after a few of the 40 steps) and the peak memory.  Then the teacher
     pass under always and never (loss within 1%, gradient cosine above
     0.999), not counted.
  19. knobs — on the headline episodic pair (batch 20): 2 iterations of
     ``accumulate_gradient("sample")`` under ``bench.py``'s episodic
     default ``fuse_passes="auto"``, which the port runs as the split
     pair (s an iteration; fails unless two passes an iteration ran); one
     sampled pass of that agent under each ``remat`` mode from the same
     generator state (gradients within 1e-3
     relative L2 of never's, s a pass, peak memory); phase 17's BertImg
     and mcatt sampled passes under remat never and percept (the peak
     memory).  The counters are set to 0 before each run and summed.
  20. dp — data parallel (``parallel/``): (a) a one-rank NCCL job
     through the launcher's variables (``COORDINATOR_ADDRESS``,
     ``NUM_PROCESSES=1``): the launch counters set to 0, ``train()`` with
     ``data_parallel`` at headline width, 2 episodic iterations and then 2
     stream windows of the same agent, each run ending in the rank-0
     checkpoint, the counters read back; fails unless K1-K4 launched, the
     losses are finite and the checkpoint exists.  (b) Two gloo ranks on
     the one card (NCCL refuses two ranks on one device), processes of
     this script (``--dp-worker``) at batch 20, 10 rows a rank, dropout
     off: the teacher + fused argmax pair from the initial weights against
     one rank at batch 20 (losses within 1e-4, gradient cosine >= 0.9999,
     gradient norms within 1e-3, update cosine >= 0.995: ``DP_*``; the
     argmax paths counted), a timed second pair, two stream windows in
     which no episode is taken twice across the ranks, and 2 pretraining
     steps against one rank (losses within 1e-4, each step's gradient
     norm within 1e-3, update cosine >= 0.9999); fails unless K1-K4
     launched on each rank.  Prints s an iteration, s a window and s a
     pretraining step a rank, and each rank's peak memory.
  21. offline — the depth pipeline: the 36 views (480 x 640) of 2
     panoramas rendered by ``sim/render.py`` from seeded skybox faces;
     ResNet-152 from ``--seed`` in bf16 on one viewpoint's views against
     the same network in f32 (each view's 2048 features at cosine >=
     0.99); every viewpoint of the val_unseen scan featurized
     (``featurize_views``, batch 36; the other viewpoints turn the
     rendered headings); ms a viewpoint, images/s, peak memory and the
     bound (the convolutions' operations at 989 TF/s); the npy pair read
     back as that split's ``depth_db`` and one ``valid()`` batch on it.
  22. native — the native sim engine (``sim/native/dasasim.cpp``, built
     by ``make`` when the world's envs were made): every candidate set of
     the scan, the observations of a teacher walk and the host-rollout
     evaluation of val_unseen (trajectories, SR, SPL) equal to the
     python engine's, with the host seconds of each evaluation.
  23. scripts — the repo's operational scripts on the port
     (``dasa_tpu_torch/scripts``), through their ``main`` on a synthetic
     world with a ``scans.txt``: (a) ``make_task``; a speaker at its
     Config widths trained 2 iterations at batch 64 and saved;
     ``make_aug_paths --load`` of it (up to 64 new 4-6 hop paths of the
     train scan, greedy decode at batch 64); one headline ``auglistener``
     iteration with ``--aug`` on the written file.  Fails unless every
     sampled path is written and captioned once, every written item loads,
     K1 launched during the decode and K1-K4 in the iteration; prints the
     decode s a batch of 64.  (b) ``check_real_data`` on TSV image
     features, an explicit vocab and that listener's weights in the
     reference's per-component layout (``adaIn``): fails unless it prints
     ``READY:``, each split's SR and SPL equal a ``valid()`` by the saving
     listener, every instr_id is scored once, K1, K3 and K4 launched, and
     a copy without ``R2R_val_unseen.json`` exits 1 with ``FAILED:``;
     prints s a split.  (c) ``stream_quality_ab`` at headline width
     (``--regimes episodic,stream --total_steps 4000 --n_milestones 2
     --use_pallas always --save_dir``): fails unless both regimes reach
     both milestones, every row holds both val splits, the JSON, the table
     and each regime's listener are written and K1-K4 launched; prints SR
     / SPL a milestone and s a regime (SR is reported, not gated; the
     agent-step counter counts the validations' steps too, as the JAX
     script's does).  The counters are set to 0 before each script and
     summed.
  profile (only when named in --phases) — one eval batch, one training
     iteration, one stream window, one selfTrain iteration, one search
     batch, one host-rollout iteration and one pretraining step at
     headline width under torch.profiler, each after a warm-up: device
     time by kernel, the device's busy share of the wall.
Each phase ends with its wall time, in parentheses, and the run with its
whole wall time.
Then one ``{"kernels": [...]}`` JSON line (``launches``: the count during
``train()``; ``launches_eval``: during ``valid()``; ``launches_stream``:
during ``train()`` under stream; ``launches_speaker``: during phase 9;
``launches_selftrain``: during phase 11; ``launches_host``: during phase
12; ``launches_search``: during phase 13's searches;
``launches_pretrain_chain``: during phase 15; ``launches_variants``:
during phase 16's runs; ``launches_encoders``: during phase 17's runs;
``launches_ndh``: during phase 18's runs; ``launches_knobs``: during
phase 19's runs; ``launches_dp``: during phase 20 (a)'s ``train()``;
``launches_dp_ranks``: each rank's during phase 20 (b);
``launches_scripts``: during phase 23's scripts;
``ratio``: ``ms`` /
``library_ms``; ``device_ms`` / ``library_device_ms``: the back-to-back
device times), and as the last line
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
no phase is caught and ignored.  Imports nothing of JAX or dasa_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, bf16 tensor-core
# flop/s.  Bounds are stated against these with the card's power limit.
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12

# headline DASA config (bench.py:168-226), evaluation only
HEADLINE = dict(
    encoder_type="Dic", include_vision=True, adain_type="channel",
    ab_type="a", a_type="sigmoid", use_shift=True, shift_kernel_size=5,
    angle_feat_size=128, feature_size=2048, d_enc_hidden_size=1024,
    d_hidden_size=1024, critic_dim=1024, d_vl_layers=3, d_la_layers=9,
    max_input=80, max_action=35, batch_size=20, compute_dtype="bfloat16")
# its training settings (bench.py:168-226) in the episodic regime, one
# teacher-ML pass + one sampled A2C pass per iteration
TRAIN = dict(
    depth_drop=True, consistent_drop=True, env_drop_stage="after_adain",
    featdropout=0.4, optim="rms", lr=1e-4, use_lr_scheduler=True,
    ml_weight=0.2, feedback="sample", rollout_mode="episodic",
    fuse_passes="never", remat="never")
TRAIN_ITERS = 4
# the stream regime: 2B = 40 slots, S = max_action = 35 steps a window,
# the pool sized from the mean path length (agents/stream.py)
STREAM_W = 2 * HEADLINE["batch_size"]
STREAM_WINDOWS = 4
# the speaker at its Config widths (rnn_dim 512: a BiLSTM of 256 a
# direction; input feature_all_size 2176; teacher paths of at most
# max_action 35 steps), trained at the Config default batch of 64
SPK_T, SPK_H, SPK_E, SPK_B = 35, 256, 2176, 64
SPEAKER = dict(rnn_dim=512, wemb=256, max_decode=120, bidir=True,
               featdropout=0.4, optim="rms", lr=1e-4)
SPK_ITERS = 4
# the README's headline command: auglistener + selfTrain on the aug split
SELFTRAIN_STEPS = 3
SPEAKER_KERNELS = ("bilstm_scan", "lstm_scan_bwd")
# the host phase: train() under device_rollout="never", and selfTrain
# under stream through the host fallback
HOST_ITERS = 3
HOST_SELFTRAIN_STEPS = 2
# the listener's trained components (BERT is frozen), and the settings of
# the dropout-free comparisons
TRAINED = ("encoder.lstm.", "decoder.", "critic.", "adain.")
NO_DROPOUT = dict(dropout=0.0, featdropout=0.0, d_dropout_ratio=0.0,
                  d_hidden_dropout_prob=0.0, d_attn_dropout_prob=0.0)
# pretraining: steps of run_pretrain, its warm-up (steps 2..10 move the
# weights), and the bf16 model's limits against its f32 copy: the loss
# (relative), the logits (against the f32 logits' largest magnitude) and
# their argmax agreement (a share of the rows)
PRETRAIN_STEPS = 10
PRETRAIN_WARM = 2
PRETRAIN_BF16_RTOL = 2e-3
PRETRAIN_LOGIT_RTOL = 5e-2
PRETRAIN_ARGMAX_AGREE = 0.95
CHAIN_ITERS = 2
BERT_VOCAB = 30522
# the speaker's rescoring of one search path at a time: K1 at one row over
# the path's moves (1 up to max_action 35)
RSC_T = (1, 2, 8, 35)
# the wrappers the main path launches (lstm_scan, K1's one-direction
# entry, is timed in phase 2 but not on the path: the BiLSTM takes both
# directions in one launch)
EVAL_KERNELS = ("bilstm_scan", "adain_channel_gate", "shift_attend")
PATH_KERNELS = ("bilstm_scan", "lstm_scan_bwd", "adain_channel_gate",
                "shift_attend")

# phase 16: the DASA variants on the Dic listener, paired so that every
# agent type and every AdaIN type is built once: (label, overrides, the
# auxiliary logs that must be nonzero, the kernels that must launch (the
# others must not), extra runs).  K4 runs only in the BAttn decoder's
# shift attention (configurations 1 and 2; the double decoder takes none),
# K3 only under channel / rgb_channel with ab_type a and sigmoid.
K12 = ("bilstm_scan", "lstm_scan_bwd")
VARIANTS = (
    ("1 heads+dyrelu", dict(adain_type="channel", ab_type="a",
                            a_type="sigmoid", pred_back=True,
                            back_input="pre", pred_pm=True,
                            pm_type="att_hid", decoder_type="dyrelu"),
     ("back_loss", "pm_loss"),
     K12 + ("adain_channel_gate", "shift_attend"),
     ("stream", "host", "compare")),
    ("2 gumbel+uni+ctx_v", dict(adain_type="channel", ab_type="ab",
                                a_type="gumbel_sigmoid", pred_back=True,
                                back_input="cur", pred_pm=True,
                                pm_type="plain_att", d_bidirectional=False,
                                ctx_v=True),
     ("back_loss", "pm_loss"), ("lstm_scan", "lstm_scan_bwd",
                                "shift_attend"), ()),
    ("3 double+coco", dict(agent_type="double", adain_type="coco_channel",
                           ab_type="ab", a_type="sigmoid"), (), K12, ()),
    ("4 advanced+mean", dict(agent_type="advanced",
                             adain_type="meanchannel"), ("pm_loss",), K12,
     ()),
    ("5 kvmem+rgb_mean+back", dict(agent_type="kvmem",
                                   adain_type="rgb_meanchannel",
                                   pred_back=True), ("back_loss",), K12, ()),
    ("6 new+depth_stat", dict(agent_type="new",
                              adain_type="depth_stat_channel"), (), K12, ()),
    ("7 mutan+rgb_stat", dict(agent_type="mutan",
                              adain_type="rgb_stat_channel"), (), K12, ()),
    ("8 mt+rgb_channel", dict(agent_type="mt", adain_type="rgb_channel",
                              ab_type="a", a_type="sigmoid"), ("kl_loss",),
     K12 + ("adain_channel_gate",), ("stream",)),
)
VARIANT_ITERS = 1

# phase 17: the encoder zoo.  The plain encoders and mcatt at the Config
# defaults, which are the R2R baseline listener's (batch 64, rnn_dim 512,
# wemb 256, aemb 64, dropout 0.5, featdropout 0.3, no AdaIN, angle
# features 4 wide; the MCAN at 768 wide, 2 layers, 8 heads); the legacy
# cross encoders on the headline listener (its BERT, decoder and AdaIN,
# batch 20).  (label, overrides, the kernels that must launch (the others
# must not), extra runs); K3 runs only under the channel AdaIN, K4 only in
# the BAttn decoder's shift attention.
PLAIN = dict(encoder_type="EncoderLSTM", include_vision=False,
             adain_type="none", use_shift=False, angle_feat_size=4,
             critic_dim=512, dropout=0.5, featdropout=0.3, depth_drop=False,
             consistent_drop=False, batch_size=64)
ENC_ALL = K12 + ("adain_channel_gate", "shift_attend")
ENCODERS = (
    ("1 EncoderLSTM", dict(PLAIN), K12, ("stream", "host", "search",
                                         "compare")),
    ("2 EncoderLSTM uni+max+zero+channel",
     dict(PLAIN, bidir=False, sub_out="max", zero_init=True,
          adain_type="channel", ab_type="a", a_type="sigmoid"),
     ("lstm_scan", "lstm_scan_bwd", "adain_channel_gate"), ()),
    ("3 BEncoder", dict(PLAIN, encoder_type="BEncoder", d_bert_n_layers=2),
     K12, ()),
    ("4 CEncoder", dict(PLAIN, encoder_type="CEncoder", update_bert=True),
     K12, ()),
    ("5 Transformer", dict(PLAIN, encoder_type="Transformer"), K12, ()),
    ("6 Gpt", dict(PLAIN, encoder_type="Gpt"), K12, ()),
    ("7 BertImg", dict(encoder_type="BertImg"), ENC_ALL, ()),
    ("8 BertAdd", dict(encoder_type="BertAdd"), ENC_ALL, ("stream",)),
    ("9 BertMix", dict(encoder_type="BertMix"), ENC_ALL, ()),
    ("10 mcatt", dict(PLAIN, encoder_type="Dic", include_vision=True,
                      agent_type="mcatt"), K12, ()),
)
ENCODER_ITERS = 1
MULTI_S = 3  # MultiDicEncoder's sentences a row
# phase 2's rows of the encoder zoo's LSTMs (tag, kernel_rows_lstm's
# arguments): EncoderLSTM / B/CEncoder / Transformer / Gpt at rnn_dim 512
# (256 a direction, ragged, input wemb 256 or a 2-layer concat's 1536; the
# row takes 256), their one-direction form (512), McattEncoder's BiLSTM
# (768 / 2 = 384 a direction) at batch 64, and the legacy cross encoders'
# tail over the joint [36 views; 80 tokens] sequence at the headline
# width, at the episodic batch and the stream window's 2B slot rows
ENC_ROWS = (
    ("enc,B64", dict(B=64, H=256, E=256, one_dir=False)),
    ("enc1,B64", dict(B=64, H=512, E=256, one_dir=True, two_dir=False)),
    ("mcan,B64", dict(B=64, H=384, E=256, one_dir=False)),
    ("joint,B20,T116", dict(B=20, T=116, H=1024, E=768, one_dir=False)),
    ("joint,B40,T116", dict(B=40, T=116, H=1024, E=768, one_dir=False)),
)

# phase 2's rows of this slice: K1 and K2 at NDH's 300-token dialogs (the
# headline top BiLSTM, H 1024 a direction) at the episodic batch, and at 64
# rows in the chunks the plans allow (the stream window's text encode)
NDH_T = 300
SLICE_ROWS = (
    ("ndh,B20,T300", dict(B=20, T=NDH_T, H=1024, E=768, one_dir=False)),
    ("ndh,B64,T300", dict(B=64, T=NDH_T, H=1024, E=768, one_dir=False)),
)
# phase 18: NDH at the headline width (--train ndh --history all
# --path_type trusted_path: max_input 300, max_action 40), dialogs of about
# 330 words so that every instruction fills the 300 tokens
NDH = dict(max_input=NDH_T, max_action=40, path_type="trusted_path",
           history="all")
NDH_WORDS = 330
NDH_ITERS = 2
# phase 19: the JAX knobs on the headline episodic pair
KNOB_ITERS = 2
REMAT_MODES = ("never", "percept", "dots", "auto", "always")
REMAT_RTOL = 1e-3

# phase 20: data parallel; iterations and windows of the one-rank NCCL
# job, pretraining steps of the two gloo ranks, their time limit
DP_ITERS = 2
DP_TIMEOUT = 600
DP_B = HEADLINE["batch_size"] // 2  # a rank's rows at D = 2
# phase 20 (b)'s limits, D = 2 against one rank at batch 20 (my chip runs:
# sound runs read losses within 1.4e-7, gradient cosine 0.999982, update
# cosine 0.998161; a run drawing different batches on the two sides read
# a gradient cosine of 0.988578).  The cosines do not see scale, and the
# first RMSprop / AdamW step does not either: the gradient norms do (x2 or
# x0.5 for gradients summed twice or averaged).  The update cosine of the
# first RMSprop step is rounding-limited: it divides every gradient by its
# own size, so entries that are bf16 noise on both sides flip sign.
DP_LOSS_RTOL = 1e-4
DP_GRAD_COS = 0.9999
DP_NORM_RTOL = 1e-3
DP_UPDATE_COS = 0.995
# phase 21: the offline pipeline; panoramas rendered (the other viewpoints
# turn their headings), the skybox face size, the bf16 / f32 cosine floor
OFFLINE_RENDERED = 2
OFFLINE_FACE = 256
OFFLINE_COS = 0.99
# phase 23: the operational scripts; make_task's split sizes (the train
# split's 3 instructions an item exceed the speaker's batch of 64), the
# speaker's training iterations before make_aug_paths, the paths it
# samples a train scan, and stream_quality_ab's agent-steps (2 milestones)
SCRIPT_N_TRAIN = 30
SCRIPT_N_VAL = 10
SCRIPT_SPK_ITERS = 2
SCRIPT_AUG_PATHS = 64
SCRIPT_AB_STEPS = 4000
KERNEL_INFO = {
    "bilstm_scan": ("dasa_tpu_torch/csrc/lstm_fwd.cu",
                    "dasa_tpu/ops/lstm.py:38 (_fwd_kernel)"),
    "lstm_scan": ("dasa_tpu_torch/csrc/lstm_fwd.cu",
                  "dasa_tpu/ops/lstm.py:38 (_fwd_kernel)"),
    "lstm_scan_bwd": ("dasa_tpu_torch/csrc/lstm_bwd.cu",
                      "dasa_tpu/ops/lstm.py:65 (_bwd_kernel)"),
    "adain_channel_gate": ("dasa_tpu_torch/csrc/adain_gate.cu",
                           "dasa_tpu/ops/adain.py:36 (_kernel)"),
    "shift_attend": ("dasa_tpu_torch/csrc/shift_attend.cu",
                     "dasa_tpu/ops/shift_attention.py:64 (_kernel_body)"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, iters: int = 10, warmup: int = 3, reps: int = 3) -> float:
    """Device time per call: ``iters`` calls back to back behind a GPU
    sleep long enough for the host to enqueue them all, so that no call
    waits on the host; CUDA events around the run, the median of ``reps``
    runs, after warm-up.  (:func:`time_ms`'s events around one call also
    count the host's launch work, longer than the short kernels.)"""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(3):
        fn()
    host_s = (time.perf_counter() - start) / 3
    torch.cuda.synchronize()
    cycles = int(host_s * iters * 1.5 * 2.0e9)  # SM clock <= 2 GHz
    times = []
    for _ in range(reps):
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        begin.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(begin.elapsed_time(end) / iters)
    return statistics.median(times)


def bound_ms(n_bytes: float, flops: float):
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_BF16 * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def check_close(name, got, ref, atol, rtol):
    """max |got - ref| against atol + rtol * max |ref| (all f32)."""
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape:
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    if not bool(got.isfinite().all()):
        fail(f"{name}: non-finite output")
    err = float((got - ref).abs().max())
    limit = atol + rtol * float(ref.abs().max())
    print(f"  {name}: max_abs_err {err:.3e} (limit {limit:.3e})", flush=True)
    if not err <= limit:
        fail(f"{name}: max_abs_err {err} > {limit}")
    return err


def phase_build():
    from dasa_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    start = time.perf_counter()
    path = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - start:.1f} s -> {path.name}",
          flush=True)
    log = path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if ("registers" in line or "spill" in line or "entry function"
                    in line or line.startswith("==")):
                print(f"  {line.strip()}")
    return card


def phase_kernels(seed: int):
    """Each kernel at its headline shapes against its plain version: the
    episodic batch (B = 20), a rank's rows of it at D = 2 (10) and the
    stream window's slot rows (2B = 40)."""
    import torch

    from dasa_tpu_torch.ops import _build

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(seed)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, bf)

    n_sm = _build.sm_count(torch.empty(1, device=dev))
    rows = []
    start = time.perf_counter()
    for B, tag in ((20, ""), (DP_B, f"dp,B{DP_B}"),
                   (STREAM_W, f"B{STREAM_W}")):
        k1, k2, (mask, wh, mask2, wh2) = kernel_rows_lstm(rnd, gen, B, n_sm,
                                                          tag)
        k3, (w_t, bias) = kernel_rows_adain(rnd, gen, B, n_sm, tag)
        k4, (w_in, w_s, b_s) = kernel_rows_shift(rnd, B, n_sm, tag)
        rows += k1 + k2 + k3 + k4
        if B == STREAM_W:  # BiLstmScanFn one launch a direction
            check_bilstm_fn_grads(rnd, mask2, wh2, "BiLstmScanFn B40")
            check_lstm_fn_grads(rnd, mask, wh, "LstmScanFn B40")
        else:
            check_function_grads(rnd, mask, wh, w_t, bias, w_in, w_s, b_s,
                                 mask2, wh2, tag)
    # the speaker's BiLSTMs: selfTrain's relabel (B = 20, both directions
    # in one launch) and speaker training (B = 64, one launch a direction)
    for B in (20, SPK_B):
        tag = "spk" if B == 20 else f"spk,B{B}"
        k1, k2, (_mask, _wh, mask2, wh2) = kernel_rows_lstm(
            rnd, gen, B, n_sm, tag, T=SPK_T, H=SPK_H, E=SPK_E, ragged=False)
        rows += k1 + k2
        check_bilstm_fn_grads(rnd, mask2, wh2, f"BiLstmScanFn {tag}")
    # K3 at phase 17's batch of 64 (the channel-AdaIN EncoderLSTM): 2304
    # panorama rows, 1024 candidate rows
    k3, _ = kernel_rows_adain(rnd, gen, PLAIN["batch_size"], n_sm,
                              f"B{PLAIN['batch_size']}")
    rows += k3
    # the encoder zoo's LSTMs (phase 17), each with its autograd Function
    for tag, kw in ENC_ROWS:
        k1, k2, (mask, wh, mask2, wh2) = kernel_rows_lstm(rnd, gen, n_sm=n_sm,
                                                          tag=tag, **kw)
        rows += k1 + k2
        if kw.get("two_dir", True):
            check_bilstm_fn_grads(rnd, mask2, wh2, f"BiLstmScanFn {tag}")
        else:
            check_lstm_fn_grads(rnd, mask, wh, f"LstmScanFn {tag}")
    # this slice's rows: NDH's 300 tokens (B 20 in one launch, B 64 in the
    # plan's chunks)
    for tag, kw in SLICE_ROWS:
        k1, k2, (_mask, _wh, mask2, wh2) = kernel_rows_lstm(
            rnd, gen, n_sm=n_sm, tag=tag, **kw)
        rows += k1 + k2
        check_bilstm_fn_grads(rnd, mask2, wh2, f"BiLstmScanFn {tag}")
    # the speaker's rescoring of a search path: one row, T its moves
    for T in RSC_T:
        k1, _k2, _ = kernel_rows_lstm(rnd, gen, 1, n_sm, f"rsc,T{T}", T=T,
                                      H=SPK_H, E=SPK_E, ragged=False,
                                      bwd=False)
        rows += k1
    print(f"  (the checks against the plain versions: "
          f"{time.perf_counter() - start:.1f} s)", flush=True)
    start = time.perf_counter()
    for r in rows:
        fn, lib_fn = r.pop("fn"), r.pop("library_fn")
        # K1 and its cuDNN forward under no_grad; K2's yardstick is a
        # backward
        with torch.set_grad_enabled(r["name"].startswith("lstm_scan_bwd")):
            r["ms"], r["device_ms"] = time_ms(fn), device_ms(fn)
            r["library_ms"], r["library_device_ms"] = (
                (None, None) if lib_fn is None
                else (time_ms(lib_fn), device_ms(lib_fn)))
        r["ratio"] = (None if r["library_ms"] is None
                      else r["ms"] / r["library_ms"])
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms ({r['library_call']}), "
                    f"kernel / library {r['ratio']:.3f}; device time "
                    f"{r['library_device_ms']:.4f} ms, kernel / library "
                    f"{r['device_ms'] / r['library_device_ms']:.3f}")
        print(f"  {r['name']} [{r['shape']}]: kernel {r['ms']:.4f} ms "
              f"(device time {r['device_ms']:.4f} ms), plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), library {lib}", flush=True)
        if "tokens" in r:
            r["us_per_token"] = r["device_ms"] * 1e3 / r.pop("tokens")
            print(f"  {r['name']} per token: {r['us_per_token']:.3f} us of "
                  "device time", flush=True)
    print(f"  (the timings: {time.perf_counter() - start:.1f} s)", flush=True)
    return rows


def _named(base, tag, *more):
    inner = ",".join(x for x in (*more, tag) if x)
    return f"{base}[{inner}]" if inner else base


def kernel_rows_lstm(rnd, gen, B, n_sm, tag, T=80, H=1024, E=768,
                     ragged=True, bwd=True, one_dir=None, two_dir=True):
    """K1 (one direction untagged and tagged ``B40``, or where ``one_dir``
    says: the listener's top LSTM under ``d_bidirectional=False``; both
    directions, with and without the gate activations, unless
    ``two_dir`` is off) and, with ``bwd``, K2 at batch B, T tokens, H
    units a direction: the listener's top BiLSTM (T 80, H 1024, input 768,
    ragged lengths) or, tagged ``spk``, the speaker's (T 35, H 256, input
    2176, every token valid); tagged ``rsc``, the speaker's rescoring of
    one search path (B 1, forward only); tagged ``enc``, ``enc1``,
    ``mcan`` and ``joint``, the encoder zoo's LSTMs (:data:`ENC_ROWS`)."""
    import torch

    from dasa_tpu_torch.ops.lstm import (
        _fwd_ref,
        bilstm_scan,
        bilstm_scan_ref,
        fwd_plan,
        lstm_scan,
        lstm_scan_bwd,
        lstm_scan_bwd_ref,
        lstm_scan_ref,
        bwd_plan,
        row_chunks,
    )

    dev, bf = torch.device("cuda"), torch.bfloat16
    rows = []
    # more rows than one launch takes at this T run in near-equal chunks,
    # as bilstm_scan_fn / lstm_scan_fn split them (ops/lstm.py)
    n_chunks = row_chunks(B, T, H, 2, n_sm)
    parts = [slice(int(ix[0]), int(ix[-1]) + 1)
             for ix in torch.arange(B).tensor_split(n_chunks)]
    bc = parts[0].stop - parts[0].start  # the largest chunk's rows

    def in_chunks(fn, args, axes):
        """fn over the row chunks of ``args`` (each sliced on its axis in
        ``axes``, None for a weight), outputs joined on their row axis."""
        outs = [fn(*(a if ax is None else a[(slice(None),) * ax + (s,)]
                     for a, ax in zip(args, axes))) for s in parts]
        return tuple(torch.cat(o, dim=ax) for o, ax in zip(
            zip(*outs), [axes[0]] * len(outs[0])))

    def bi(with_acts=False):
        return in_chunks(
            lambda *a: bilstm_scan(*a, with_acts=with_acts),
            (xw2, mask2, h02, c02, wh2), (2, 2, 1, 1, None))
    # the reverse direction runs on the flipped sequence, so its masked
    # tokens come first
    lengths = (torch.randint(20, T + 1, (B,), generator=gen) if ragged
               else torch.full((B,), T))
    mask = (torch.arange(T)[:, None] < lengths[None, :]).to(dev, bf)
    mask2 = torch.stack([mask, mask.flip(0)])
    xw2 = rnd(2, T, B, 4 * H, scale=0.5)
    h02, c02 = rnd(2, B, H, scale=0.1), rnd(2, B, H, scale=0.1)
    wt2 = rnd(2, 4 * H, H, scale=1.0 / math.sqrt(3 * H))  # weight_hh x 2
    wh2 = wt2.transpose(1, 2)
    xw, h0, c0, wh = xw2[0], h02[0], c02[0], wh2[0]
    # bf16(h) feeds every product, so one-ulp differences in a token's
    # rounding (2^-8 relative) propagate through the 80-step chain
    got2 = bi(with_acts=True)
    torch.cuda.synchronize()
    ref2 = bilstm_scan_ref(xw2, mask2, h02, c02, wh2)
    err2 = max(check_close(_named("bilstm_scan h_seq", tag), got2[0], ref2[0],
                           2e-2, 0.0),
               check_close(_named("bilstm_scan c_seq", tag), got2[1], ref2[1],
                           2e-2, 1e-2),
               check_close(_named("bilstm_scan acts", tag), got2[2], ref2[2],
                           2e-2, 0.0))
    # the listener's top LSTM in one direction (d_bidirectional=False)
    if one_dir is None:
        one_dir = tag in ("", "B40")
    if one_dir:
        hk, ck, ak = lstm_scan(xw, mask, h0, c0, wh, with_acts=True)
        torch.cuda.synchronize()
        hr, cr, ar = _fwd_ref(xw, mask, h0, c0, wh)
        err = max(check_close(_named("lstm_scan h_seq", tag), hk, hr, 2e-2,
                              0.0),
                  check_close(_named("lstm_scan c_seq", tag), ck, cr, 2e-2,
                              1e-2),
                  check_close(_named("lstm_scan acts", tag), ak, ar, 2e-2,
                              0.0))
    else:
        ck, ak = got2[1][0], got2[2][0]
    for dirs in (1, 2):
        p = fwd_plan(T, bc, H, n_sm, dirs)
        print(f"  lstm_fwd T={T} B={B} ({n_chunks} chunk(s) of at most {bc} "
              f"rows), {dirs} direction(s): {p.launches} launch(es) a chunk "
              f"of {p.ctas} CTAs of {p.units} units, {p.smem} bytes of "
              "shared memory", flush=True)
    # torch does not flatten bf16 cuDNN weights (it warns): each call
    # compacts them first, a ~15 MB copy
    lstm_cudnn = torch.nn.LSTM(E, H, device=dev, dtype=bf)
    bilstm_cudnn = torch.nn.LSTM(E, H, device=dev, dtype=bf,
                                 bidirectional=True)
    x_in = rnd(T, B, E).requires_grad_()
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        x_in, lengths, enforce_sorted=False)
    n_bytes = 2 * (xw.numel() + mask.numel() + 2 * h0.numel() + wh.numel()
                   + 2 * T * B * H)
    b_ms, b_by = bound_ms(n_bytes, 2.0 * T * B * H * 4 * H)
    b2_ms, b2_by = bound_ms(2 * n_bytes, 2 * 2.0 * T * B * H * 4 * H)
    b2a_ms, b2a_by = bound_ms(2 * n_bytes + 2 * xw2.numel(),
                              2 * 2.0 * T * B * H * 4 * H)
    cudnn = (f"torch.nn.LSTM (cuDNN) on a PackedSequence, input {E} "
             "(includes the input projection)")
    shape = f"T{T} B{B} H{H}" + (f" in {n_chunks} row chunks" if n_chunks > 1
                                  else "")
    with torch.no_grad():
        if one_dir:
            rows.append(dict(
                name=_named("lstm_scan", tag),
                shape=f"{shape} (one direction)", max_abs_err=err, tokens=T,
                fn=lambda: lstm_scan(xw, mask, h0, c0, wh),
                plain_ms=time_ms(lambda: lstm_scan_ref(xw, mask, h0, c0, wh),
                                 iters=5, warmup=1),
                library_fn=lambda: lstm_cudnn(packed), library_call=cudnn,
                bound_ms=b_ms, bound_by=b_by))
        plain2 = (time_ms(lambda: bilstm_scan_ref(xw2, mask2, h02, c02, wh2),
                          iters=3, warmup=1) if two_dir else None)
        rows.extend([] if not two_dir else [dict(
            name=_named("bilstm_scan", tag),
            shape=f"2 x {shape} (both directions)",
            max_abs_err=err2, tokens=T,
            fn=bi, plain_ms=plain2, library_fn=lambda: bilstm_cudnn(packed),
            library_call="bidirectional " + cudnn,
            bound_ms=b2_ms, bound_by=b2_by), dict(
            name=_named("bilstm_scan", tag, "acts"),
            shape=f"2 x {shape} with the gate activations (training)",
            max_abs_err=err2, tokens=T,
            fn=lambda: bi(with_acts=True),
            plain_ms=plain2, library_fn=None, library_call=None,
            bound_ms=b2a_ms, bound_by=b2a_by)])
        if not tag:
            two = [lambda d=d: lstm_scan(xw2[d], mask2[d], h02[d], c02[d],
                                         wh2[d], with_acts=True)
                   for d in range(2)]
            pair = device_ms(lambda: [f() for f in two])
            print(f"  lstm_scan, both directions as two launches with acts: "
                  f"device time {pair:.4f} ms", flush=True)

    if not bwd:
        return rows, [], (mask, wh, mask2, wh2)
    # K2: the backward of direction 0; h_seq's cotangent at every token,
    # c_seq's only at the last (the final carry feeds the decoder)
    c_prev = torch.cat([c0[None], ck[:-1]])
    g_h = rnd(T, B, H, scale=0.05)
    g_c = torch.zeros_like(g_h)
    g_c[-1] = rnd(B, H, scale=0.05)
    bwd_args = (ak, c_prev, g_h, g_c, mask, wh)

    def bwd():
        outs = [lstm_scan_bwd(*(a[:, s] for a in bwd_args[:5]), wh)
                for s in parts]
        return (torch.cat([o[0] for o in outs], 1),
                torch.cat([o[1] for o in outs], 0),
                torch.cat([o[2] for o in outs], 0))

    got = bwd()
    torch.cuda.synchronize()
    ref = lstm_scan_bwd_ref(*bwd_args)
    # the same f32 arithmetic per token; the bf16 dgates of a token can
    # round one ulp apart and carry on through the reverse chain
    err = max(check_close(_named(f"lstm_scan_bwd {key}", tag), g_, r_, 0.0,
                          2e-2)
              for key, g_, r_ in zip(("dxw", "dh0", "dc0"), got, ref))
    out_c, _ = lstm_cudnn(packed)
    go = rnd(*out_c.data.shape, scale=0.05)
    lib_inputs = [x_in, *lstm_cudnn.parameters()]
    n_bytes = (2 * (ak.numel() + 3 * g_h.numel() + mask.numel() + wh.numel()
                    + ak.numel()) + 4 * 2 * B * H)
    b_ms, b_by = bound_ms(n_bytes, 2.0 * T * B * H * 4 * H)
    plan = bwd_plan(T, bc, H, n_sm)
    print(f"  lstm_scan_bwd T={T} B={B} ({n_chunks} chunk(s) of at most "
          f"{bc} rows): {plan.ctas} CTAs (no clusters), "
          f"{plan.stages} stages of {plan.kc} columns, {plan.smem} bytes of "
          "shared memory", flush=True)
    k2 = [dict(
        name=_named("lstm_scan_bwd", tag), shape=f"{shape} (one direction)",
        max_abs_err=err, tokens=T, fn=bwd,
        plain_ms=time_ms(lambda: lstm_scan_bwd_ref(*bwd_args), iters=5,
                         warmup=1),
        library_fn=lambda: torch.autograd.grad(
            out_c.data, lib_inputs, go, retain_graph=True),
        library_call="backward of the torch.nn.LSTM (cuDNN) call above "
                     "(includes the input-projection grads)",
        bound_ms=b_ms, bound_by=b_by)]
    return rows, k2, (mask, wh, mask2, wh2)


def kernel_rows_adain(rnd, gen, B, n_sm, tag):
    """K3, the AdaIN gate, on the panorama (36 B rows) and the candidates
    (16 B rows)."""
    import torch

    from dasa_tpu_torch.ops.adain import (
        adain_channel_gate,
        adain_channel_gate_ref,
        adain_plan,
    )

    dev, bf = torch.device("cuda"), torch.bfloat16
    C = 2048
    w_t = rnd(C, C, scale=1.0 / math.sqrt(C))           # torch a_fc.weight
    bias = rnd(C, scale=0.1)
    rows = []
    for label, n in (("pano", B * 36), ("cand", B * 16)):
        f = rnd(B, n // B, C).relu()
        d = rnd(B, n // B, C).relu()
        out = adain_channel_gate(f, d, w_t.t(), bias)
        torch.cuda.synchronize()
        ref = adain_channel_gate_ref(f, d, w_t.t(), bias)
        # f32 accumulation in both; the outputs round to bf16 once
        name = _named("adain_channel_gate", tag, label)
        e1 = check_close(name, out, ref, 1e-2, 1e-2)
        noise = (torch.rand(C, generator=gen) > 0.4).to(dev, bf) / 0.6
        e2 = check_close(f"{name} noise",
                         adain_channel_gate(f, d, w_t.t(), bias, noise),
                         adain_channel_gate_ref(f, d, w_t.t(), bias, noise),
                         1e-2, 1e-2)
        w_kc = w_t.t().contiguous()
        n_bytes = 2 * (f.numel() + d.numel() + w_t.numel() + 2 * C
                       + f.numel())
        b_ms, b_by = bound_ms(n_bytes, 2.0 * n * C * C)
        d2 = d.reshape(n, C)
        k3 = adain_plan(n, C, C, n_sm)
        print(f"  {name}: tiles 128x{k3.bn}, grid {k3.grid}, {k3.stages} "
              "stages", flush=True)
        rows.append(dict(
            name=name, shape=f"{n}x{C} @ {C}x{C}",
            max_abs_err=max(e1, e2),
            fn=lambda f=f, d=d: adain_channel_gate(f, d, w_t.t(), bias),
            plain_ms=time_ms(
                lambda f=f, d=d: adain_channel_gate_ref(f, d, w_t.t(), bias)),
            library_fn=lambda d2=d2, w_kc=w_kc: torch.addmm(bias, d2, w_kc),
            library_call="torch.addmm, the bare GEMM (a floor)",
            bound_ms=b_ms, bound_by=b_by))
    return rows, (w_t, bias)


def kernel_rows_shift(rnd, B, n_sm, tag):
    """K4, the shift attention: 36 views, C = 2176, H = 1024, k = 5."""
    import torch

    from dasa_tpu_torch.ops.shift_attention import (
        shift_attend,
        shift_attend_ref,
        shift_plan,
    )

    H, Cf, ks = 1024, 2176, 5
    h = rnd(B, H, scale=0.5)
    ctx = rnd(B, 36, Cf).relu()
    w_in = rnd(Cf, H, scale=1.0 / math.sqrt(H)).t()       # (H, C) view
    w_s = rnd(ks, H, scale=1.0 / math.sqrt(H)).t()
    b_s = rnd(ks, scale=0.1)
    ok_, lk = shift_attend(h, ctx, w_in, w_s, b_s)
    torch.cuda.synchronize()
    orf, lrf = shift_attend_ref(h, ctx, w_in, w_s, b_s)
    # logits: f32 sums of 2176 products in another order; out: bf16
    name = _named("shift_attend", tag)
    err = max(check_close(f"{name} logits", lk, lrf, 1e-3, 1e-4),
              check_close(f"{name} out", ok_, orf, 1e-2, 1e-2))
    k4 = shift_plan(B, 36, Cf, H, ks, n_sm)
    print(f"  {name}: {k4.ctas} CTAs of {k4.sw} columns, {k4.smem} bytes of "
          "shared memory", flush=True)
    n_bytes = (2 * (h.numel() + ctx.numel() + w_in.numel() + w_s.numel()
                    + ks + B * Cf) + 4 * B * 36)
    flops = 2.0 * B * H * (Cf + ks) + 2 * 2.0 * B * 36 * Cf
    b_ms, b_by = bound_ms(n_bytes, flops)
    return [dict(
        name=name, shape=f"B{B} T36 C2176 H1024 k5", max_abs_err=err,
        fn=lambda: shift_attend(h, ctx, w_in, w_s, b_s),
        plain_ms=time_ms(lambda: shift_attend_ref(h, ctx, w_in, w_s, b_s)),
        library_fn=None, library_call=None, bound_ms=b_ms,
        bound_by=b_by)], (w_in, w_s, b_s)


def _grads(fn, leaves, cots):
    import torch

    leaves = [x.detach().clone().requires_grad_() for x in leaves]
    return torch.autograd.grad(fn(*leaves), leaves, cots)


def compare(name, fn, ref_fn, leaves, names, cots, rtol):
    """Gradients through ``fn`` (kernels) and ``ref_fn`` (plain) for the
    cotangents ``cots``, each within ``rtol`` of the plain one's max."""
    import torch

    got = _grads(fn, leaves, cots)
    torch.cuda.synchronize()
    ref = _grads(ref_fn, leaves, cots)
    return max(check_close(f"{name} d{key}", g, r, 0.0, rtol)
               for key, g, r in zip(names, got, ref))


def check_bilstm_fn_grads(rnd, mask2, wh2, name):
    """BiLstmScanFn (K1 forward, K2 backward) against autograd through the
    plain version, at the mask's batch."""
    import torch

    from dasa_tpu_torch.ops.lstm import bilstm_scan_fn, bilstm_scan_ref

    _dirs, T, B = mask2.shape
    H = wh2.shape[1]
    g_c2 = torch.zeros(2, T, B, H, device=mask2.device, dtype=mask2.dtype)
    g_c2[:, -1] = rnd(2, B, H, scale=0.05)
    # the kernel path rounds the gates, c_prev and dgates to bf16 where the
    # plain autograd keeps f32 (the TPU package's design): a few percent
    compare(name,
            lambda xw, h0, c0, w: bilstm_scan_fn(xw, mask2, h0, c0, w),
            lambda xw, h0, c0, w: bilstm_scan_ref(xw, mask2, h0, c0, w)[:2],
            (rnd(2, T, B, 4 * H, scale=0.5), rnd(2, B, H, scale=0.1),
             rnd(2, B, H, scale=0.1), wh2), ("xw", "h0", "c0", "wh"),
            (rnd(2, T, B, H, scale=0.05), g_c2), 5e-2)


def check_lstm_fn_grads(rnd, mask, wh, name):
    """LstmScanFn (K1 forward, K2 backward: the one-direction top LSTM)
    against autograd through the plain version, at the mask's batch."""
    import torch

    from dasa_tpu_torch.ops.lstm import LstmScanFn, lstm_scan_ref

    T, B = mask.shape
    H = wh.shape[0]
    g_c = torch.zeros(T, B, H, device=mask.device, dtype=mask.dtype)
    g_c[-1] = rnd(B, H, scale=0.05)
    # the kernel path rounds the gates, c_prev and dgates to bf16 where the
    # plain autograd keeps f32 (the TPU package's design): a few percent
    compare(name,
            lambda xw, h0, c0, w: LstmScanFn.apply(xw, mask, h0, c0, w),
            lambda xw, h0, c0, w: lstm_scan_ref(xw, mask, h0, c0, w),
            (rnd(T, B, 4 * H, scale=0.5), rnd(B, H, scale=0.1),
             rnd(B, H, scale=0.1), wh), ("xw", "h0", "c0", "wh"),
            (rnd(T, B, H, scale=0.05), g_c), 5e-2)


def check_function_grads(rnd, mask, wh, w_ta, b_a, w_in, w_s, b_s, mask2,
                         wh2, tag=""):
    """Gradients of LstmScanFn, BiLstmScanFn, AdainGateFn and
    ShiftAttendFn (kernels forward) against autograd through the plain
    versions, at the mask's batch, for a random cotangent."""
    from dasa_tpu_torch.ops.adain import AdainGateFn, adain_channel_gate_ref
    from dasa_tpu_torch.ops.shift_attention import (
        ShiftAttendFn,
        shift_attend_ref,
    )

    B = mask.shape[1]
    H = wh.shape[0]
    check_lstm_fn_grads(rnd, mask, wh, _named("LstmScanFn", tag))
    check_bilstm_fn_grads(rnd, mask2, wh2, _named("BiLstmScanFn", tag))
    C = w_ta.shape[0]
    f, d = rnd(B, 36, C).relu(), rnd(B, 36, C).relu()
    noise = (rnd(C) > -0.25).to(f.dtype) / 0.6
    # the same f32 arithmetic; the outputs round to bf16 once
    compare(_named("AdainGateFn", tag), AdainGateFn.apply,
            adain_channel_gate_ref,
            (f, d, w_ta.t(), b_a, noise), ("f", "d", "w", "b", "noise"),
            (rnd(B, 36, C, scale=0.05),), 2e-2)
    h = rnd(B, H, scale=0.5)
    ctx = rnd(B, 36, w_in.shape[1]).relu()
    # the plain version rounds the smoothed attention to bf16
    compare(_named("ShiftAttendFn", tag), ShiftAttendFn.apply,
            shift_attend_ref,
            (h, ctx, w_in, w_s, b_s), ("h", "ctx", "w_in", "w_shift",
                                       "b_shift"),
            (rnd(B, w_in.shape[1], scale=0.05),
             rnd(B, 36, scale=0.05).float()), 2e-2)


def headline_world(root: str, seed: int, n_train: int = 10, n_val: int = 10,
                   **overrides):
    from dasa_tpu_torch.config import Config
    from dasa_tpu_torch.data.datasets import make_synthetic_task
    from dasa_tpu_torch.testing import write_synthetic_connectivity
    from dasa_tpu_torch.train.trainer import World

    conn = os.path.join(root, "connectivity")
    data = os.path.join(root, "task")
    write_synthetic_connectivity(conn, ["synthA", "synthB"], n_nodes=40,
                                 seed=seed)
    make_synthetic_task(data, ["synthA"], ["synthB"], n_train=n_train,
                        n_val=n_val, connectivity_dir=conn, seed=seed)
    cfg = Config(**{**HEADLINE, **overrides}, data_dir=data,
                 connectivity_dir=conn, seed=seed)
    return cfg, World(cfg)


def check_summary(name, summary):
    """Evaluation.score has already asserted that every episode of the
    split has a trajectory that starts at its start viewpoint."""
    for key, val in summary.items():
        if not math.isfinite(val):
            fail(f"{name}: {key} = {val}")
    for key in ("success_rate", "spl", "oracle_rate"):
        if not 0.0 <= summary[key] <= 1.0:
            fail(f"{name}: {key} = {summary[key]} outside [0, 1]")


def phase_main(cfg, world, seed: int):
    import torch

    from dasa_tpu_torch import ops
    from dasa_tpu_torch.train.trainer import make_agent, valid

    agent = make_agent(cfg, world, rng_seed=seed)
    trajs = capture_results(agent)
    torch.cuda.synchronize()
    ops.reset_kernel_launches()
    start = time.perf_counter()
    out = valid(cfg, world, agent=agent)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = ops.kernel_launches()
    del agent.test  # the wrapper's reference cycle would outlive the agent
    check_coverage(world, trajs)
    backends = {split: env.backend for split, env in world.envs.items()}
    print(f"  sim backends: {backends}", flush=True)
    if set(backends.values()) != {"native"}:
        fail(f"the world's envs run {backends}, not the native engine")
    episodes = 0
    for split, summary in out.items():
        n = world.envs[split].size()
        episodes += n
        check_summary(split, summary)
        print(f"  {split}: SR {summary['success_rate']:.4f} SPL "
              f"{summary['spl']:.4f} NE {summary['nav_error']:.4f} "
              f"({n} episodes)", flush=True)
    print(f"  valid(): {seconds:.2f} s, {episodes / seconds:.2f} episodes/s, "
          f"{agent.total_env_steps / seconds:.2f} agent-steps/s "
          f"({agent.total_env_steps} agent-steps)", flush=True)
    print(f"  launches during valid(): {launches}", flush=True)
    for name in EVAL_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} never launched during valid()")
    return agent, launches, trajs


def capture_results(agent):
    """Record each split's ``agent.test()`` results, by env name."""
    trajs = {}
    test = agent.test

    def recording_test(*args, **kwargs):
        out = test(*args, **kwargs)
        trajs[agent.env.name] = out
        return out

    agent.test = recording_test
    return trajs


def check_coverage(world, trajs):
    """Every split evaluated: each instr_id of the split exactly once."""
    for split, results in trajs.items():
        got = sorted(r["instr_id"] for r in results)
        want = sorted(item["instr_id"] for item in world.envs[split].data)
        if got != want:
            fail(f"{split}: {len(got)} results for {len(want)} episodes, "
                 "or instr_ids not each covered once")


def phase_compare(cfg, world, agent_always, seed: int):
    """Same weights under use_pallas always vs never."""
    import torch

    from dasa_tpu_torch.train.trainer import make_agent

    agent_never = make_agent(cfg.replace(use_pallas="never"), world,
                             rng_seed=seed + 1)
    agent_never.policy.load_state_dict(agent_always.policy.state_dict())
    env = world.envs["val_unseen"]
    # first-step logits of the same first batch, before test() wraps the
    # split (a wrap reshuffles the env's episode order)
    logits = []
    for agent in (agent_always, agent_never):
        agent.env = env
        env.reset_epoch()
        logits.append(agent.first_step_logits())
    trajs = [{r["instr_id"]: r["trajectory"]
              for r in agent.test(feedback="argmax")}
             for agent in (agent_always, agent_never)]
    la, ln = logits
    real = la > -1e8
    if not torch.equal(real, ln > -1e8):
        fail("always/never: candidate masks differ")
    # the kernel path keeps the BiLSTM carry and the AdaIN epilogue in
    # f32 where the plain path rounds to bf16 at every op: the logits
    # agree to a few bf16 ulps of their scale
    check_close("first-step logits always vs never", la[real], ln[real],
                0.0, 5e-2)
    same = sum(trajs[0][k] == trajs[1][k] for k in trajs[0])
    print(f"  trajectory agreement always vs never: {same}/{len(trajs[0])} "
          f"= {same / len(trajs[0]):.3f}", flush=True)


def phase_train(cfg, world, seed: int, root: str):
    """train() at headline width; each iteration timed on its own."""
    import torch

    from dasa_tpu_torch import ops
    from dasa_tpu_torch.train.trainer import make_agent, train

    cfg = cfg.replace(iters=TRAIN_ITERS, log_every=1, val_every=10 ** 9,
                      save_every=10 ** 9, snap_dir=os.path.join(root, "snap"),
                      log_dir=os.path.join(root, "log"))
    agent = make_agent(cfg, world, rng_seed=seed)
    before = {name: p.detach().clone()
              for name, p in agent.policy.named_parameters()
              if name.startswith(TRAINED)}
    iter_s = []
    run_iters = agent.train

    def timed(n_iters, feedback):
        torch.cuda.synchronize()
        start = time.perf_counter()
        run_iters(n_iters, feedback=feedback)
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - start)

    agent.train = timed  # train() runs one iteration per log interval
    gc.collect()  # no earlier phase's agent in the peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    start = time.perf_counter()
    train(cfg, world, agent=agent)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = ops.kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in agent.logs["loss"]]
    steps = agent.env_steps_total()
    print(f"  launches during train(): {launches}", flush=True)
    for name in PATH_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} never launched during train()")
    if len(iter_s) != TRAIN_ITERS or agent.iter_count != TRAIN_ITERS:
        fail(f"train(): {agent.iter_count} optimizer steps, "
             f"{len(iter_s)} timed iterations, expected {TRAIN_ITERS}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"train(): non-finite loss in {losses}")
    moved = {name.split(".")[0] for name, p in agent.policy.named_parameters()
             if name in before and not torch.equal(p.detach(), before[name])}
    print(f"  losses of the last pass pair: {losses}; components moved: "
          f"{sorted(moved)}", flush=True)
    if moved != {"encoder", "decoder", "critic", "adain"}:
        fail(f"train(): parameters of {sorted(moved)} moved, expected the "
             "encoder's BiLSTM, decoder, critic and adain")
    card = card_name()
    print(f"  train(): {seconds:.2f} s for {TRAIN_ITERS} iterations "
          f"(checkpoint included); iteration s {[round(x, 4) for x in iter_s]}"
          f", median after the first {statistics.median(iter_s[1:]):.4f} s; "
          f"{steps / sum(iter_s):.2f} training agent-steps/s ({steps} "
          f"agent-steps); peak memory {peak / 2 ** 30:.2f} GiB; card "
          f"{card}", flush=True)
    return launches


def phase_train_compare(cfg, world, seed: int):
    """Same weights under use_pallas always vs never, dropout off: one
    fused argmax pass with train_ml=0.2."""
    import torch

    from dasa_tpu_torch.train.trainer import make_agent

    cfg = cfg.replace(**NO_DROPOUT)
    env = world.envs["train"]
    state, results = None, []
    for mode in ("always", "never"):
        agent = make_agent(cfg.replace(use_pallas=mode), world,
                           rng_seed=seed)
        if state is None:
            state = agent.policy.state_dict()
        agent.policy.load_state_dict(state)
        agent.env = env
        env.reset_epoch()
        evals = agent._device_eval(*agent._batch_inputs())
        env.reset_epoch()
        record = {}
        agent.zero_grad()
        agent.device_rollout(train_ml=0.2, train_rl=True, feedback="argmax",
                             record=record)
        grad = torch.cat([p.grad.float().flatten()
                          for p in agent.policy.parameters()
                          if p.grad is not None])
        paths = [[tuple(rec["action"][rec["active"][:, i], i].tolist())
                  for i in range(rec["action"].shape[1])]
                 for rec in (record["stacked"], evals)]
        # with dropout off the training pass's forward is the evaluation
        # forward of the same batch: the same actions
        same_eval = sum(a == b for a, b in zip(*paths))
        print(f"  {mode}: training-pass trajectories equal to the "
              f"evaluation's: {same_eval}/{len(paths[0])}", flush=True)
        if same_eval != len(paths[0]):
            fail(f"train-compare ({mode}): the argmax training pass and "
                 "the evaluation of the same batch took different actions")
        results.append((float(agent.losses[-1]), grad, paths[0]))
        del agent
    (la, ga, pa), (ln, gn, pn) = results
    cos = float(torch.dot(ga, gn) / (ga.norm() * gn.norm()))
    same = sum(a == b for a, b in zip(pa, pn))
    print(f"  argmax pass loss always {la:.6f} never {ln:.6f}; gradient "
          f"cosine {cos:.6f}; equal trajectories {same}/{len(pa)}",
          flush=True)
    # the kernel path keeps the BiLSTM carry and the AdaIN epilogue in f32
    # where the plain path rounds to bf16: a few bf16 ulps of the loss
    if not abs(la - ln) <= 5e-2 * abs(ln):
        fail(f"train-compare: loss {la} vs {ln} beyond 5%")
    if not cos >= 0.99:
        fail(f"train-compare: gradient cosine {cos} below 0.99")


def phase_stream(cfg, world, seed: int, root: str):
    """train() under the stream regime at headline width: STREAM_WINDOWS
    windows of 2B = 40 slots x 35 steps, one optimizer step each."""
    import torch

    from dasa_tpu_torch import ops
    from dasa_tpu_torch.train.trainer import make_agent, train

    cfg = cfg.replace(iters=STREAM_WINDOWS, log_every=1, val_every=10 ** 9,
                      save_every=10 ** 9, snap_dir=os.path.join(root, "snap"),
                      log_dir=os.path.join(root, "log"))
    agent = make_agent(cfg, world, rng_seed=seed)
    before = {name: p.detach().clone()
              for name, p in agent.policy.named_parameters()
              if name.startswith(TRAINED)}
    window = agent.device_rollout_stream
    host_s, window_losses = [], []

    def recorded(*args, **kwargs):
        # the slot-time grids and the losses stay on the card: no sync
        start = time.perf_counter()
        window(*args, record=True, **kwargs)
        host_s.append(time.perf_counter() - start)
        window_losses.append(agent.losses[-1])

    agent.device_rollout_stream = recorded
    gc.collect()  # no earlier phase's agent in the peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    start = time.perf_counter()
    train(cfg, world, agent=agent)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = ops.kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    del agent.device_rollout_stream  # its wrapper's reference cycle
    st = agent._stream_host()
    geom = st.geom
    print(f"  launches during train() under stream: {launches}", flush=True)
    for name in PATH_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} never launched during train() under stream")
    if len(st.records) != STREAM_WINDOWS or agent.iter_count != STREAM_WINDOWS:
        fail(f"stream train(): {agent.iter_count} optimizer steps, "
             f"{len(st.records)} windows, expected {STREAM_WINDOWS}")
    losses = [float(x) for x in window_losses]
    if len(losses) != STREAM_WINDOWS or not all(math.isfinite(x)
                                                for x in losses):
        fail(f"stream train(): non-finite loss in {losses}")
    moved = {name.split(".")[0] for name, p in agent.policy.named_parameters()
             if name in before and not torch.equal(p.detach(), before[name])}
    if moved != {"encoder", "decoder", "critic", "adain"}:
        fail(f"stream train(): parameters of {sorted(moved)} moved, "
             "expected the encoder's BiLSTM, decoder, critic and adain")
    recs = [{k: v.cpu().numpy() for k, v in r.items()} for r in st.records]
    uids = []
    for r in recs:
        uids += r["rec_uid"][r["rec_take"] & (r["rec_uid"] >= 0)].tolist()
    if len(uids) != len(set(uids)) or not set(uids) <= set(st.staged):
        fail(f"stream train(): {len(uids)} episodes taken, "
             f"{len(set(uids))} distinct; an episode was taken twice or "
             "one was never staged")
    if any((r["rec_take"] & (r["rec_uid"] < 0)).any() for r in recs):
        fail("stream train(): the placeholder episode was taken")
    starved = sum(int((~r["rec_real"] & ~r["rec_trunc"]).sum())
                  for r in recs)
    cells = STREAM_WINDOWS * geom.S * geom.W
    steps = agent.env_steps_total()
    card = card_name()
    timer = agent.stream_timer
    phases = ", ".join(f"{k} {v:.3f} s" for k, v in sorted(
        timer.culmu.items(), key=lambda kv: -kv[1]))
    print(f"  stream geometry: W {geom.W} slots, S {geom.S} steps, pool "
          f"{geom.E} a half; {len(uids)} episodes taken, each once; starved "
          f"slot-steps {starved}/{cells} = {starved / cells:.4f}", flush=True)
    print(f"  losses: {[round(x, 4) for x in losses]}; components moved: "
          f"{sorted(moved)}", flush=True)
    print(f"  stream train(): {seconds:.2f} s for {STREAM_WINDOWS} windows "
          f"(checkpoint included), {seconds / STREAM_WINDOWS:.4f} s a window;"
          f" host s a window {[round(x, 4) for x in host_s]}; "
          f"{steps / seconds:.2f} training agent-steps/s ({steps} "
          f"agent-steps, device sync at the end); peak memory "
          f"{peak / 2 ** 30:.2f} GiB; host phases {phases}; card {card}",
          flush=True)
    return launches


def phase_stream_eval(cfg, world, state, episodic, seed: int):
    """valid() under the stream regime with phase 3's weights."""
    import torch

    from dasa_tpu_torch.train.trainer import make_agent, valid

    cfg = cfg.replace(rollout_mode="stream")
    agent = make_agent(cfg, world, rng_seed=seed)
    agent.policy.load_state_dict(state)
    trajs = capture_results(agent)
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = valid(cfg, world, agent=agent)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    del agent.test
    check_coverage(world, trajs)
    same = total = 0
    for split, summary in out.items():
        check_summary(split, summary)
        ref = {r["instr_id"]: r["trajectory"] for r in episodic[split]}
        eq = sum(r["trajectory"] == ref[r["instr_id"]] for r in trajs[split])
        same, total = same + eq, total + len(ref)
        print(f"  {split} (stream): SR {summary['success_rate']:.4f} SPL "
              f"{summary['spl']:.4f} NE {summary['nav_error']:.4f}; "
              f"{eq}/{len(ref)} trajectories equal to phase 3's", flush=True)
    # the pool outnumbers a smoke split, so the slots also walk episodes
    # staged again after the split wrapped (as in the JAX package): the
    # agent-steps count them, the episodes/s do not
    print(f"  stream valid(): {seconds:.2f} s, {total / seconds:.2f} "
          f"episodes/s, {agent.total_env_steps / seconds:.2f} agent-steps/s "
          f"walked ({agent.total_env_steps} agent-steps, episodes staged "
          f"again included); trajectories equal to the episodic valid(): "
          f"{same}/{total} = {same / total:.3f}", flush=True)


def phase_speaker(seed: int, root: str):
    """train_speaker() for SPK_ITERS iterations at batch 64, then
    valid_speaker() on both val splits, at the speaker's Config widths
    under use_pallas="always", over a world whose splits (66 items each)
    exceed the batch; the launch counters zeroed before, read after."""
    import torch

    from dasa_tpu_torch import ops
    from dasa_tpu_torch.train.trainer import (
        make_speaker,
        train_speaker,
        valid_speaker,
    )

    cfg, world = headline_world(
        os.path.join(root, "speaker"), seed, n_train=22, n_val=22,
        batch_size=SPK_B, use_pallas="always", iters=SPK_ITERS,
        log_every=SPK_ITERS, val_every=10 ** 9,
        snap_dir=os.path.join(root, "snap"), log_dir=os.path.join(root, "log"),
        name="speaker", **SPEAKER)
    speaker = make_speaker(cfg, world)
    before = {k: v.clone() for k, v in speaker.model.state_dict().items()}
    run_train, run_infer = speaker.train, speaker.infer_batch
    losses, decode_s = [], []

    def timed_train(iters):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = run_train(iters)
        torch.cuda.synchronize()
        losses.extend(out)
        timed_train.seconds = time.perf_counter() - start
        return out

    def timed_infer(*args, **kwargs):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = run_infer(*args, **kwargs)  # ends in a copy to the host
        decode_s.append(time.perf_counter() - start)
        return out

    speaker.train, speaker.infer_batch = timed_train, timed_infer
    gc.collect()  # no earlier phase's agent in the peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    train_speaker(cfg, world, speaker=speaker)
    out = valid_speaker(cfg, world, speaker=speaker)
    torch.cuda.synchronize()
    launches = ops.kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    del speaker.train, speaker.infer_batch  # the wrappers' reference cycles
    print(f"  launches during train_speaker() + valid_speaker(): {launches}",
          flush=True)
    for name in SPEAKER_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} never launched in the speaker phase")
    if len(losses) != SPK_ITERS or not all(math.isfinite(x) for x in losses):
        fail(f"train_speaker(): losses {losses}, expected {SPK_ITERS} finite")
    moved = [k for k, v in speaker.model.state_dict().items()
             if not torch.equal(v, before[k])]
    if not any(k.startswith("encoder.lstm.") for k in moved) or not any(
            k.startswith("decoder.") for k in moved):
        fail(f"train_speaker(): moved only {moved}")
    for split, scores in out.items():
        bleu = scores["bleu"]
        if not (math.isfinite(bleu) and 0.0 <= bleu <= 1.0):
            fail(f"valid_speaker() {split}: BLEU {bleu}")
        for key in ("loss", "word_accu", "sent_accu"):
            if not math.isfinite(scores[key]):
                fail(f"valid_speaker() {split}: {key} {scores[key]}")
        want = {item["path_id"] for item in world.envs[split].data}
        if set(scores["path2inst"]) != want:
            fail(f"valid_speaker() {split}: {len(scores['path2inst'])} "
                 f"paths captioned of {len(want)}")
        print(f"  {split}: BLEU {bleu:.4f} loss {scores['loss']:.4f} word "
              f"accuracy {scores['word_accu']:.4f}, {len(want)} paths "
              "captioned", flush=True)
    print(f"  train_speaker(): losses {[round(x, 4) for x in losses]}, "
          f"{timed_train.seconds / SPK_ITERS:.4f} s an iteration at B "
          f"{SPK_B}; decode (up to {cfg.max_decode} words, teacher path "
          f"included) s a batch {[round(x, 4) for x in decode_s]}; peak "
          f"memory {peak / 2 ** 30:.2f} GiB; card {card_name()}", flush=True)
    state = {k: v.to("cpu", copy=True)
             for k, v in speaker.model.state_dict().items()}
    return launches, cfg, world, state


def phase_speaker_compare(cfg, world, state):
    """The same speaker weights under use_pallas always and never: the
    first decode step's logits and the greedy instructions of val_unseen's
    first batch."""
    import torch

    from dasa_tpu_torch.train.trainer import make_speaker

    env = world.envs["val_unseen"]
    logits, words = [], []
    for mode in ("always", "never"):
        speaker = make_speaker(cfg.replace(use_pallas=mode), world)
        speaker.model.load_state_dict(state)
        speaker.env = env
        env.reset_epoch()
        env.reset()
        logits.append(speaker.first_step_logits())
        env.reset_epoch()
        env.reset()
        words.append(speaker.infer_batch())
        del speaker
    # the kernel path keeps both BiLSTMs' carry in f32 where the plain
    # path rounds it to bf16 every token: a few bf16 ulps of the logits'
    # scale
    check_close("speaker first-step logits always vs never", logits[0],
                logits[1], 0.0, 5e-2)
    same = sum(bool((a == b).all()) for a, b in zip(*words))
    print(f"  greedy instructions equal always vs never: {same}/"
          f"{len(words[0])} = {same / len(words[0]):.3f}", flush=True)


def phase_selftrain(cfg, seed: int, root: str, steps: int = SELFTRAIN_STEPS,
                    name: str = "selftrain"):
    """The README's headline command: auglistener with selfTrain
    back-translation on the aug split, batch 20, in ``cfg``'s regime
    (episodic; or stream, where the aug env's pass pair falls back to the
    host act/replay rollout), under use_pallas="always", ``steps``
    optimizer steps; the speaker is built on the listener world's
    vocabulary (random weights from the seed).  The launch counters
    zeroed before, read after."""
    import torch

    from dasa_tpu_torch import ops
    from dasa_tpu_torch.train.trainer import (
        World,
        make_agent,
        make_speaker,
        train,
    )

    cfg = cfg.replace(aug="aug", self_train=True, accumulate_grad=True,
                      iters=2 * steps, log_every=2,
                      val_every=10 ** 9, save_every=10 ** 9,
                      snap_dir=os.path.join(root, "snap"),
                      log_dir=os.path.join(root, "log"), name=name)
    world = World(cfg)
    agent = make_agent(cfg, world, rng_seed=seed)
    speaker = make_speaker(cfg, world)
    before = {name: p.detach().clone()
              for name, p in agent.policy.named_parameters()
              if name.startswith(TRAINED)}
    sp_before = {k: v.clone() for k, v in speaker.model.state_dict().items()}
    relabel, step = speaker.relabel_batch, agent.optim_step
    relabel_s, replaced, step_at = [], [], []

    def timed_relabel(env, *args):
        torch.cuda.synchronize()
        start = time.perf_counter()
        orig = [item["instr_encoding"] for item in env.batch]
        obs = relabel(env, *args)
        torch.cuda.synchronize()
        relabel_s.append(time.perf_counter() - start)
        replaced.append(sum(not np.array_equal(item["instr_encoding"], o)
                            for item, o in zip(env.batch, orig)))
        return obs

    def timed_step():
        step()
        torch.cuda.synchronize()
        step_at.append(time.perf_counter())

    speaker.relabel_batch, agent.optim_step = timed_relabel, timed_step
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    start = time.perf_counter()
    train(cfg, world, agent=agent, speaker=speaker)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = ops.kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    del speaker.relabel_batch, agent.optim_step
    print(f"  launches during train() with selfTrain: {launches}", flush=True)
    for name in PATH_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} never launched during selfTrain train()")
    if agent.iter_count != steps or len(relabel_s) != \
            2 * steps:
        fail(f"selfTrain train(): {agent.iter_count} optimizer steps and "
             f"{len(relabel_s)} relabels, expected {steps} and "
             f"{2 * steps}")
    if not all(replaced):
        fail(f"selfTrain: relabels replaced {replaced} instructions")
    losses = [float(x) for x in agent.logs["loss"]]
    if not losses or not all(math.isfinite(x) for x in losses):
        fail(f"selfTrain train(): losses {losses}")
    moved = {name.split(".")[0] for name, p in agent.policy.named_parameters()
             if name in before and not torch.equal(p.detach(), before[name])}
    if moved != {"encoder", "decoder", "critic", "adain"}:
        fail(f"selfTrain train(): listener parameters of {sorted(moved)} "
             "moved, expected the encoder's BiLSTM, decoder, critic, adain")
    for key, val in speaker.model.state_dict().items():
        if not torch.equal(val, sp_before[key]):
            fail(f"selfTrain train(): speaker parameter {key} moved")
    iters = [b - a for a, b in zip([start] + step_at, step_at)]
    agent_steps = agent.env_steps_total()
    share = sum(relabel_s[2:]) / sum(iters[1:])
    print(f"  relabels replaced {replaced} of {cfg.batch_size} instructions "
          f"each; losses {[round(x, 4) for x in losses]}", flush=True)
    print(f"  selfTrain train() ({cfg.rollout_mode}): {seconds:.2f} s for "
          f"{steps} optimizer steps (org + aug pass pairs, checkpoint "
          f"included); iteration s {[round(x, 4) for x in iters]}, median "
          f"after the first {statistics.median(iters[1:]):.4f} s; relabel s "
          f"{[round(x, 4) for x in relabel_s]}, {100 * share:.1f}% of the "
          f"iterations after the first; {agent_steps / seconds:.2f} training "
          f"agent-steps/s ({agent_steps} agent-steps); peak memory "
          f"{peak / 2 ** 30:.2f} GiB; card {card_name()}", flush=True)
    return launches


def walk_connected(graph, walk) -> bool:
    """Each move of the walk goes to a navigable neighbour (a repeated
    viewpoint turns in place)."""
    adj = graph.nav_adjacency()
    return all(a == b or adj[graph.id2ix[a], graph.id2ix[b]]
               for a, b in zip(walk, walk[1:]))


def add_launches(total, more):
    for key, val in more.items():
        total[key] = total.get(key, 0) + val


def phase_host(cfg, cfg_train, world, seed: int, root: str):
    """The host act/replay rollout at headline width under
    use_pallas="always": (a) ``valid()`` with ``submit`` over both val
    splits, (b) ``train()`` under ``device_rollout="never"`` for
    HOST_ITERS iterations and a dropout-free teacher-ML pass on one batch
    against the device teacher pass, (c) ``auglistener --selfTrain``
    under the stream regime, whose aug passes fall back to the host pair.
    Returns the launches of (a) + (b) + (c)."""
    import torch

    from dasa_tpu_torch import ops
    from dasa_tpu_torch.train.trainer import make_agent, train, valid

    total = {}
    # (a) validlistener --submit: the visited-candidate mask
    cfg_a = cfg.replace(submit=True, log_dir=os.path.join(root, "log"),
                        name="host-submit")
    agent = make_agent(cfg_a, world, rng_seed=seed)
    trajs = capture_results(agent)
    kept, to_sobs = [], agent._to_sobs

    def keep(obs, ended, visited_mask, is_first):
        sobs = to_sobs(obs, ended, visited_mask, is_first)
        if visited_mask is not None:
            kept.append((sobs, visited_mask))
        return sobs

    agent._to_sobs = keep
    torch.cuda.synchronize()
    ops.reset_kernel_launches()
    start = time.perf_counter()
    out = valid(cfg_a, world, agent=agent)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = ops.kernel_launches()
    add_launches(total, launches)
    del agent.test, agent._to_sobs
    check_coverage(world, trajs)
    hidden = moved_to_hidden = 0
    for sobs, vm in kept:
        a, n = sobs["action"], sobs["cand_n"]
        moves = sobs["active"] & (a < n)
        hidden += int(vm.sum())
        moved_to_hidden += int((moves & vm[np.arange(len(a)),
                                          np.minimum(a, vm.shape[1] - 1)])
                               .sum())
    if moved_to_hidden or not hidden:
        fail(f"submit: {moved_to_hidden} moves to a candidate the visited "
             f"mask hid ({hidden} hidden in all)")
    for split, summary in out.items():
        check_summary(split, summary)
        path = os.path.join(cfg_a.log_dir, cfg_a.name,
                            f"submit_{split}.json")
        with open(path) as f:
            written = json.load(f)
        if written != json.loads(json.dumps(trajs[split])):
            fail(f"{path} differs from valid()'s results")
        print(f"  {split} (host, submit): SR {summary['success_rate']:.4f} "
              f"SPL {summary['spl']:.4f}; {path} holds the {len(written)} "
              "results", flush=True)
    print(f"  host valid() with submit: {seconds:.2f} s, "
          f"{agent.total_env_steps / seconds:.2f} agent-steps/s "
          f"({agent.total_env_steps} agent-steps); {hidden} candidates "
          f"hidden by the visited mask, none taken; launches {launches}",
          flush=True)
    check_host_routing("valid() with submit", launches)
    del agent

    # (b) train() under device_rollout="never"
    cfg_b = cfg_train.replace(
        device_rollout="never", iters=HOST_ITERS, log_every=1,
        val_every=10 ** 9, save_every=10 ** 9,
        snap_dir=os.path.join(root, "snap"),
        log_dir=os.path.join(root, "log"), name="host-train")
    agent = make_agent(cfg_b, world, rng_seed=seed)
    before = {n: p.detach().clone() for n, p in
              agent.policy.named_parameters() if n.startswith(TRAINED)}
    iter_s, run_iters = [], agent.train

    def timed(n_iters, feedback):
        torch.cuda.synchronize()
        start = time.perf_counter()
        run_iters(n_iters, feedback=feedback)
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - start)

    agent.train = timed
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    train(cfg_b, world, agent=agent)
    torch.cuda.synchronize()
    launches = ops.kernel_launches()
    add_launches(total, launches)
    peak = torch.cuda.max_memory_allocated()
    del agent.train
    # train() keeps the logs of its last interval: the last pass pair
    losses = [float(x) for x in agent.logs["loss"]]
    if agent.iter_count != HOST_ITERS or len(losses) != 2 or \
            not all(math.isfinite(x) for x in losses):
        fail(f"host train(): {agent.iter_count} steps, losses {losses}")
    moved = {n.split(".")[0] for n, p in agent.policy.named_parameters()
             if n in before and not torch.equal(p.detach(), before[n])}
    if moved != {"encoder", "decoder", "critic", "adain"}:
        fail(f"host train(): parameters of {sorted(moved)} moved")
    steps = agent.env_steps_total()
    print(f"  host train() (device_rollout=never): iteration s "
          f"{[round(x, 4) for x in iter_s]}, median "
          f"{statistics.median(iter_s):.4f} s; {steps / sum(iter_s):.2f} "
          f"training agent-steps/s ({steps} agent-steps); losses "
          f"{[round(x, 4) for x in losses]}; peak memory "
          f"{peak / 2 ** 30:.2f} GiB; launches {launches}; card "
          f"{card_name()}", flush=True)
    check_host_routing("host train()", launches)
    del agent

    # the host teacher-ML pass against the device teacher pass: one
    # batch, the same weights, dropout off
    cfg_c = cfg_train.replace(**NO_DROPOUT)
    agent = make_agent(cfg_c, world, rng_seed=seed)
    agent.env = env = world.envs["train"]
    noise = agent._noise_fn(
        torch.Generator(device=agent.device).manual_seed(seed))
    pass_losses, grads = [], []
    for run in (agent.rollout, agent.device_rollout):
        env.reset_epoch()
        agent.zero_grad()
        run(train_ml=0.2, train_rl=False, feedback="teacher",
            env_noise=noise)
        pass_losses.append(float(agent.losses[-1]))
        grads.append(torch.cat([p.grad.float().flatten()
                                for p in agent.policy.parameters()
                                if p.grad is not None]))
    lh, ld = pass_losses
    cos = float(torch.dot(grads[0], grads[1])
                / (grads[0].norm() * grads[1].norm()))
    print(f"  teacher-ML pass host {lh:.6f} device {ld:.6f}; gradient "
          f"cosine {cos:.6f}", flush=True)
    # phase 6's limits
    if not abs(lh - ld) <= 5e-2 * abs(ld):
        fail(f"host teacher pass: loss {lh} vs the device's {ld} beyond 5%")
    if not cos >= 0.99:
        fail(f"host teacher pass: gradient cosine {cos} below 0.99")
    del agent, grads

    # (c) selfTrain under stream: the host fallback for the aug passes
    add_launches(total, phase_selftrain(
        cfg_train.replace(rollout_mode="stream"), seed, root,
        steps=HOST_SELFTRAIN_STEPS, name="selftrain-stream"))
    return total


def check_host_routing(label, launches):
    """The host act step and its replay take the top BiLSTM's plain path
    (no K1, no K2) and, under always, the AdaIN gate and shift attention
    kernels."""
    for name in ("adain_channel_gate", "shift_attend"):
        if launches[name] <= 0:
            fail(f"kernel {name} never launched during {label}")
    for name in ("bilstm_scan", "lstm_scan_bwd"):
        if launches[name] != 0:
            fail(f"{label}: {name} launched {launches[name]} times; the "
                 "host rollout takes the top BiLSTM's plain path")


def phase_search(cfg, world, seed: int, root: str):
    """beam_valid() at headline width with an untrained speaker at its
    Config widths (random weights from the seed, the listener world's
    vocabulary): Dijkstra over both val splits with 1 candidate, 3
    candidates with param_search on val_seen, state-factored on
    val_unseen; then the first expansion's log-probabilities under
    use_pallas always and never.  The launch counters zeroed before the
    three searches, read after."""
    import copy

    import torch

    from dasa_tpu_torch import ops
    from dasa_tpu_torch.agents import search
    from dasa_tpu_torch.train.trainer import (
        beam_valid,
        make_agent,
        make_speaker,
    )

    cfg = cfg.replace(log_dir=os.path.join(root, "log"), name="search")
    agent = make_agent(cfg, world, rng_seed=seed)
    speaker = make_speaker(cfg, world)
    stats = {"batches": 0, "expansions": 0, "paths": 0, "rescore_k1": 0}
    runs = []
    originals = {k: getattr(search, k) for k in (
        "_begin", "_search_step", "_speaker_rescore", "beam_search_test",
        "state_factored_search_test")}
    score = speaker.score_instruction

    def begin(a):
        stats["batches"] += 1
        return originals["_begin"](a)

    def step(*args):
        stats["expansions"] += 1
        return originals["_search_step"](*args)

    def rescore(results, sp):
        k1 = ops.kernel_launches()["bilstm_scan"]
        out = originals["_speaker_rescore"](results, sp)
        stats["rescore_k1"] += ops.kernel_launches()["bilstm_scan"] - k1
        return out

    def score_one(rec, insts):
        if rec["feat_row"].shape[0] != 1 or insts.shape[0] != 1:
            fail("speaker rescoring: more than one path in a call")
        stats["paths"] += 1
        return score(rec, insts)

    def timed(fn):
        def run(a, *args, **kwargs):
            before = dict(stats)
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn(a, *args, **kwargs)
            torch.cuda.synchronize()
            runs.append((a.env.name, fn.__name__, time.perf_counter() - start,
                         {k: stats[k] - before[k] for k in stats}, out))
            return out
        return run

    picked_ok = [0]

    def checked(split):
        env, scorer = world.envs[split], world.evaluators[split].score
        scan_of = {item["instr_id"]: item["scan"] for item in env.data}

        def run(results, **kwargs):
            for r in results:
                g = env.graphs[scan_of[r["instr_id"]]]
                if not walk_connected(g, [t[0] for t in r["trajectory"]]):
                    fail(f"search: the picked trajectory of "
                         f"{r['instr_id']} is not a connected walk")
            picked_ok[0] += len(results)
            return scorer(results, **kwargs)
        return run

    search._begin, search._search_step = begin, step
    search._speaker_rescore = rescore
    search.beam_search_test = timed(originals["beam_search_test"])
    search.state_factored_search_test = timed(
        originals["state_factored_search_test"])
    speaker.score_instruction = score_one
    for split in ("val_seen", "val_unseen"):
        world.evaluators[split].score = checked(split)

    def only(split):
        sub = copy.copy(world)
        sub.envs = {k: v for k, v in world.envs.items()
                    if k in ("train", split)}
        return sub

    torch.cuda.synchronize()
    ops.reset_kernel_launches()
    try:
        out = {"dijkstra": beam_valid(cfg.replace(candidates=1), world,
                                      agent=agent, speaker=speaker),
               "param_search": beam_valid(
                   cfg.replace(candidates=3, param_search=True),
                   only("val_seen"), agent=agent, speaker=speaker),
               "state_factored": beam_valid(
                   cfg.replace(search_type="state_factored"),
                   only("val_unseen"), agent=agent, speaker=speaker)}
        torch.cuda.synchronize()
    finally:
        launches = ops.kernel_launches()
        for key, fn in originals.items():
            setattr(search, key, fn)
        del speaker.score_instruction
        for split in ("val_seen", "val_unseen"):
            del world.evaluators[split].score
    print(f"  launches during the searches: {launches}", flush=True)
    for name in EVAL_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} never launched during the searches")
    if stats["rescore_k1"] <= 0:
        fail("the speaker's rescoring never launched K1 at one row")
    for split, fn_name, seconds, delta, results in runs:
        want = {item["instr_id"] for item in world.envs[split].data}
        if set(results) != want:
            fail(f"{fn_name} {split}: {len(results)} results for "
                 f"{len(want)} episodes")
        for res in results.values():
            for p in res["paths"]:
                if not (np.isfinite(p["listener_scores"]).all()
                        and np.isfinite(p["speaker_scores"]).all()):
                    fail(f"{fn_name} {split}: non-finite scores")
        n_paths = sum(len(r["paths"]) for r in results.values())
        print(f"  {fn_name} on {split}: {seconds:.2f} s; "
              f"{delta['batches']} batches, "
              f"{delta['expansions'] / max(delta['batches'], 1):.1f} "
              f"expansions a batch; {n_paths} paths kept, each rescored "
              f"alone ({delta['rescore_k1']} K1 launches)", flush=True)
    for kind, res in out.items():
        for split, summary in res.items():
            if kind == "param_search":
                best = summary["best"]
                print(f"  {kind} {split}: best avg_speaker={best[0]} "
                      f"avg_listener={best[1]} alpha={best[2]:.2f} "
                      f"SR={best[3]:.4f} over {len(summary['logs'])} "
                      "settings", flush=True)
            else:
                check_summary(f"{kind} {split}", summary)
                print(f"  {kind} {split}: SR {summary['success_rate']:.4f} "
                      f"SPL {summary['spl']:.4f} NE "
                      f"{summary['nav_error']:.4f}", flush=True)
    print(f"  {picked_ok[0]} picked trajectories, each a connected walk; "
          f"card {card_name()}", flush=True)

    # the first expansion under always and never, same weights
    state = agent.policy.state_dict()
    lps = []
    for mode in ("always", "never"):
        a = agent if mode == "always" else make_agent(
            cfg.replace(use_pallas="never"), world, rng_seed=seed + 1)
        a.policy.load_state_dict(state)
        a.env = world.envs["val_unseen"]
        a.env.reset_epoch()
        obs, text, _vps, _res, zero = search._begin(a)
        _states, lp = search._search_step(
            a, text, [zero] * obs.batch_size(),
            [True] * obs.batch_size(), obs)
        real = np.arange(lp.shape[1])[None, :] <= obs.cand_n[:, None]
        lps.append(torch.from_numpy(lp[real]))
    check_close("first expansion log-probs always vs never", lps[0],
                lps[1], 0.0, 5e-2)
    return launches


def phase_pretrain(cfg, world, seed: int, root: str):
    """run_pretrain at the headline BERT width; returns the Pretrainer and
    its snapshot directory."""
    import torch

    from dasa_tpu_torch import ops
    from dasa_tpu_torch.pretrain import (
        PretrainBatcher,
        generate_pretrain_records,
    )
    from dasa_tpu_torch.pretrain.trainer import Pretrainer, run_pretrain

    cfg = cfg.replace(train="pretrain", name="pretrain",
                      iters=PRETRAIN_STEPS, warm_steps=PRETRAIN_WARM,
                      log_every=PRETRAIN_STEPS, val_every=10 ** 9,
                      save_every=10 ** 9, snap_dir=os.path.join(root, "snap"))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    pt = run_pretrain(cfg, world)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = ops.kernel_launches()
    hist = pt.history
    losses = [h["loss"] for h in hist]
    if len(hist) != PRETRAIN_STEPS or pt.optimizer.count != PRETRAIN_STEPS:
        fail(f"pretrain: {len(hist)} steps, {pt.optimizer.count} optimizer "
             f"steps, expected {PRETRAIN_STEPS}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"pretrain: non-finite loss in {losses}")
    snap = os.path.join(cfg.snap_dir, cfg.name, "pretrain")
    if not os.path.isfile(os.path.join(snap, f"checkpoint-{PRETRAIN_STEPS}")):
        fail(f"pretrain: no checkpoint-{PRETRAIN_STEPS} in {snap}")
    tok = world.tok
    init = Pretrainer(cfg, world.feature_db, len(tok)).model.state_dict()
    moved = sum(not torch.equal(v, init[k])
                for k, v in pt.model.state_dict().items())
    del init
    if moved < len(pt.model.state_dict()) // 2:
        fail(f"pretrain: only {moved} tensors moved")
    step_s = [h["seconds"] for h in hist]
    med = statistics.median(step_s[1:])
    print(f"  launches during run_pretrain(): {launches} (the pretraining "
          "path has no TPU kernel)", flush=True)
    print(f"  pretrain: step s {[round(x, 4) for x in step_s]}, median "
          f"after the first {med:.4f} s, {cfg.batch_size / med:.2f} "
          f"samples/s; loss step 1 {losses[0]:.4f}, step "
          f"{PRETRAIN_STEPS} {losses[-1]:.4f}; {moved} tensors moved; "
          f"peak memory {peak / 2 ** 30:.2f} GiB; card {card_name()}",
          flush=True)
    mask = tok.word_to_index["<MASK>"]
    val = PretrainBatcher(
        generate_pretrain_records(world.envs["val_seen"],
                                  max_steps=cfg.max_action),
        cfg.batch_size, len(tok), mask, seed=seed + 1)
    out = pt.evaluate(val, max_batches=10)
    if not all(math.isfinite(v) for v in out.values()):
        fail(f"pretrain: evaluate() {out}")
    print(f"  evaluate() on val_seen: loss {out['loss']:.4f} mlm_acc "
          f"{out['mlm_acc']:.4f} act_acc {out['act_acc']:.4f}", flush=True)
    check_bf16_against_f32(cfg, world, pt, next(val.epoch()))
    return pt, snap


def check_bf16_against_f32(cfg, world, pt, batch) -> None:
    """One batch through the bf16 Pretrainer and an f32 copy of its
    weights: the loss, and the MLM logits at the masked positions and the
    action logits (their error against the f32 logits' largest magnitude,
    and the argmax agreement), each within its limit, and the bf16
    model's logits f32.  Prints, beside
    them, a control that rounds the bf16 model's logits to bf16 and takes
    the loss's log-softmaxes in bf16, the precision the f32 logits keep."""
    import torch

    from dasa_tpu_torch.pretrain.model import _masked_ce
    from dasa_tpu_torch.pretrain.trainer import Pretrainer

    pt32 = Pretrainer(cfg.replace(compute_dtype="float32"), world.feature_db,
                      len(world.tok))
    pt32.model.load_state_dict(pt.model.state_dict())
    l16, m16, a16 = pt.eval_outputs(batch)
    l32, m32, a32 = pt32.eval_outputs(batch)
    del pt32
    if not m16.dtype == a16.dtype == torch.float32:
        fail(f"pretrain: the bf16 model's logits are {m16.dtype} / "
             f"{a16.dtype}, not float32")
    labels, actions = (torch.as_tensor(np.asarray(batch[k])).to(m16.device)
                       for k in ("labels", "action"))
    masked = labels >= 0
    control = (_masked_ce(m16.bfloat16(), labels)
               + _masked_ce(a16.bfloat16(), actions)).item()
    l16, l32 = l16.item(), l32.item()
    gap = abs(l16 - l32) / abs(l32)
    print(f"  one batch's loss bf16 {l16:.6f} vs f32 {l32:.6f}: "
          f"{gap:.3e} of the f32 loss (limit {PRETRAIN_BF16_RTOL:.0e}); "
          f"control (bf16 log-softmax of bf16 logits) "
          f"{abs(control - l32) / abs(l32):.3e}", flush=True)
    if not gap <= PRETRAIN_BF16_RTOL:
        fail(f"pretrain: bf16 loss {l16} vs f32 {l32}")
    for name, got, ref in (("MLM", m16[masked], m32[masked]),
                           ("action", a16, a32)):
        err = ((got - ref).abs().max() / ref.abs().max()).item()
        agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
        print(f"  {name} logits ({ref.shape[0]} rows): max error "
              f"{err:.3e} of the f32 logits' largest magnitude (limit "
              f"{PRETRAIN_LOGIT_RTOL:.0e}), argmax agreement {agree:.4f} "
              f"(limit {PRETRAIN_ARGMAX_AGREE})", flush=True)
        if not (err <= PRETRAIN_LOGIT_RTOL
                and agree >= PRETRAIN_ARGMAX_AGREE):
            fail(f"pretrain: bf16 {name} logits against f32: error {err}, "
                 f"argmax agreement {agree}")


def check_graft(label, got, bert, plain):
    """Every ``encoder.bert.*`` tensor of ``got`` equals ``bert`` (a
    DicModel state dict; a shorter word table its leading rows), every
    other tensor the un-grafted listener's ``plain``."""
    import torch

    n_bert = 0
    for k, v in plain.items():
        g = got[k]
        if not k.startswith("encoder.bert."):
            same = torch.equal(g, v)
        else:
            src = bert[k[len("encoder.bert."):]].to(g.device)
            rows = src.shape[0] if src.dim() == 2 else None
            same = (torch.equal(g[:rows], src)
                    and torch.equal(g[rows:], v[rows:])
                    if rows is not None and rows < g.shape[0]
                    else torch.equal(g, src))
            n_bert += 1
        if not same:
            fail(f"{label}: {k} is not what the graft should give")
    print(f"  {label}: {n_bert} encoder.bert tensors equal the source "
          f"exactly, {len(plain) - n_bert} others kept their init",
          flush=True)


def phase_pretrain_chain(cfg, world, seed: int, root: str, pt, snap: str):
    """The pretrained listener: (a) grafted from phase 14's snapshot,
    trained and validated; (b) grafted from an HF-style .bin; (c) its
    checkpoint loaded back."""
    import torch

    from dasa_tpu_torch import ops
    from dasa_tpu_torch.train.trainer import make_agent, train, valid

    cfg = cfg.replace(iters=CHAIN_ITERS, log_every=1, val_every=10 ** 9,
                      save_every=10 ** 9, name="chain",
                      snap_dir=os.path.join(root, "snap"),
                      log_dir=os.path.join(root, "log"))
    bert = pt.export_bert_params()
    plain = make_agent(cfg, world, rng_seed=seed)
    init = plain.policy.state_dict()
    torch.cuda.synchronize()
    ops.reset_kernel_launches()
    agent = make_agent(cfg.replace(pretrain_model_name=snap), world,
                       rng_seed=seed)
    check_graft("(a) graft from the Pretrainer snapshot",
                agent.policy.state_dict(), bert, init)
    start = time.perf_counter()
    train(cfg, world, agent=agent)
    out = valid(cfg, world, agent=agent)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = ops.kernel_launches()
    losses = [float(x) for x in agent.logs["loss"]]
    if agent.iter_count != CHAIN_ITERS or not all(
            math.isfinite(x) for x in losses):
        fail(f"pretrain-chain: {agent.iter_count} iterations, losses "
             f"{losses}")
    for split, summary in out.items():
        check_summary(split, summary)
    print(f"  (a) {CHAIN_ITERS} train() iterations and valid(): "
          f"{seconds:.2f} s; losses {losses}; SR "
          f"{ {k: round(v['success_rate'], 4) for k, v in out.items()} }",
          flush=True)
    print(f"  launches during the chain: {launches}", flush=True)
    for name in PATH_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} never launched in the pretrained chain")
    ckpt = os.path.join(root, "chain_listener")
    agent.save(CHAIN_ITERS, ckpt)
    trained = {k: v.detach().clone()
               for k, v in agent.policy.state_dict().items()}
    del agent
    # (b) the reference's on-disk form: DicAddActionPreTrain keys, the
    # word table at the BERT vocab's rows (the tail from the listener)
    word = "embeddings.word_embeddings.weight"
    full = dict(bert)
    table = init[f"encoder.bert.{word}"].clone()
    table[:bert[word].shape[0]] = bert[word]
    full[word] = table
    state = {f"bert.{k}": v.cpu() for k, v in full.items()}
    for k, v in pt.model.state_dict().items():
        if not k.startswith("bert."):
            state[k] = v.cpu()
    state["mlmhead.predictions.decoder.weight"] = state[f"bert.{word}"]
    if table.shape[0] != BERT_VOCAB:
        fail(f"listener word table has {table.shape[0]} rows")
    hf = os.path.join(root, "hf")
    os.makedirs(hf)
    torch.save(state, os.path.join(hf, "pytorch_model.bin"))
    del state
    agent = make_agent(cfg.replace(pretrain_model_name=hf), world,
                       rng_seed=seed)
    check_graft("(b) graft from an HF pytorch_model.bin",
                agent.policy.state_dict(), full, init)
    del agent
    # (c) the trained listener's checkpoint back into a fresh listener
    plain.load(ckpt)
    got = plain.policy.state_dict()
    bad = [k for k, v in trained.items() if not torch.equal(got[k], v)]
    if bad:
        fail(f"pretrain-chain: checkpoint round trip differs at {bad[:5]}")
    print(f"  (c) the listener checkpoint loads back equal ({len(trained)} "
          "tensors)", flush=True)
    return launches


def variant_launch_check(label, launches, must):
    """The kernels of ``must`` launched; every other one of K1-K4 (K1 in
    either direction's wrapper) never did."""
    for name in ("bilstm_scan", "lstm_scan", "lstm_scan_bwd",
                 "adain_channel_gate", "shift_attend"):
        if (launches[name] > 0) != (name in must):
            fail(f"{label}: {name} launched {launches[name]} "
                 f"times, expected {'some' if name in must else 'none'}")


def variant_logs_check(label, logs, aux_keys):
    """Every logged loss finite; each configured auxiliary term logged and
    nonzero in some pass."""
    for key, vals in logs.items():
        if not all(math.isfinite(v) for v in vals):
            fail(f"{label}: non-finite {key} {vals}")
    for key in aux_keys:
        if not logs.get(key) or not any(v != 0.0 for v in logs[key]):
            fail(f"{label}: {key} not logged or zero: "
                 f"{logs.get(key)}")


def variant_train(label, cfg, world, seed, aux_keys):
    """train() of ``cfg`` (its ``iters`` optimizer steps) on a fresh agent;
    returns (agent, s an iteration, peak bytes) after the checks: the
    losses finite, and every trained component's parameters moved.  The
    peak is printed beside what the card held when train() began (the
    agent's weights and whatever earlier phases keep alive)."""
    import torch

    from dasa_tpu_torch.train.trainer import make_agent, train

    agent = make_agent(cfg, world, rng_seed=seed)
    iter_s, logs = [], {}
    run_iters = agent.train
    before = {name: p.detach().clone()
              for name, p in agent.policy.named_parameters()
              if p.requires_grad}

    def timed(n_iters, feedback):
        torch.cuda.synchronize()
        start = time.perf_counter()
        run_iters(n_iters, feedback=feedback)
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - start)
        for key, vals in agent.logs.items():  # train() resets them
            if key != "stream_consumed":
                logs.setdefault(key, []).extend(float(v) for v in vals)

    agent.train = timed
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    train(cfg, world, agent=agent)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del agent.train
    if agent.iter_count != cfg.iters or len(iter_s) != cfg.iters:
        fail(f"{label}: {agent.iter_count} optimizer steps, "
             f"{len(iter_s)} timed, expected {cfg.iters}")
    variant_logs_check(label, logs, aux_keys)
    moved = {name.split(".")[0] for name, p in agent.policy.named_parameters()
             if name in before and not torch.equal(p.detach(), before[name])}
    want = {name.split(".")[0] for name in before}
    if moved != want:
        fail(f"{label}: parameters of {sorted(moved)} moved, "
             f"expected {sorted(want)}")
    aux = {k: round(statistics.mean(logs[k]), 6) for k in aux_keys}
    print(f"  {label}: s an iteration {[round(x, 4) for x in iter_s]}; "
          f"peak {peak / 2 ** 30:.2f} GiB ({held / 2 ** 30:.2f} GiB held "
          f"when train() began); losses "
          f"{[round(x, 4) for x in logs['loss']]}; aux means {aux}",
          flush=True)
    return agent, iter_s, peak


def phase_variants(cfg, seed: int, root: str):
    """Each configuration of VARIANTS: train() (VARIANT_ITERS episodic
    iterations) and valid() on val_unseen, the launch counters set to 0
    before and read after; configuration 1 adds a stream window, a
    host-rollout iteration and an always-vs-never teacher pass (phase 6's
    limits, not counted), configuration 8 a stream window."""
    import shutil

    import torch

    from dasa_tpu_torch import ops
    from dasa_tpu_torch.train.trainer import World, make_agent, valid

    world = World(cfg, val_splits=("val_unseen",))
    total = {}
    card = card_name()
    for n, (label, over, aux_keys, must, extra) in enumerate(VARIANTS, 1):
        config_start = time.perf_counter()
        base = cfg.replace(**over, iters=VARIANT_ITERS, log_every=1,
                           val_every=10 ** 9, save_every=10 ** 9,
                           name=f"variant{n}",
                           snap_dir=os.path.join(root, "variants"),
                           log_dir=os.path.join(root, "variants_log"))
        torch.cuda.synchronize()
        ops.reset_kernel_launches()
        agent, iter_s, peak = variant_train(label, base, world, seed,
                                            aux_keys)
        trajs = capture_results(agent)
        start = time.perf_counter()
        out = valid(base, world, agent=agent)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - start
        del agent.test
        check_coverage(world, trajs)
        check_summary("val_unseen", out["val_unseen"])
        del agent
        for regime in (r for r in extra if r != "compare"):
            # one more optimizer step in another regime
            over_r = (dict(rollout_mode="stream") if regime == "stream"
                      else dict(device_rollout="never"))
            agent, _, _ = variant_train(
                f"{label} ({regime})", base.replace(iters=1, **over_r),
                world, seed, aux_keys)
            del agent
        torch.cuda.synchronize()
        launches = ops.kernel_launches()
        print(f"  {label}: valid() {eval_s:.2f} s, SR "
              f"{out['val_unseen']['success_rate']:.4f}; launches "
              f"{launches}; card {card}", flush=True)
        variant_launch_check(label, launches, must)
        add_launches(total, launches)
        if "compare" in extra:
            variant_teacher_compare(label, base, world, seed)
        shutil.rmtree(os.path.join(root, "variants"), ignore_errors=True)
        gc.collect()
        print(f"  ({label}: {time.perf_counter() - config_start:.1f} s)",
              flush=True)
    return total


def variant_teacher_compare(label, cfg, world, seed: int,
                            loss_rtol: float = 5e-2, cos_floor: float = 0.99):
    """The same weights under use_pallas always and never, dropout off:
    one teacher pass at train_ml 1 (the heads' terms in its loss); phase
    6's limits on the loss and the gradients' cosine unless others are
    given."""
    import torch

    from dasa_tpu_torch.train.trainer import make_agent

    cfg = cfg.replace(**NO_DROPOUT)
    env = world.envs["train"]
    state, results = None, []
    for mode in ("always", "never"):
        agent = make_agent(cfg.replace(use_pallas=mode), world,
                           rng_seed=seed)
        if state is None:
            state = agent.policy.state_dict()
        agent.policy.load_state_dict(state)
        agent.env = env
        env.reset_epoch()
        agent.zero_grad()
        agent.device_rollout(train_ml=1.0, train_rl=False,
                             feedback="teacher")
        grad = torch.cat([p.grad.float().flatten()
                          for p in agent.policy.parameters()
                          if p.grad is not None])
        results.append((float(agent.losses[-1]), grad))
        del agent
    (la, ga), (ln, gn) = results
    cos = float(torch.dot(ga, gn) / (ga.norm() * gn.norm()))
    print(f"  {label}: teacher pass loss always {la:.6f} never {ln:.6f}; "
          f"gradient cosine {cos:.6f}", flush=True)
    if not abs(la - ln) <= loss_rtol * abs(ln):
        fail(f"{label}: teacher loss {la} vs {ln} beyond {loss_rtol:.0%}")
    if not cos >= cos_floor:
        fail(f"{label}: gradient cosine {cos} below {cos_floor}")


def phase_encoders(cfg, seed: int, root: str):
    """Each configuration of ENCODERS on a fresh agent: train()
    (ENCODER_ITERS episodic iterations) and valid() on val_unseen, the
    launch counters set to 0 before and read after; configuration 1 adds
    a stream window, a host-rollout iteration, a Dijkstra beam_valid() of
    val_unseen and the always-vs-never comparisons of
    :func:`encoder_pass_compare` (not counted), configuration 8 a stream
    window.  Then one MultiDicEncoder
    forward at the headline width, with and without the LSTM kernel."""
    import shutil

    import torch

    from dasa_tpu_torch import ops
    from dasa_tpu_torch.train.trainer import World, beam_valid, valid

    # one world of 66 items a split (more than the batch of 64), built at
    # each batch size; the depth table serves the channel AdaIN
    data_cfg, _ = headline_world(os.path.join(root, "encoders"), seed,
                                 n_train=22, n_val=22)
    worlds = {b: World(data_cfg.replace(batch_size=b),
                       val_splits=("val_unseen",))
              for b in {over.get("batch_size", cfg.batch_size)
                        for _label, over, _must, _extra in ENCODERS}}
    total = {}
    card = card_name()
    for n, (label, over, must, extra) in enumerate(ENCODERS, 1):
        config_start = time.perf_counter()
        base = cfg.replace(**over, iters=ENCODER_ITERS, log_every=1,
                           val_every=10 ** 9, save_every=10 ** 9,
                           name=f"encoder{n}",
                           snap_dir=os.path.join(root, "enc_snap"),
                           log_dir=os.path.join(root, "enc_log"))
        world = worlds[base.batch_size]
        torch.cuda.synchronize()
        ops.reset_kernel_launches()
        agent, iter_s, peak = variant_train(label, base, world, seed, ())
        trajs = capture_results(agent)
        start = time.perf_counter()
        out = valid(base, world, agent=agent)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - start
        del agent.test
        check_coverage(world, trajs)
        check_summary("val_unseen", out["val_unseen"])
        if "search" in extra:
            start = time.perf_counter()
            found = beam_valid(base.replace(candidates=1), world,
                               agent=agent)
            torch.cuda.synchronize()
            check_summary("beam_valid val_unseen", found["val_unseen"])
            print(f"  {label}: Dijkstra beam_valid() of val_unseen "
                  f"{time.perf_counter() - start:.2f} s, SR "
                  f"{found['val_unseen']['success_rate']:.4f}", flush=True)
        del agent
        for regime in ("stream", "host"):
            if regime in extra:  # one more optimizer step in this regime
                over_r = (dict(rollout_mode="stream") if regime == "stream"
                          else dict(device_rollout="never"))
                agent, _, _ = variant_train(
                    f"{label} ({regime})", base.replace(iters=1, **over_r),
                    world, seed, ())
                del agent
        torch.cuda.synchronize()
        launches = ops.kernel_launches()
        print(f"  {label}: valid() {eval_s:.2f} s, SR "
              f"{out['val_unseen']['success_rate']:.4f}; launches "
              f"{launches}; card {card}", flush=True)
        variant_launch_check(label, launches, must)
        add_launches(total, launches)
        if "compare" in extra:
            encoder_pass_compare(label, base, world, seed)
        shutil.rmtree(os.path.join(root, "enc_snap"), ignore_errors=True)
        gc.collect()
        print(f"  ({label}: {time.perf_counter() - config_start:.1f} s)",
              flush=True)
    multi_dic_compare(cfg, seed)
    return total


def encoder_pass_compare(label, cfg, world, seed: int):
    """The same weights under use_pallas always and never, dropout off:
    (a) phase 16's teacher pass (phase 6's limits; the replay takes the
    LSTMs on their plain path, so the two differ where K3 / K4 run);
    (b) the per-episode text encode of one batch with the LSTM through
    its kernels (K1 forward, K2 backward) and on its plain path: the
    cache {ctx, h0, c0} within phase 4's limit and the gradients of a
    fixed random projection of it with a cosine above phase 6's floor."""
    import torch

    from dasa_tpu_torch import ops
    from dasa_tpu_torch.train.trainer import make_agent

    variant_teacher_compare(label, cfg, world, seed)
    agent = make_agent(cfg.replace(**NO_DROPOUT), world, rng_seed=seed)
    agent.env = world.envs["train"]
    agent.env.reset_epoch()
    _dev, _ep, instr, valid, seq_len = agent._batch_inputs()
    gen = torch.Generator(device="cpu").manual_seed(seed)
    proj, out = {}, []
    for kernel in (True, False):
        agent.policy.zero_grad(set_to_none=True)
        before = ops.kernel_launches()
        cache = agent.policy.encode_text(instr, valid, seq_len, kernel)
        for key, val in cache.items():
            proj.setdefault(key, torch.randn(val.shape, generator=gen)
                            .to(val.device))
        sum((val.float() * proj[key]).sum()
            for key, val in cache.items()).backward()
        torch.cuda.synchronize()
        after = ops.kernel_launches()
        k12 = [after[k] - before[k] for k in K12]
        if (min(k12) > 0) != kernel or (max(k12) > 0) != kernel:
            fail(f"encoders {label}: text encode with lstm_kernel={kernel} "
                 f"launched K1 / K2 {k12} times")
        grad = torch.cat([p.grad.float().flatten()
                          for p in agent.policy.encoder.parameters()
                          if p.grad is not None])
        out.append(({k: v.detach() for k, v in cache.items()}, grad))
    (ck, gk), (cp, gp) = out
    # the kernel keeps the carry in f32 where the plain path rounds it to
    # bf16 at every op: a few bf16 ulps of the outputs' scale
    for key in ck:
        check_close(f"{label} text encode {key} kernel vs plain", ck[key],
                    cp[key], 0.0, 5e-2)
    cos = float(torch.dot(gk, gp) / (gk.norm() * gp.norm()))
    print(f"  {label}: text encode gradient cosine kernel vs plain "
          f"{cos:.6f}", flush=True)
    if not cos >= 0.99:
        fail(f"encoders {label}: text encode gradient cosine {cos} below "
             "0.99")


def multi_dic_compare(cfg, seed: int):
    """One MultiDicEncoder forward (MULTI_S sentences x the headline batch,
    the headline BERT and top BiLSTM) with the LSTM through its kernel
    (the 3B rows in one launch a direction) and on its plain path:
    phase 4's bf16 limit on the per-sentence contexts and the averaged
    init states."""
    import torch

    from dasa_tpu_torch import ops
    from dasa_tpu_torch.models.encoder import MultiDicEncoder
    from dasa_tpu_torch.models.policy import bert_config_from

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        enc = MultiDicEncoder(bert_config_from(cfg), cfg.d_enc_hidden_size,
                              cfg.d_hidden_size, compute_dtype=bf)
    enc = enc.to(dev).eval()
    b, length = cfg.batch_size, cfg.max_input
    instr = torch.randint(1, 2000, (b, MULTI_S, length), generator=gen)
    lengths = torch.randint(8, length + 1, (b, MULTI_S), generator=gen)
    valid = torch.arange(length)[None, None, :] < lengths[..., None]
    f_t = torch.randn(b, 36, cfg.feature_all_size, generator=gen).abs()
    instr, valid, lengths, f_t = (x.to(dev) for x in (instr, valid, lengths,
                                                      f_t))
    outs = []
    with torch.no_grad():
        text = enc.text_forward(instr, valid)
        for kernel in (True, False):
            before = ops.kernel_launches()["bilstm_scan"]
            outs.append(enc(text, valid, lengths, f_t.to(bf),
                            lstm_kernel=kernel))
            torch.cuda.synchronize()
            k1 = ops.kernel_launches()["bilstm_scan"] - before
            if (k1 > 0) != kernel:
                fail(f"MultiDicEncoder: lstm_kernel={kernel} launched the "
                     f"LSTM kernel {k1} times")
    (ctx_k, h_k, c_k, _), (ctx_p, h_p, c_p, _) = outs
    if ctx_k.shape != (b, MULTI_S, length, 2 * cfg.d_enc_hidden_size):
        fail(f"MultiDicEncoder: ctx shape {tuple(ctx_k.shape)}")
    # the kernel keeps the carry in f32 where the plain path rounds to
    # bf16 at every op: a few bf16 ulps of the outputs' scale
    for name, got, ref in (("ctx", ctx_k, ctx_p), ("decoder_init", h_k, h_p),
                           ("c_t", c_k, c_p)):
        check_close(f"MultiDicEncoder {name} kernel vs plain", got, ref, 0.0,
                    5e-2)


def ndh_world(root: str, seed: int):
    """The headline listener's config under ``--train ndh --history all
    --path_type trusted_path`` and its NDH world: CVDN dialogs of about
    NDH_WORDS words (``testing.write_ndh_task``) over a synthetic world,
    30 train and 10 + 10 val dialogs."""
    from dasa_tpu_torch.config import Config
    from dasa_tpu_torch.testing import (
        write_ndh_task,
        write_synthetic_connectivity,
    )
    from dasa_tpu_torch.train.trainer import World

    conn = os.path.join(root, "ndh_connectivity")
    data = os.path.join(root, "ndh_task")
    write_synthetic_connectivity(conn, ["synthA", "synthB"], n_nodes=40,
                                 seed=seed)
    write_ndh_task(data, ["synthA"], ["synthB"], conn, n_train=30, n_val=10,
                   dialog_words=NDH_WORDS, seed=seed)
    cfg = Config(**{**HEADLINE, **TRAIN, **NDH}, train="ndh",
                 use_pallas="always", data_dir=data, connectivity_dir=conn,
                 seed=seed)
    return cfg, World(cfg, ndh=True)


def phase_ndh(seed: int, root: str):
    """NDH at the headline width: the launch counters set to 0,
    ``train()`` (NDH_ITERS episodic iterations), ``valid()`` of both val
    splits (``validndh``) and one stream window, the counters read back;
    then the teacher pass under always and never (loss within 1%,
    gradient cosine above 0.999; not counted)."""
    import torch

    from dasa_tpu_torch import ops
    from dasa_tpu_torch.train.trainer import valid

    cfg, world = ndh_world(root, seed)
    cfg = cfg.replace(iters=NDH_ITERS, log_every=1, val_every=10 ** 9,
                      save_every=10 ** 9, name="ndh",
                      snap_dir=os.path.join(root, "ndh_snap"),
                      log_dir=os.path.join(root, "ndh_log"))
    tokens = [int((np.asarray(item["instr_encoding"]) != 0).sum())
              for env in world.envs.values() for item in env.data]
    print(f"  NDH world: {', '.join(f'{k} {v.size()}' for k, v in world.envs.items())}"
          f" dialogs; instruction tokens {min(tokens)}-{max(tokens)} of "
          f"max_input {cfg.max_input}, max_action {cfg.max_action}",
          flush=True)
    if max(tokens) != cfg.max_input:
        fail(f"ndh: the longest instruction has {max(tokens)} tokens, "
             f"not max_input {cfg.max_input}")
    torch.cuda.synchronize()
    ops.reset_kernel_launches()
    agent, iter_s, peak = variant_train("ndh", cfg, world, seed, ())
    trajs = capture_results(agent)
    steps0 = agent.total_env_steps
    start = time.perf_counter()
    out = valid(cfg, world, agent=agent)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - start
    del agent.test
    check_coverage(world, trajs)
    eval_steps = agent.total_env_steps - steps0
    for split, summary in out.items():
        check_summary(f"ndh {split}", summary)
    del agent
    gc.collect()
    _agent, stream_s, stream_peak = variant_train(
        "ndh (stream)", cfg.replace(iters=1, rollout_mode="stream"), world,
        seed, ())
    del _agent
    torch.cuda.synchronize()
    launches = ops.kernel_launches()
    card = card_name()
    print(f"  ndh: train() s an iteration {[round(x, 4) for x in iter_s]}, "
          f"peak {peak / 2 ** 30:.2f} GiB; validndh valid() {eval_s:.2f} s, "
          f"{eval_steps / eval_s:.2f} agent-steps/s ({eval_steps} "
          f"agent-steps), SR "
          f"{', '.join(f'{k} {v['success_rate']:.4f}' for k, v in out.items())}"
          f"; stream window {stream_s[0]:.4f} s, peak "
          f"{stream_peak / 2 ** 30:.2f} GiB; launches {launches}; card "
          f"{card}", flush=True)
    variant_launch_check("ndh", launches, PATH_KERNELS)
    gc.collect()
    variant_teacher_compare("ndh", cfg, world, seed, loss_rtol=1e-2,
                            cos_floor=0.999)
    return launches


def _flat_grad(agent):
    import torch

    return torch.cat([p.grad.float().flatten()
                      for p in agent.policy.parameters()
                      if p.grad is not None])


def remat_pass(agent, total):
    """One sampled pass of ``agent`` from zeroed gradients, the launch
    counters set to 0 before and added to ``total`` after.  Returns (s,
    agent-steps, peak and held bytes)."""
    import torch

    from dasa_tpu_torch import ops

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ops.reset_kernel_launches()
    start = time.perf_counter()
    agent.zero_grad()
    agent.device_rollout(train_ml=None, train_rl=True, feedback="sample")
    torch.cuda.synchronize()
    pass_s = time.perf_counter() - start
    add_launches(total, ops.kernel_launches())
    return (pass_s, int(agent._env_steps_log[-1]),
            torch.cuda.max_memory_allocated(), held)


def phase_knobs(cfg, world, seed: int, root: str):
    """The JAX knobs on the headline episodic pair (batch 20): (a)
    KNOB_ITERS iterations of ``accumulate_gradient("sample")`` under
    ``bench.py``'s episodic default ``fuse_passes="auto"``, which the port
    runs as the split pair (two passes an iteration), s an iteration; (b)
    one sampled pass of that agent under each remat mode from the same
    generator state: the gradients within REMAT_RTOL (relative L2) of
    never's, s a pass and the peak memory; (c) the sampled passes of
    phase 17's BertImg and mcatt under remat never and percept: the peak
    memory.  The counters are set to 0 before each run and read
    after."""
    import torch

    from dasa_tpu_torch import ops
    from dasa_tpu_torch.train.trainer import World, make_agent

    card = card_name()
    total = {}
    env = world.envs["train"]
    agent = make_agent(cfg.replace(fuse_passes="auto"), world, rng_seed=seed)
    agent.env = env
    env.reset_epoch()
    gc.collect()
    iter_s, iter_steps = [], []
    torch.cuda.synchronize()
    ops.reset_kernel_launches()
    for _ in range(KNOB_ITERS):
        start = time.perf_counter()
        agent.zero_grad()
        agent.accumulate_gradient("sample", ml_weight=cfg.ml_weight)
        agent.optim_step()
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - start)
        iter_steps.append(agent.env_steps_total() - sum(iter_steps))
    launches = ops.kernel_launches()
    add_launches(total, launches)
    losses = [float(x) for x in agent.losses]
    passes = len(agent._env_steps_log)
    if passes != 2 * KNOB_ITERS or not all(math.isfinite(x) for x in losses):
        fail(f"fuse_passes=auto: {passes} passes (expected the split pair's "
             f"{2 * KNOB_ITERS}), losses {losses}")
    print(f"  fuse_passes=auto (the split pair): s an iteration "
          f"{[round(x, 4) for x in iter_s]}; agent-steps an iteration "
          f"{iter_steps}; {passes} passes; launches {launches}; card {card}",
          flush=True)
    variant_launch_check("fuse_passes=auto", launches, PATH_KERNELS)

    # (b) one sampled pass under each remat mode on this agent, each from
    # the same generator state (the rollout counter set back) and batch
    counter = agent._rollout_counter
    base_grad, base_steps = None, None
    for mode in REMAT_MODES:
        agent.cfg = cfg.replace(remat=mode)
        agent._rollout_counter = counter
        env.reset_epoch()
        pass_s, steps, peak, held = remat_pass(agent, total)
        grad = _flat_grad(agent)
        if base_grad is None:
            base_grad, base_steps = grad, steps
        rel = float((grad - base_grad).norm() / base_grad.norm())
        print(f"  remat={mode}: sampled pass {pass_s:.4f} s, {steps} "
              f"agent-steps, peak {peak / 2 ** 30:.2f} GiB ({held / 2 ** 30:.2f}"
              f" GiB held before), gradient relative error to never "
              f"{rel:.3e}; card {card}", flush=True)
        if steps != base_steps or not rel <= REMAT_RTOL:
            fail(f"remat={mode}: {steps} agent-steps vs {base_steps}, "
                 f"gradient relative error {rel} > {REMAT_RTOL}")
        del grad
    del agent, base_grad
    gc.collect()

    # (c) the peaks of phase 17's BertImg and mcatt: the sampled pass from
    # the same batch and generator state under both modes
    data_cfg, _ = headline_world(os.path.join(root, "knobs"), seed,
                                 n_train=22, n_val=22)
    for label, over in (("7 BertImg", dict(encoder_type="BertImg")),
                        ("10 mcatt", dict(PLAIN, encoder_type="Dic",
                                          include_vision=True,
                                          agent_type="mcatt"))):
        base = cfg.replace(**over)
        wld = World(data_cfg.replace(batch_size=base.batch_size),
                    val_splits=("val_unseen",))
        agent = make_agent(base, wld, rng_seed=seed)
        for mode in ("never", "percept"):
            agent.cfg = base.replace(remat=mode)
            agent._rollout_counter = 0
            wld.envs["train"].reset_epoch()
            pass_s, steps, peak, held = remat_pass(agent, total)
            loss = float(agent.losses[-1])
            print(f"  {label} sampled pass, remat={mode}: "
                  f"{pass_s:.4f} s, {steps} agent-steps, peak "
                  f"{peak / 2 ** 30:.2f} GiB ({held / 2 ** 30:.2f} GiB "
                  f"held before), loss {loss:.4f}, batch "
                  f"{base.batch_size}; card {card}", flush=True)
            if not math.isfinite(loss):
                fail(f"{label} remat={mode}: loss {loss}")
        del agent, wld
        gc.collect()
    return total


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def timed_train_iters(agent, store):
    """Wrap ``agent.train`` to time each call (train() runs one iteration
    per log interval), synchronizing the card around it."""
    import torch

    run_iters = agent.train

    def timed(n_iters, feedback):
        torch.cuda.synchronize()
        start = time.perf_counter()
        run_iters(n_iters, feedback=feedback)
        torch.cuda.synchronize()
        store.append(time.perf_counter() - start)

    agent.train = timed


def phase_dp(cfg, world, seed: int, root: str):
    """(a) A one-rank NCCL job through the launcher variables: train() with
    data_parallel, DP_ITERS episodic iterations, then DP_ITERS stream
    windows, each run ending in the rank-0 checkpoint; every kernel must
    launch.  (b) Two gloo ranks on this card (NCCL refuses two ranks on
    one device), started as processes of this script."""
    import torch

    from dasa_tpu_torch import ops
    from dasa_tpu_torch.parallel import distributed
    from dasa_tpu_torch.train.trainer import make_agent, train

    launch = {"COORDINATOR_ADDRESS": f"localhost:{free_port()}",
              "NUM_PROCESSES": "1", "PROCESS_ID": "0"}
    os.environ.update(launch)
    try:
        cfg1 = cfg.replace(data_parallel=True, iters=DP_ITERS, log_every=1,
                           val_every=10 ** 9, save_every=10 ** 9, name="dp",
                           snap_dir=os.path.join(root, "snap"),
                           log_dir=os.path.join(root, "log"))
        agent = make_agent(cfg1, world, rng_seed=seed)
        backend = torch.distributed.get_backend()
        if backend != "nccl" or agent.mesh is None or agent._dp is None:
            fail(f"dp (a): backend {backend}, mesh {agent.mesh}: expected "
                 "a one-rank NCCL data axis")
        iter_s, window_s = [], []
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_kernel_launches()
        timed_train_iters(agent, iter_s)
        train(cfg1, world, agent=agent)
        losses = [float(x) for x in agent.logs["loss"]]
        del agent.train
        agent.cfg = agent.cfg.replace(rollout_mode="stream")
        timed_train_iters(agent, window_s)
        train(cfg1.replace(rollout_mode="stream"), world, agent=agent)
        torch.cuda.synchronize()
        launches = ops.kernel_launches()
        peak = torch.cuda.max_memory_allocated()
        losses += [float(x) for x in agent.logs["loss"]]
        del agent.train
        print(f"  (a) one-rank NCCL job: launches {launches}", flush=True)
        for name in PATH_KERNELS:
            if launches[name] <= 0:
                fail(f"dp (a): kernel {name} never launched")
        if len(iter_s) != DP_ITERS or len(window_s) != DP_ITERS or \
                agent.iter_count != 2 * DP_ITERS:
            fail(f"dp (a): {len(iter_s)} iterations, {len(window_s)} "
                 f"windows, {agent.iter_count} optimizer steps")
        if not all(math.isfinite(x) for x in losses):
            fail(f"dp (a): non-finite loss in {losses}")
        ckpt = os.path.join(root, "snap", "dp", "state_dict",
                            f"LAST_iter{DP_ITERS}")
        if not os.path.isfile(ckpt):
            fail(f"dp (a): no rank-0 checkpoint {ckpt}")
        print(f"  (a) s an iteration {[round(x, 4) for x in iter_s]}, s a "
              f"window {[round(x, 4) for x in window_s]}; losses "
              f"{[round(x, 4) for x in losses]}; peak memory "
              f"{peak / 2 ** 30:.2f} GiB; checkpoint {os.path.basename(ckpt)}"
              f"; card {card_name()}", flush=True)
        del agent
    finally:
        distributed.shutdown()
        for key in launch:
            os.environ.pop(key, None)
    gc.collect()
    torch.cuda.empty_cache()
    return launches, phase_dp_ranks(cfg, seed, root)


def phase_dp_ranks(cfg, seed: int, root: str):
    """(b): two rank processes (``--dp-worker``) over gloo; each writes
    its measurements to ``dp_rank{r}.json``, which this reads and checks."""
    spec = {"data_dir": cfg.data_dir, "connectivity_dir":
            cfg.connectivity_dir, "seed": seed, "root": root,
            "coordinator": f"localhost:{free_port()}"}
    spec_path = os.path.join(root, "dp_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    start = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--dp-worker", str(r), "--dp-spec", spec_path])
             for r in range(2)]
    try:
        codes = [p.wait(timeout=DP_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - start
    if codes != [0, 0]:
        fail(f"dp (b): rank processes exited {codes}")
    ranks = []
    for r in range(2):
        with open(os.path.join(root, f"dp_rank{r}.json")) as f:
            ranks.append(json.load(f))
    for r, out in enumerate(ranks):
        print(f"  (b) rank {r}: backend {out['backend']}, s an iteration "
              f"{out['iter_s']:.4f}, s a window {out['window_s']:.4f}, s a "
              f"pretraining step {[round(x, 4) for x in out['pretrain_s']]}, "
              f"peak memory {out['peak'] / 2 ** 30:.2f} GiB, launches "
              f"{out['launches']}", flush=True)
        if out["backend"] != "gloo":
            fail(f"dp (b): rank {r} backend {out['backend']}")
        for name in PATH_KERNELS:
            if out["launches"][name] <= 0:
                fail(f"dp (b): kernel {name} never launched on rank {r}")
    ref = ranks[0]["reference"]
    r = ref["bf16"]
    norm, r_norm = r["grad_norms"]
    print(f"  (b) episodic pair (bf16, always) at D = 2 against one rank at "
          f"batch {cfg.batch_size}: losses {ranks[0]['losses']['bf16']} vs "
          f"{r['losses']}; gradient cosine {r['grad_cos']:.6f}, gradient "
          f"norm {norm:.6f} vs {r_norm:.6f} (ratio {norm / r_norm:.6f}), "
          f"update cosine {r['update_cos']:.6f}; argmax paths equal "
          f"{r['same_paths']}/{r['paths']}", flush=True)
    for got, want in zip(ranks[0]["losses"]["bf16"], r["losses"]):
        if not abs(got - want) <= DP_LOSS_RTOL * abs(want):
            fail(f"dp (b): loss {got} vs one rank's {want} beyond "
                 f"{DP_LOSS_RTOL}")
    if not (r["grad_cos"] >= DP_GRAD_COS
            and abs(norm / r_norm - 1) <= DP_NORM_RTOL
            and r["update_cos"] >= DP_UPDATE_COS):
        fail(f"dp (b): gradient cosine {r['grad_cos']} (floor "
             f"{DP_GRAD_COS}), norm ratio {norm / r_norm} (within "
             f"{DP_NORM_RTOL} of 1), update cosine {r['update_cos']} "
             f"(floor {DP_UPDATE_COS})")
    if ranks[0]["losses"] != ranks[1]["losses"]:
        fail(f"dp (b): the ranks report different losses {ranks[0]['losses']}"
             f" / {ranks[1]['losses']}")
    uids = ranks[0]["window_uids"]
    print(f"  (b) two stream windows at D = 2: {len(uids)} episodes taken, "
          f"{len(set(uids))} distinct", flush=True)
    if not uids or len(uids) != len(set(uids)):
        fail("dp (b): an episode was taken twice across the ranks")
    p_norms, r_pnorms = ref["pretrain_grad_norms"]
    print(f"  (b) pretraining at D = 2 against one rank: losses "
          f"{ranks[0]['pretrain_losses']} vs {ref['pretrain_losses']}; "
          f"gradient norms {p_norms} vs {r_pnorms}; update cosine "
          f"{ref['pretrain_update_cos']:.6f}", flush=True)
    for got, want, rtol in (
            [(a, b, DP_LOSS_RTOL) for a, b in zip(
                ranks[0]["pretrain_losses"], ref["pretrain_losses"])]
            + [(a, b, DP_NORM_RTOL) for a, b in zip(p_norms, r_pnorms)]):
        if not abs(got - want) <= rtol * abs(want):
            fail(f"dp (b): pretraining loss or gradient norm {got} vs "
                 f"{want} beyond {rtol}")
    if not ref["pretrain_update_cos"] >= DP_GRAD_COS:
        fail(f"dp (b): pretraining update cosine "
             f"{ref['pretrain_update_cos']} below {DP_GRAD_COS}")
    print(f"  (b) both ranks: {seconds:.1f} s wall (process start "
          "included)", flush=True)
    return [out["launches"] for out in ranks]


def _cos(a, b) -> float:
    return float((a @ b) / (a.norm() * b.norm()))


def dp_worker(rank: int, spec_path: str) -> None:
    """One rank of phase 20 (b), at D = 2 with dropout off: the episodic
    teacher + fused argmax pair and its step (twice: the first compared,
    the second timed), two stream windows and their steps (the second
    timed) and two pretraining steps; then, for the comparison, rank 0
    runs the first pair and rank 1 the pretraining steps on one rank (no
    mesh)."""
    import torch

    from dasa_tpu_torch import ops
    from dasa_tpu_torch.config import Config
    from dasa_tpu_torch.parallel import distributed
    from dasa_tpu_torch.pretrain import (
        PretrainBatcher,
        generate_pretrain_records,
    )
    from dasa_tpu_torch.pretrain.trainer import Pretrainer
    from dasa_tpu_torch.train.trainer import World, make_agent

    with open(spec_path) as f:
        spec = json.load(f)
    os.environ.update(COORDINATOR_ADDRESS=spec["coordinator"],
                      NUM_PROCESSES="2", PROCESS_ID=str(rank))
    # two ranks share the one card: gloo, asked for (NCCL takes a card a
    # rank)
    distributed.initialize(backend="gloo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seed = spec["seed"]
    cfg = Config(**{**HEADLINE, **TRAIN, **NO_DROPOUT}, data_parallel=True,
                 use_pallas="always", data_dir=spec["data_dir"],
                 connectivity_dir=spec["connectivity_dir"], seed=seed)
    world = World(cfg)
    agent = make_agent(cfg, world, rng_seed=seed)
    mesh = agent.mesh
    backend = torch.distributed.get_backend()
    env = world.envs["train"]
    # the split's order and shuffling state: a batch that wraps the split
    # reshuffles it, so each pair starts from the same two
    order, shuffle_state = list(env.data), env._rng.getstate()

    def pair(agent):
        """The teacher + fused argmax pair of the split's first two
        batches and its step: (losses, applied gradients, update of the
        trained components, the argmax pass's paths of all ranks)."""
        env.data[:] = order
        env._rng.setstate(shuffle_state)
        env.reset_epoch()
        params = [p for name, p in agent.policy.named_parameters()
                  if name.startswith(TRAINED)]
        before = torch.cat([p.detach().flatten().float() for p in params])
        agent.zero_grad()
        agent.device_rollout(train_ml=0.2, train_rl=False,
                             feedback="teacher")
        record = {}
        agent.device_rollout(train_ml=0.2, train_rl=True, feedback="argmax",
                             record=record)
        rec = record["stacked"]
        paths = [rec["action"][rec["active"][:, i], i].tolist()
                 for i in range(rec["action"].shape[1])]
        if agent.mesh is not None:
            paths = sum(agent.mesh.gather_objects(paths), [])
        grads = {}
        step = agent.optimizer.step

        def spy():
            grads["g"] = torch.cat([
                (p.grad if p.grad is not None else torch.zeros_like(p))
                .flatten().float() for p in params])
            step()

        agent.optimizer.step = spy
        agent.optim_step()
        del agent.optimizer.step
        after = torch.cat([p.detach().flatten().float() for p in params])
        return ([float(x) for x in agent.losses], grads["g"], after - before,
                paths)

    def window():
        agent.zero_grad()
        agent.device_rollout_stream(0.2, feedback="sample", record=True)
        agent.optim_step()

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    # the first pair, from the initial weights, is compared with one rank's;
    # the second pair and the second window are timed (the first ones warm
    # up)
    compared = {"bf16": pair(agent)}
    start = time.perf_counter()
    pair(agent)
    torch.cuda.synchronize()
    iter_s = time.perf_counter() - start
    window()
    start = time.perf_counter()
    window()
    torch.cuda.synchronize()
    window_s = time.perf_counter() - start
    launches = ops.kernel_launches()
    taken = []
    for rec in agent._stream_host().records:
        taken += rec["rec_uid"][rec["rec_take"]
                                & (rec["rec_uid"] >= 0)].cpu().tolist()
    uids = sum(mesh.gather_objects(taken), [])

    tok = world.tok
    if "<MASK>" not in tok.word_to_index:
        tok.add_word("<MASK>")
    pcfg = cfg.replace(iters=DP_ITERS, warm_steps=1)
    batches = list(PretrainBatcher(
        generate_pretrain_records(env, max_steps=cfg.max_action),
        cfg.batch_size, len(tok), tok.word_to_index["<MASK>"],
        seed=seed).epoch())[:DP_ITERS]

    def pretrain(pmesh):
        """(losses, update, seconds, the norm of each step's gradients
        as the optimizer takes them: summed over the ranks, unclipped)."""
        pt = Pretrainer(pcfg, world.feature_db, len(tok), mesh=pmesh)
        before = torch.cat([p.detach().flatten().float()
                            for p in pt.model.parameters()])
        norms = []
        step = pt.optimizer.step

        def spy():
            norms.append(float(torch.cat([
                p.grad.flatten().float() for p in pt.optimizer.params
                if p.grad is not None]).norm()))
            step()

        pt.optimizer.step = spy
        out = [pt.train_step(b)[0] for b in batches]
        after = torch.cat([p.detach().flatten().float()
                           for p in pt.model.parameters()])
        seconds = [h["seconds"] for h in pt.history]
        return out, after - before, seconds, norms

    p_losses, p_update, p_seconds, p_norms = pretrain(mesh)
    peak = torch.cuda.max_memory_allocated()
    out = {"backend": backend,
           "losses": {k: v[0] for k, v in compared.items()},
           "iter_s": iter_s,
           "window_s": window_s, "launches": launches, "window_uids": uids,
           "pretrain_losses": p_losses, "pretrain_s": p_seconds,
           "peak": peak}
    # one rank's runs, side by side: rank 0 the pair, rank 1 pretraining
    # (each holds the job's gradients and updates, equal on both ranks)
    if rank == 0:
        losses, grads, update, paths = compared["bf16"]
        r_losses, r_grads, r_update, r_paths = pair(make_agent(
            cfg.replace(data_parallel=False), world, rng_seed=seed))
        ref = {"bf16": {
            "losses": r_losses, "grad_cos": _cos(grads, r_grads),
            "grad_norms": [float(grads.norm()), float(r_grads.norm())],
            "update_cos": _cos(update, r_update),
            "same_paths": sum(a == b for a, b in zip(paths, r_paths)),
            "paths": len(r_paths)}}
    else:
        r_plosses, r_pupdate, _, r_pnorms = pretrain(None)
        ref = {"pretrain_losses": r_plosses,
               "pretrain_update_cos": _cos(p_update, r_pupdate),
               "pretrain_grad_norms": [p_norms, r_pnorms]}
    out["reference"] = {k: v for part in mesh.gather_objects(ref)
                        for k, v in part.items()}
    mesh.barrier()
    with open(os.path.join(spec["root"], f"dp_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def conv_flops(model, image_size) -> float:
    """Operations (2 per multiply-add) of the network's convolutions on one
    (H, W) image, counted from their output shapes with forward hooks."""
    import torch

    total = [0.0]

    def hook(mod, _inp, out):
        k = mod.kernel_size[0] * mod.kernel_size[1]
        total[0] += 2.0 * out.numel() * mod.in_channels // mod.groups * k

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.inference_mode():
            model(torch.zeros(1, *image_size, 3, device="cuda"))
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def skybox_views(rng, face: int):
    """The 36 views (480 x 640) of one panorama rendered by sim/render.py
    from seeded depth-like skybox faces: a smooth field per face plus
    noise, in metres."""
    from dasa_tpu_torch.sim.render import render_panorama

    yy, xx = np.mgrid[0:face, 0:face] / face
    faces = []
    for _ in range(6):
        a, b, c = rng.uniform(0.5, 4.0, 3)
        field = 1.0 + a * np.sin(b * np.pi * xx) ** 2 + c * yy
        faces.append((field + rng.uniform(0, 0.1, field.shape))[..., None])
    return render_panorama(faces, width=640, height=480)[..., 0].astype(
        np.float32)


def phase_offline(cfg, seed: int, root: str):
    """Render, featurize on the card, check against f32, write the npy
    pair for every viewpoint of the headline world's val_unseen scan, load
    it as that split's depth_db and run one valid() batch on it.  Returns
    (agent, world) for phase 22."""
    import torch

    from dasa_tpu_torch.pipelines.depth_features import (
        ViewFeaturizer,
        featurize_views,
        normalize_depth,
    )
    from dasa_tpu_torch.train.trainer import World, make_agent, valid

    rng = np.random.default_rng(seed)
    start = time.perf_counter()
    panos = [skybox_views(rng, OFFLINE_FACE) for _ in range(OFFLINE_RENDERED)]
    render_s = time.perf_counter() - start
    featurizer = ViewFeaturizer(seed=seed)
    x = torch.from_numpy(np.stack([normalize_depth(v) for v in panos[0]])
                         .astype(np.float32)).cuda()
    ms = time_ms(lambda: featurizer.features(x), iters=5, warmup=2)
    dev_ms = device_ms(lambda: featurizer.features(x), iters=3, warmup=1,
                       reps=3)
    ref = ViewFeaturizer(seed=seed, dtype=torch.float32)
    got, want = featurizer.features(x), ref.features(x)
    cos = torch.nn.functional.cosine_similarity(got, want, dim=1)
    f32_ms = time_ms(lambda: ref.features(x), iters=3, warmup=1)
    flops = conv_flops(ref.model, featurizer.image_size) * x.shape[0]
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    n_bytes = x.numel() * 3 * 2 + 2048 * x.shape[0] * 4 + 2 * sum(
        p.numel() for p in featurizer.model.parameters())
    bound, bound_by = bound_ms(n_bytes, flops)
    print(f"  rendered {OFFLINE_RENDERED} panoramas of 36 views (480 x 640) "
          f"from seeded skyboxes in {render_s:.2f} s on the host", flush=True)
    print(f"  ResNet-152 bf16 against f32 on one viewpoint's 36 views: "
          f"cosine of each view's 2048 features min {float(cos.min()):.6f} "
          f"(limit {OFFLINE_COS})", flush=True)
    if not (bool(got.isfinite().all()) and float(cos.min()) >= OFFLINE_COS):
        fail(f"offline: bf16 features against f32: cosine {float(cos.min())}")
    # the val_unseen split's world: every viewpoint, in the image
    # features' row order
    world = World(cfg, splits=(), val_splits=("val_unseen",))
    ids = [tuple(i.split("_", 1)) for i in world.feature_db.ids]

    def load_views(scan, vp):
        """A rendered panorama, its headings turned by the viewpoint's
        index so that no two viewpoints see the same views."""
        k = ids.index((scan, vp))
        views = panos[k % OFFLINE_RENDERED].reshape(3, 12, 480, 640)
        return np.roll(views, k // OFFLINE_RENDERED, axis=1).reshape(
            36, 480, 640)

    prefix = os.path.join(root, "depth", "resnet152_depth")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    values = featurize_views(ids, load_views, prefix, featurizer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated()
    n_img = 36 * len(ids)
    print(f"  featurized {len(ids)} viewpoints ({n_img} views) in "
          f"{wall:.2f} s: {1e3 * wall / len(ids):.2f} ms a viewpoint with the "
          f"host's normalisation and copies, {n_img / wall:.1f} images/s; one "
          f"viewpoint on the card {ms:.2f} ms (CUDA events), {dev_ms:.2f} ms "
          f"device, f32 {f32_ms:.2f} ms; bound {bound:.3f} ms ({bound_by}: "
          f"{flops / x.shape[0] / 1e9:.1f} GFLOP an image); peak memory "
          f"{peak / 2 ** 30:.2f} GiB; card {card_name()}", flush=True)
    cfg2 = cfg.replace(depth_features_path=prefix + ".npy")
    world = World(cfg2, splits=(), val_splits=("val_unseen",))
    if world.depth_db.ids != [f"{s}_{v}" for s, v in ids] or \
            not np.array_equal(world.depth_db.values, values):
        fail("offline: the npy pair read back differs")
    agent = make_agent(cfg2, world, env_name="val_unseen", rng_seed=seed)
    out = valid(cfg2, world, agent=agent)
    check_summary("offline valid()", out["val_unseen"])
    print(f"  valid() of val_unseen (one batch) on the featurized depth: "
          f"SR {out['val_unseen']['success_rate']:.4f} SPL "
          f"{out['val_unseen']['spl']:.4f}", flush=True)
    return agent, world


def phase_native(world, agent):
    """The native engine against the python one on the synthetic world:
    candidates, a teacher walk's observations, and the host-rollout
    evaluation of val_unseen (trajectories, SR, SPL), with the host
    seconds of each."""
    from dasa_tpu_torch.env import R2REnv
    from dasa_tpu_torch.sim import csim
    from dasa_tpu_torch.sim.engine import compute_pano_candidates

    lib = csim.load_library()
    built = ("found built" if csim.build_seconds is None else
             f"built by make in {csim.build_seconds:.2f} s")
    print(f"  native library {os.path.relpath(lib._name)}: {built}",
          flush=True)
    if not os.path.realpath(lib._name).startswith(
            os.path.realpath(str(csim.BUILD_DIR))):
        fail(f"native: loaded {lib._name}, not the port's build")
    env = world.envs["val_unseen"]
    if env.backend != "native":
        fail(f"native: the world's env runs {env.backend}")
    n = 0
    for scan in env.scans:
        g, h = env.graphs[scan], env._scan_handle[scan]
        for node in np.nonzero(g.included)[0]:
            py = compute_pano_candidates(g, int(node))
            nbr, point, nh, elev, rd = env.native.candidates(h, int(node))
            n += 1
            if not (np.array_equal(nbr, py.nbr_ix)
                    and np.array_equal(point, py.point_id)
                    and np.allclose(nh, py.normalized_heading, atol=1e-5)
                    and np.allclose(elev, py.elevation, atol=1e-5)
                    and np.allclose(rd, py.rel_distance, atol=1e-4)):
                fail(f"native: candidates of {scan} node {node} differ")
    cfg = agent.cfg
    items = world.envs["val_unseen"].data
    envs = {b: R2REnv(world.feature_db, items, batch_size=cfg.batch_size,
                      seed=cfg.seed, connectivity_dir=cfg.connectivity_dir,
                      max_candidates=cfg.max_candidates,
                      max_input=cfg.max_input, backend=b)
            for b in ("native", "python")}
    obs = {b: e.reset() for b, e in envs.items()}
    trajs = {b: [[t] for t in e.state_tuples()] for b, e in envs.items()}
    steps = 0
    while True:
        a, b = obs["native"], obs["python"]
        for f in ("feat_row", "view_index", "cand_point_id", "cand_nbr_ix",
                  "cand_n", "teacher", "back_teacher"):
            if not np.array_equal(getattr(a, f), getattr(b, f)):
                fail(f"native: obs field {f} differs at step {steps}")
        for f in ("heading", "elevation", "cand_heading", "cand_elevation",
                  "distance", "progress"):
            if not np.allclose(getattr(a, f), getattr(b, f), atol=1e-4):
                fail(f"native: obs field {f} differs at step {steps}")
        act = np.where(b.teacher < b.cand_n, b.teacher, -1)
        if (act < 0).all():
            break
        obs = {k: e.step(act, trajs[k]) for k, e in envs.items()}
        steps += 1
    if [[v for v, _, _ in t] for t in trajs["native"]] != \
            [[v for v, _, _ in t] for t in trajs["python"]]:
        fail("native: teacher-walk trajectories differ")
    print(f"  candidates of {n} nodes and a teacher walk of {steps} steps "
          f"over {cfg.batch_size} episodes equal", flush=True)
    agent.cfg = cfg.replace(device_rollout="never")
    evals = {}
    for backend in ("native", "python"):
        env = R2REnv(world.feature_db, world.envs["val_unseen"].data,
                     batch_size=cfg.batch_size, seed=cfg.seed,
                     connectivity_dir=cfg.connectivity_dir,
                     max_candidates=cfg.max_candidates,
                     max_input=cfg.max_input, backend=backend,
                     name="val_unseen")
        env_s = [0.0]
        for name in ("reset", "step"):
            fn = getattr(env, name)

            def wrapped(*args, fn=fn, **kwargs):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                env_s[0] += time.perf_counter() - t0
                return out

            setattr(env, name, wrapped)
        agent.env = env
        start = time.perf_counter()
        results = agent.test(feedback="argmax")
        seconds = time.perf_counter() - start
        summary, _ = world.evaluators["val_unseen"].score(results)
        evals[backend] = ({r["instr_id"]: [v for v, _, _ in r["trajectory"]]
                           for r in results}, summary)
        print(f"  host-rollout evaluation of val_unseen under {backend}: "
              f"{seconds:.3f} s, the env's reset / step {env_s[0]:.4f} s; SR "
              f"{summary['success_rate']:.4f} SPL {summary['spl']:.4f}",
              flush=True)
    agent.cfg = cfg
    (t_nat, s_nat), (t_py, s_py) = evals["native"], evals["python"]
    if t_nat != t_py:
        fail("native: valid() trajectories differ between the backends")
    for key in ("success_rate", "spl"):
        if abs(s_nat[key] - s_py[key]) > 1e-9:
            fail(f"native: {key} {s_nat[key]} vs {s_py[key]}")


# ---------------------------------------------------------------------------
# phase 23: the operational scripts (dasa_tpu_torch/scripts)
# ---------------------------------------------------------------------------
def cfg_flags(kw) -> list:
    return [x for key, val in kw.items() for x in (f"--{key}", str(val))]


def counted(fn, *args):
    """(fn's result, the kernels' launches during it, its seconds)."""
    import torch

    from dasa_tpu_torch import ops

    gc.collect()
    torch.cuda.synchronize()
    ops.reset_kernel_launches()
    start = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, ops.kernel_launches(), time.perf_counter() - start


def check_launched(label, launches, names):
    print(f"  launches during {label}: {launches}", flush=True)
    for name in names:
        if launches[name] <= 0:
            fail(f"kernel {name} never launched during {label}")


def phase_scripts(seed: int, root: str):
    """The repo's operational scripts on the port, through their ``main``,
    on a synthetic world whose ``scans.txt`` the phase writes: (a)
    ``make_task``; a speaker at its Config widths trained SCRIPT_SPK_ITERS
    iterations at batch 64 and saved; ``make_aug_paths --load`` of it
    (up to SCRIPT_AUG_PATHS 4-6 hop paths a train scan, greedy, batch 64);
    one headline ``auglistener`` iteration on the written file.  (b)
    ``check_real_data`` on TSV image features, an explicit vocab and the
    (a) listener's weights in the reference's per-component layout
    (``adaIn``), against a ``valid()`` by that listener; a copy with a
    split file removed.  (c) ``stream_quality_ab`` at headline width,
    both regimes, SCRIPT_AB_STEPS agent-steps in 2 milestones.  The
    launch counters are set to 0 before each script and read after."""
    import torch

    from dasa_tpu_torch.config import Config
    from dasa_tpu_torch.data.datasets import load_datasets
    from dasa_tpu_torch.data.features import FeatureDB
    from dasa_tpu_torch.scripts import (
        check_real_data,
        make_aug_paths,
        make_task,
        stream_quality_ab,
    )
    from dasa_tpu_torch.testing import (
        write_feature_tsv,
        write_synthetic_connectivity,
    )
    from dasa_tpu_torch.train.trainer import World, make_speaker, train

    base = os.path.join(root, "scripts")
    conn, data = os.path.join(base, "connectivity"), os.path.join(base, "task")
    scans = ["synthA", "synthB"]
    write_synthetic_connectivity(conn, scans, n_nodes=40, seed=seed)
    with open(os.path.join(conn, "scans.txt"), "w") as f:
        f.write("\n".join(scans) + "\n")
    total = {}

    # ---- (a) make_task, a speaker, make_aug_paths, auglistener ---------
    make_task.main(["--out", data, "--connectivity", conn, "--train_scans",
                    "1", "--unseen_scans", "1", "--n_train",
                    str(SCRIPT_N_TRAIN), "--n_val", str(SCRIPT_N_VAL),
                    "--seed", str(seed)])
    spk_kw = dict(HEADLINE, **SPEAKER, batch_size=SPK_B, use_pallas="always",
                  data_dir=data, connectivity_dir=conn, seed=seed)
    spk_cfg = Config(**spk_kw)
    speaker = make_speaker(spk_cfg, World(spk_cfg))
    losses = speaker.train(SCRIPT_SPK_ITERS)
    if not all(math.isfinite(x) for x in losses):
        fail(f"scripts (a): speaker losses {losses}")
    spk_path = os.path.join(base, "speaker")
    speaker.save(SCRIPT_SPK_ITERS, spk_path)
    del speaker
    aug_path = os.path.join(data, "R2R_aug_gen.json")
    captions = []
    caption_paths = make_aug_paths.caption_paths

    def recorded(*args, **kwargs):
        captions.append(caption_paths(*args, **kwargs))
        return captions[-1]

    make_aug_paths.caption_paths = recorded
    try:
        raw, launches, seconds = counted(make_aug_paths.main, [
            "--out", aug_path, "--n_per_scan", str(SCRIPT_AUG_PATHS),
            "--min_hops", "4", "--max_hops", "6", "--load", spk_path,
            *cfg_flags(spk_kw)])
    finally:
        make_aug_paths.caption_paths = caption_paths
    check_launched("make_aug_paths", launches, ("bilstm_scan",))
    add_launches(total, launches)
    with open(aug_path) as f:
        written = json.load(f)
    (path2inst, decode_s), = captions
    ids = [it["path_id"] for it in written]
    if not 0 < len(written) == len(raw) <= SCRIPT_AUG_PATHS:
        fail(f"scripts (a): {len(written)} items written, {len(raw)} "
             f"sampled (at most {SCRIPT_AUG_PATHS})")
    if len(set(ids)) != len(ids) or set(path2inst) != set(ids):
        fail(f"scripts (a): {len(set(ids))} path ids over {len(ids)} items, "
             f"{len(path2inst)} captioned")
    placeholders = sum(it["instructions"] == ["placeholder"]
                       for it in written)
    print(f"  make_aug_paths: {len(written)} paths sampled and captioned "
          f"once each ({placeholders} placeholders for an empty caption, "
          f"the speaker trained {SCRIPT_SPK_ITERS} iterations); "
          f"decode (up to {spk_cfg.max_decode} words, teacher path "
          f"included) s a batch of {SPK_B} "
          f"{[round(x, 4) for x in decode_s]}; the script {seconds:.2f} s; "
          f"card {card_name()}", flush=True)

    cfg_aug = Config(**{**HEADLINE, **TRAIN}, use_pallas="always",
                     data_dir=data, connectivity_dir=conn, seed=seed,
                     train="auglistener", aug=aug_path, iters=2, log_every=2,
                     val_every=10 ** 9, save_every=10 ** 9,
                     snap_dir=os.path.join(base, "snap"),
                     log_dir=os.path.join(base, "log"), name="scripts_aug")
    world = World(cfg_aug)
    if len(world.envs["aug"].data) != len(written):
        fail(f"scripts (a): --aug loaded {len(world.envs['aug'].data)} of "
             f"{len(written)} items")
    agent, launches, seconds = counted(train, cfg_aug, world)
    check_launched("the auglistener iteration", launches, PATH_KERNELS)
    add_launches(total, launches)
    losses = [float(x) for x in agent.logs["loss"]]
    if agent.iter_count != 1 or not losses or not all(
            math.isfinite(x) for x in losses):
        fail(f"scripts (a): auglistener {agent.iter_count} steps, losses "
             f"{losses}")
    print(f"  auglistener --aug: one iteration (an org and an aug pass "
          f"pair) in {seconds:.2f} s, all {len(written)} items loaded, "
          f"losses {[round(x, 4) for x in losses]}", flush=True)

    # ---- (b) check_real_data on its checkpoint -------------------------
    tsv = os.path.join(base, "img.tsv")
    write_feature_tsv(FeatureDB.synthetic(scans, conn, dim=HEADLINE[
        "feature_size"]), tsv)
    vocab = os.path.join(base, "vocab.txt")
    with open(os.path.join(data, "train_vocab.txt")) as f, open(vocab,
                                                                "w") as g:
        g.write(f.read())
    agent.save(agent.iter_count, os.path.join(base, "listener"))
    blob = torch.load(os.path.join(base, "listener"), map_location="cpu")
    ckpt = os.path.join(base, "reference_listener")
    torch.save({("adaIn" if name == "adain" else name):
                {k: v for k, v in entry.items() if k != "iteration"}
                for name, entry in blob.items()}, ckpt)
    del blob
    want = {}
    for split in ("val_seen", "val_unseen"):
        agent.env = world.envs[split]
        want[split], _ = world.evaluators[split].score(
            agent.test(feedback="argmax"))
    del agent, world
    listener = dict(HEADLINE, **TRAIN, use_pallas="always",
                    connectivity_dir=conn, seed=seed)
    argv = ["--img_features", tsv, "--vocab", vocab, "--checkpoint", ckpt,
            "--flags", " ".join(cfg_flags(listener))]
    report, launches, seconds = counted(check_real_data.main,
                                        ["--data_dir", data, *argv])
    check_launched("check_real_data", launches, EVAL_KERNELS)
    add_launches(total, launches)
    for split, entry in report.items():
        got = entry["summary"]
        ids = [r["instr_id"] for r in entry["results"]]
        expected = {f"{it['path_id']}_{j}" for it in load_datasets(
            [split], data) for j in range(len(it["instructions"]))}
        if len(ids) != len(set(ids)) or set(ids) != expected:
            fail(f"check_real_data {split}: {len(set(ids))} instr_ids of "
                 f"{len(ids)} results, {len(expected)} expected")
        for key in ("success_rate", "spl"):
            if got[key] != want[split][key]:
                fail(f"check_real_data {split}: {key} {got[key]} against "
                     f"{want[split][key]} by the saving listener")
        print(f"  check_real_data {split}: SR {got['success_rate']:.4f} SPL "
              f"{got['spl']:.4f} NE {got['nav_error']:.4f}, equal to the "
              f"saving listener's valid(); {len(ids)} instr_ids once each; "
              f"{entry['seconds']:.3f} s", flush=True)
    if set(report) != {"val_seen", "val_unseen"}:
        fail(f"check_real_data: splits {sorted(report)}")
    missing = os.path.join(base, "task_missing")
    os.makedirs(missing)
    for split in ("train", "val_seen"):
        with open(os.path.join(data, f"R2R_{split}.json")) as f, open(
                os.path.join(missing, f"R2R_{split}.json"), "w") as g:
            g.write(f.read())
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            check_real_data.main(["--data_dir", missing, *argv])
        fail("check_real_data without R2R_val_unseen.json did not exit")
    except SystemExit as e:
        if e.code != 1 or not out.getvalue().startswith("FAILED: "):
            fail(f"check_real_data without a split file: exit {e.code}, "
                 f"{out.getvalue()!r}")
    print(f"  check_real_data: {seconds:.2f} s, READY; without "
          f"R2R_val_unseen.json exit 1, {out.getvalue().strip()!r}",
          flush=True)

    # ---- (c) stream_quality_ab at headline width ------------------------
    ab_path = os.path.join(base, "stream_ab.json")
    log = io.StringIO()
    before = os.environ.get("DASA_CONNECTIVITY_DIR")
    os.environ["DASA_CONNECTIVITY_DIR"] = conn
    try:
        with contextlib.redirect_stdout(log):
            ab, launches, seconds = counted(stream_quality_ab.main, [
                "--data_dir", data, "--regimes", "episodic,stream",
                "--total_steps", str(SCRIPT_AB_STEPS), "--n_milestones", "2",
                "--use_pallas", "always", "--out", ab_path, "--save_dir",
                os.path.join(base, "ab_snap")])
    finally:
        if before is None:
            del os.environ["DASA_CONNECTIVITY_DIR"]
        else:
            os.environ["DASA_CONNECTIVITY_DIR"] = before
        print(log.getvalue(), end="", flush=True)
    check_launched("stream_quality_ab", launches, PATH_KERNELS)
    add_launches(total, launches)
    with open(ab_path) as f:
        if json.load(f) != json.loads(json.dumps(ab)):
            fail("stream_quality_ab: the JSON differs from the run")
    table = [x for x in log.getvalue().splitlines()
             if x.startswith("| episodic |") or x.startswith("| stream |")]
    if len(table) != 2:
        fail(f"stream_quality_ab: table rows {table}")
    if [r["regime"] for r in ab["runs"]] != ["episodic", "stream"]:
        fail(f"stream_quality_ab: runs {[r['regime'] for r in ab['runs']]}")
    for run in ab["runs"]:
        if not os.path.exists(os.path.join(base, "ab_snap",
                                           f"{run['regime']}_seed1")):
            fail(f"stream_quality_ab {run['regime']}: no checkpoint")
        rows = run["rows"]
        steps = [row["agent_steps"] for row in rows]
        if len(rows) != 3 or steps[0] != 0 or not all(
                s >= m for s, m in zip(steps[1:], ab["milestones"])):
            fail(f"stream_quality_ab {run['regime']}: agent-steps {steps}, "
                 f"milestones {ab['milestones']}")
        for row in rows:
            for split in ("val_seen", "val_unseen"):
                if split not in row or not all(
                        math.isfinite(v) for v in row[split].values()):
                    fail(f"stream_quality_ab {run['regime']}: row {row}")
        print(f"  stream_quality_ab {run['regime']}: "
              f"{run['train_seconds']:.2f} s training with its validations, "
              + "; ".join(
                  f"{row['agent_steps']} agent-steps ({row['iters']} "
                  f"iterations): val_seen SR {row['val_seen']['success_rate']}"
                  f" SPL {row['val_seen']['spl']}, val_unseen SR "
                  f"{row['val_unseen']['success_rate']} SPL "
                  f"{row['val_unseen']['spl']}" for row in rows),
              flush=True)
    print(f"  stream_quality_ab: {seconds:.2f} s in all; launches in phase "
          f"23: {total}; card {card_name()}", flush=True)
    return total

def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def profile_window(label: str, fn, steps_of):
    """fn() once under torch.profiler: device busy share of its wall time
    and device time by kernel; steps_of() counts its agent-steps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    steps0 = steps_of()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    rows = []  # device-side events only (kernels, copies, sets)
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if evt.device_type == DeviceType.CUDA and dev_us > 0:
            rows.append((dev_us / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    print(f"  {label}: wall {wall_ms:.2f} ms for {steps_of() - steps0} "
          f"agent-steps; device busy {device_ms:.2f} ms "
          f"({100 * device_ms / wall_ms:.1f}% of wall)", flush=True)
    for ms, count, key in rows[:25]:
        print(f"    {ms:9.3f} ms {count:6d}x  {key[:90]}", flush=True)


def phase_profile(cfg, cfg_train, world, seed: int):
    """Where one eval batch's, one training iteration's, one stream
    window's, one selfTrain iteration's, one search batch's, one
    host-rollout iteration's and one pretraining step's time goes."""
    from dasa_tpu_torch.train.trainer import World, make_agent, make_speaker

    agent = make_agent(cfg, world, rng_seed=seed)
    agent.env = world.envs["val_unseen"]
    agent.env.reset_epoch()
    agent._device_test_batch()  # warm-up: weight casts, library handles
    agent.env.reset_epoch()
    profile_window("eval batch", agent._device_test_batch,
                   lambda: agent.total_env_steps)
    del agent
    agent = make_agent(cfg_train, world, rng_seed=seed)
    agent.env = world.envs["train"]
    agent.train(1, feedback="sample")  # warm-up
    profile_window("training iteration (teacher + sample + optim)",
                   lambda: agent.train(1, feedback="sample"),
                   agent.env_steps_total)
    del agent
    agent = make_agent(cfg_train.replace(rollout_mode="stream"), world,
                       rng_seed=seed)
    agent.env = world.envs["train"]
    agent.train(2, feedback="sample")  # warm-up: the pool fills
    profile_window("stream window (40 slots x 35 steps + optim)",
                   lambda: agent.train(1, feedback="sample"),
                   agent.env_steps_total)
    del agent
    cfg_st = cfg_train.replace(aug="aug", self_train=True)
    world_st = World(cfg_st)
    agent = make_agent(cfg_st, world_st, rng_seed=seed)
    speaker = make_speaker(cfg_st, world_st)

    def selftrain_step():
        # one optimizer step of train()'s aug alternation
        agent.zero_grad()
        agent.env = world_st.envs["train"]
        agent.accumulate_gradient("sample", ml_weight=cfg_st.ml_weight_org)
        agent.env = world_st.envs["aug"]
        agent.accumulate_gradient("sample", ml_weight=cfg_st.ml_weight_aug,
                                  speaker=speaker)
        agent.optim_step()

    selftrain_step()  # warm-up
    profile_window("selfTrain iteration (org pair + relabelled aug pair + "
                   "optim)", selftrain_step, agent.env_steps_total)
    del agent, speaker
    from dasa_tpu_torch.agents import search

    agent = make_agent(cfg, world, rng_seed=seed)
    speaker = make_speaker(cfg, world)
    agent.env = world.envs["val_unseen"]
    expansions = [0]
    step = search._search_step

    def counted(*args):
        expansions[0] += 1
        return step(*args)

    search._search_step = counted
    try:
        search.beam_search(agent, speaker)  # warm-up
        expansions[0] = 0
        profile_window("search batch (Dijkstra, 1 candidate, speaker "
                       "rescoring)",
                       lambda: search.beam_search(agent, speaker),
                       lambda: expansions[0])
    finally:
        search._search_step = step
    print("    (the count above is of expansions, not agent-steps)",
          flush=True)
    del agent, speaker
    agent = make_agent(cfg_train.replace(device_rollout="never"), world,
                       rng_seed=seed)
    agent.env = world.envs["train"]
    agent.train(1, feedback="sample")  # warm-up
    profile_window("host-rollout iteration (teacher + sample act/replay + "
                   "optim)", lambda: agent.train(1, feedback="sample"),
                   agent.env_steps_total)
    del agent
    from dasa_tpu_torch.pretrain import (
        PretrainBatcher,
        generate_pretrain_records,
    )
    from dasa_tpu_torch.pretrain.trainer import Pretrainer

    tok = world.tok
    if "<MASK>" not in tok.word_to_index:
        tok.add_word("<MASK>")
    batch = next(PretrainBatcher(
        generate_pretrain_records(world.envs["train"],
                                  max_steps=cfg.max_action),
        cfg.batch_size, len(tok), tok.word_to_index["<MASK>"],
        seed=seed).epoch())
    pt = Pretrainer(cfg.replace(iters=PRETRAIN_STEPS,
                                warm_steps=PRETRAIN_WARM),
                    world.feature_db, len(tok))
    pt.train_step(batch)  # warm-up
    profile_window("pretrain step (batch 20, forward, backward, AdamW)",
                   lambda: pt.train_step(batch),
                   lambda: pt.step_count * cfg.batch_size)
    print("    (the count above is of samples, not agent-steps)",
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="build,kernels,main,compare,train,train-compare,"
                            "stream,stream-eval,speaker,speaker-compare,"
                            "selftrain,host,search,pretrain,pretrain-chain,"
                            "variants,encoders,ndh,knobs,dp,offline,native,"
                            "scripts")
    ap.add_argument("--seed", type=int, default=0)
    # phase 20 (b)'s rank processes
    ap.add_argument("--dp-worker", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--dp-spec", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "dasa_tpu_torch")):
        fail(f"dasa_tpu_torch not found beside {__file__}")
    sys.path.insert(0, here)
    if args.dp_worker is not None:
        dp_worker(args.dp_worker, args.dp_spec)
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kind = torch.cuda.get_device_name(0)
    wall_start = time.perf_counter()
    clock = {"name": None, "start": wall_start}

    def header(text):
        """Print a phase's header, after the wall time of the one before."""
        now = time.perf_counter()
        if clock["name"]:
            print(f"  ({clock['name']}: {now - clock['start']:.1f} s)",
                  flush=True)
        if text:
            print(text, flush=True)
        clock.update(name=text and text[3:].split(":")[0], start=now)

    print(f"device: {kind} x {torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    rows = []
    if "build" in phases:
        header("== phase 1: build")
        phase_build()
    if "kernels" in phases:
        header("== phase 2: kernels against their plain versions")
        rows = phase_kernels(args.seed)
    launches_eval, launches, launches_stream = {}, {}, {}
    launches_speaker, launches_selftrain = {}, {}
    launches_host, launches_search, launches_chain = {}, {}, {}
    launches_variants, launches_encoders = {}, {}
    launches_ndh, launches_knobs = {}, {}
    launches_dp, launches_dp_ranks = {}, [{}, {}]
    launches_scripts = {}
    if phases & {"main", "compare", "train", "train-compare", "stream",
                 "stream-eval", "profile", "speaker", "speaker-compare",
                 "selftrain", "host", "search", "pretrain",
                 "pretrain-chain", "variants", "encoders", "ndh", "knobs",
                 "dp", "offline", "native", "scripts"}:
        with tempfile.TemporaryDirectory() as root:
            cfg, world = headline_world(root, args.seed, use_pallas="always")
            cfg_train = cfg.replace(**TRAIN)
            if phases & {"main", "compare", "stream-eval"}:
                header("== phase 3: valid() at headline width")
                agent, launches_eval, episodic = phase_main(cfg, world,
                                                            args.seed)
                if "compare" in phases:
                    header("== phase 4: use_pallas always vs never")
                    phase_compare(cfg, world, agent, args.seed)
                # on the host: the later phases' peak memory excludes it
                state = {k: v.to("cpu", copy=True)
                         for k, v in agent.policy.state_dict().items()}
                del agent
            if "train" in phases:
                header("== phase 5: train() at headline width")
                launches = phase_train(cfg_train, world, args.seed, root)
            if "train-compare" in phases:
                header("== phase 6: training pass, use_pallas always vs "
                       "never")
                phase_train_compare(cfg_train, world, args.seed)
            if "stream" in phases:
                header("== phase 7 (stream): train() under the stream regime "
                       "at headline width")
                launches_stream = phase_stream(
                    cfg_train.replace(rollout_mode="stream"), world,
                    args.seed, root)
            if "stream-eval" in phases:
                header("== phase 8 (stream-eval): valid() under the stream "
                       "regime, phase 3's weights")
                phase_stream_eval(cfg, world, state, episodic, args.seed)
            if phases & {"speaker", "speaker-compare"}:
                header("== phase 9 (speaker): train_speaker() and "
                       "valid_speaker() at the speaker's widths, batch 64")
                launches_speaker, spk_cfg, spk_world, spk_state = \
                    phase_speaker(args.seed, root)
            if "speaker-compare" in phases:
                header("== phase 10 (speaker-compare): the speaker under "
                       "use_pallas always vs never")
                phase_speaker_compare(spk_cfg, spk_world, spk_state)
            if "selftrain" in phases:
                header("== phase 11 (selftrain): auglistener --selfTrain at "
                       "headline width")
                launches_selftrain = phase_selftrain(cfg_train, args.seed,
                                                     root)
            if "host" in phases:
                header("== phase 12 (host): the host act/replay rollout at "
                       "headline width: valid() with submit, train() under "
                       "device_rollout=never, selfTrain under stream")
                launches_host = phase_host(cfg, cfg_train, world, args.seed,
                                           root)
            if "search" in phases:
                header("== phase 13 (search): beam_valid() at headline width "
                       "with speaker rescoring")
                launches_search = phase_search(cfg, world, args.seed, root)
            if phases & {"pretrain", "pretrain-chain"}:
                header("== phase 14 (pretrain): run_pretrain at the headline "
                       "BERT width")
                pt, snap = phase_pretrain(cfg, world, args.seed, root)
            if "pretrain-chain" in phases:
                header("== phase 15 (pretrain-chain): the headline listener "
                       "from the pretraining snapshot and from an HF .bin")
                launches_chain = phase_pretrain_chain(
                    cfg_train, world, args.seed, root, pt, snap)
            if "variants" in phases:
                header("== phase 16 (variants): the DASA variants on the Dic "
                       "listener at headline width, train() and valid()")
                launches_variants = phase_variants(cfg_train, args.seed,
                                                   root)
            if "encoders" in phases:
                header("== phase 17 (encoders): the plain, legacy and mcatt "
                       "encoders at their widths, train() and valid()")
                launches_encoders = phase_encoders(cfg_train, args.seed,
                                                   root)
            if "ndh" in phases:
                header("== phase 18 (ndh): NDH dialogs of 300 tokens at "
                       "headline width, train(), validndh and a stream "
                       "window")
                launches_ndh = phase_ndh(args.seed, root)
            if "knobs" in phases:
                header("== phase 19 (knobs): fuse_passes=auto and the remat "
                       "modes")
                launches_knobs = phase_knobs(cfg_train, world, args.seed,
                                             root)
            if "dp" in phases:
                header("== phase 20 (dp): data parallel, a one-rank NCCL job "
                       "and two gloo ranks on the card")
                launches_dp, launches_dp_ranks = phase_dp(
                    cfg_train, world, args.seed, root)
            if phases & {"offline", "native"}:
                header("== phase 21 (offline): render, ResNet-152 "
                       "featurization on the card, the npy pair as depth_db")
                off_agent, off_world = phase_offline(cfg, args.seed, root)
            if "native" in phases:
                header("== phase 22 (native): the native sim engine against "
                       "the python one")
                phase_native(off_world, off_agent)
                del off_agent
            if "scripts" in phases:
                header("== phase 23 (scripts): make_task, make_aug_paths, "
                       "check_real_data and stream_quality_ab on the port")
                launches_scripts = phase_scripts(args.seed, root)
            if "profile" in phases:
                header("== profile: one eval batch, one training iteration, "
                       "one stream window, one selfTrain iteration, one "
                       "search batch, one host-rollout iteration")
                phase_profile(cfg, cfg_train, world, args.seed)
    header(None)
    print(f"wall time: {time.perf_counter() - wall_start:.2f} s", flush=True)
    if rows:
        print("== phase 2 rows with the launches of phases 3, 5, 7, 9, 11, "
              "12, 13, 15, 16, 17, 18, 19, 20 and 23", flush=True)
    for r in rows:
        base = r["name"].split("[")[0]
        per_token = ("" if "us_per_token" not in r
                     else f", {r['us_per_token']:.3f} us a token")
        print(f"  {r['name']}: {r['ms']:.4f} ms one call, {r['device_ms']:.4f}"
              f" ms device, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"launches {launches.get(base, 0)} in train(), "
              f"{launches_eval.get(base, 0)} in valid(), "
              f"{launches_stream.get(base, 0)} in train() under stream, "
              f"{launches_speaker.get(base, 0)} in the speaker phase, "
              f"{launches_selftrain.get(base, 0)} in selfTrain train(), "
              f"{launches_host.get(base, 0)} in the host phase, "
              f"{launches_search.get(base, 0)} in the searches, "
              f"{launches_chain.get(base, 0)} in the pretrained chain, "
              f"{launches_variants.get(base, 0)} in the variants, "
              f"{launches_encoders.get(base, 0)} in the encoders, "
              f"{launches_ndh.get(base, 0)} in NDH, "
              f"{launches_knobs.get(base, 0)} in the knobs, "
              f"{launches_dp.get(base, 0)} in the one-rank NCCL job, "
              f"{[r.get(base, 0) for r in launches_dp_ranks]} on the two "
              f"gloo ranks and {launches_scripts.get(base, 0)} in the "
              f"scripts{per_token}",
              flush=True)
    out = []
    for r in rows:
        if not r.get("json", True):
            continue
        base = r["name"].split("[")[0]
        src, replaces = KERNEL_INFO[base]
        out.append({"name": r["name"], "route": "cuda", "source": src,
                    "replaces": replaces,
                    "launches": launches.get(base, 0),
                    "launches_eval": launches_eval.get(base, 0),
                    "launches_stream": launches_stream.get(base, 0),
                    "launches_speaker": launches_speaker.get(base, 0),
                    "launches_selftrain": launches_selftrain.get(base, 0),
                    "launches_host": launches_host.get(base, 0),
                    "launches_search": launches_search.get(base, 0),
                    "launches_pretrain_chain": launches_chain.get(base, 0),
                    "launches_variants": launches_variants.get(base, 0),
                    "launches_encoders": launches_encoders.get(base, 0),
                    "launches_ndh": launches_ndh.get(base, 0),
                    "launches_knobs": launches_knobs.get(base, 0),
                    "launches_dp": launches_dp.get(base, 0),
                    "launches_dp_ranks": [r.get(base, 0)
                                          for r in launches_dp_ranks],
                    "launches_scripts": launches_scripts.get(base, 0),
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                    "ratio": r["ratio"], "device_ms": r["device_ms"],
                    "library_device_ms": r["library_device_ms"],
                    "pass": True})  # a failed check exits before this
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
