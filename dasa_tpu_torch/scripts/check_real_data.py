"""One-command real-data readiness check.

Once real R2R assets are mounted, this runs the whole pipeline (asset
validation, feature load, an optional pretrained-BERT graft and listener
checkpoint, validlistener, SR/SPL) in one command:

    python -m dasa_tpu_torch.scripts.check_real_data \
        --data_dir /data/r2r \
        --img_features /data/ResNet-152-imagenet.tsv \
        [--depth_features /data/ResNet-152-imagenet-depth.npy] \
        [--checkpoint /snap/DASA/state_dict/best_val_unseen] \
        [--pretrain_bert /data/checkpoint-12864/pytorch_model.bin] \
        [--flags "--adaIn_type channel --use_shift ..."] [--device cpu]

Replaces the manual steps of docs/DATA.md sections 1-4 (the reference's
inference flow: r2r_src/train.py:396-421 validlistener).  Prints one line
of metrics per split, the seconds each took, and a closing ``READY:`` line;
a missing asset prints ``FAILED: ...`` and exits 1.  ``--checkpoint``
takes the port's listener files, the JAX package's and the reference's
per-component torch dicts (``Seq2SeqAgent.load``); ``--pretrain_bert``
any pretraining checkpoint that ``utils/pretrain_load.py`` reads.  The
listener runs on CUDA unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

# the reference checkout's committed vocabulary, enough for an
# evaluation-only check (under $DASA_REFERENCE_DIR, default ./reference)
COMMITTED_VOCAB = os.path.join("tasks", "R2R", "data", "train_vocab.txt")


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def main(argv=None) -> dict:
    """Returns {split: {"summary", "results", "seconds"}}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", required=True,
                    help="directory with R2R_{split}.json")
    ap.add_argument("--img_features", required=True,
                    help="ResNet-152-imagenet.tsv or .npz feature store")
    ap.add_argument("--depth_features", default=None,
                    help=".npy depth values (with <name>-index.npy next "
                         "to it) or .npz store")
    ap.add_argument("--checkpoint", default=None,
                    help="listener checkpoint: the port's, the JAX "
                         "package's or the reference's per-component "
                         "torch dict")
    ap.add_argument("--pretrain_bert", default=None,
                    help="pretraining checkpoint to graft into the "
                         "encoder (e.g. the reference's pytorch_model.bin)")
    ap.add_argument("--splits", default="val_seen,val_unseen")
    ap.add_argument("--vocab", default=None,
                    help="prebuilt vocab file; falls back to the "
                         "reference's committed train_vocab.txt when "
                         "R2R_train.json is absent (eval-only check)")
    ap.add_argument("--flags", default="",
                    help="extra train.py-style flags for the model "
                         "config (reference spellings accepted)")
    ap.add_argument("--device", default=None,
                    help="the listener's device (default: cuda)")
    args = ap.parse_args(argv)
    splits = args.splits.split(",")

    # ---- 1. validate assets ------------------------------------------
    for split in splits:
        p = os.path.join(args.data_dir, f"R2R_{split}.json")
        if not os.path.exists(p):
            fail(f"missing split file {p}")
    if not os.path.exists(args.img_features):
        fail(f"missing image features {args.img_features}")
    have_train = os.path.exists(
        os.path.join(args.data_dir, "R2R_train.json"))
    vocab = args.vocab
    if vocab is None and not have_train:
        committed = os.path.join(
            os.environ.get("DASA_REFERENCE_DIR", "reference"),
            COMMITTED_VOCAB)
        if os.path.exists(committed):
            vocab = committed
            print(f"no R2R_train.json: using committed vocab {vocab}",
                  flush=True)
        else:
            fail("R2R_train.json absent and no --vocab given")
    if vocab is not None and not os.path.exists(vocab):
        fail(f"missing vocab file {vocab}")
    print("assets: ok", flush=True)

    # ---- 2. config (the headline dims and the user's flags) -----------
    from dasa_tpu_torch.config import parse_args as parse_cfg

    flag_list = args.flags.split() if args.flags else []
    cfg = parse_cfg([
        "--train", "validlistener",
        "--data_dir", args.data_dir,
        "--img_features_path", args.img_features,
        *(["--depth_features_path", args.depth_features]
          if args.depth_features else []),
        *(["--vocab_path", vocab] if vocab else []),
        "--name", "readiness_check",
        *flag_list,
    ])

    # ---- 3. world and agent, checkpoints -----------------------------
    from dasa_tpu_torch.train import trainer
    from dasa_tpu_torch.utils.pretrain_load import load_pretrained_encoder

    world = trainer.World(cfg, splits=("train",) if have_train else (),
                          val_splits=tuple(splits))
    agent = trainer.make_agent(
        cfg, world, env_name="train" if have_train else splits[0],
        device=args.device)
    if args.pretrain_bert:
        state, _missed = load_pretrained_encoder(agent.policy.state_dict(),
                                                 args.pretrain_bert)
        agent.policy.load_state_dict(state)
        print(f"grafted pretrained BERT from {args.pretrain_bert}",
              flush=True)
    if args.checkpoint:
        it = agent.load(args.checkpoint)
        print(f"loaded checkpoint {args.checkpoint} (iter {it})",
              flush=True)

    # ---- 4. validlistener and its scores -----------------------------
    report = {}
    for env_name, env in world.envs.items():
        if env_name not in splits:
            continue
        agent.env = env
        start = time.perf_counter()
        out = agent.test(feedback="argmax")  # ends on the host
        seconds = time.perf_counter() - start
        summary, _ = world.evaluators[env_name].score(out)
        report[env_name] = {"summary": summary, "results": out,
                            "seconds": seconds}
        print("%s: %s" % (env_name, ", ".join(
            "%s %.4f" % (m, v) for m, v in sorted(summary.items()))),
            flush=True)
    if not report:
        fail("no splits evaluated")
    print("seconds: " + ", ".join(f"{k} {v['seconds']:.3f}"
                                  for k, v in report.items()), flush=True)
    srs = ", ".join(f"{k} SR {v['summary'].get('success_rate', 0):.3f}"
                    for k, v in report.items())
    print(f"READY: real-data pipeline ran end-to-end ({srs})", flush=True)
    return report


if __name__ == "__main__":
    main()
