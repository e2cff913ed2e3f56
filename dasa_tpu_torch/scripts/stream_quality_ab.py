"""Stream against episodic training: the quality A/B at matched agent-step
counts.

The streamed (continuous-batching) regime changes the optimizer-step
granularity, the teacher : sample episode ratio and the noise stream of
episodic training (``agents/stream.py``).  This script answers the
question those differences raise: does a stream-trained policy reach the
same SR/SPL **per agent-step** as episodic training?  (The reference's
training semantics: agent_dg.py:1347-1384, train.py:226-243.)

Method: the headline DASA configuration (``bench.py``'s dims: BERT 9+3,
BiLSTM 1024 a direction, decoder 1024, batch 20, 35 steps, bf16) trains
on a task (``make_task``) in each regime from the same seed, and each run
validates val_seen and val_unseen (argmax, ``Evaluation.score``) each time
its cumulative agent-step counter crosses a shared milestone.  The results
print as a markdown table and are written as JSON:

    python -m dasa_tpu_torch.scripts.stream_quality_ab   # CUDA, full
    python -m dasa_tpu_torch.scripts.stream_quality_ab --fast   # CPU smoke
    python -m dasa_tpu_torch.scripts.stream_quality_ab --total_steps 400000

``--fast`` is tiny, f32, Adam and on the CPU; otherwise the run is on CUDA
unless ``--device`` names another device.  ``--use_pallas`` routes the
kernels as the config's field does (default ``auto``, the JAX script's);
``--save_dir`` keeps each run's trained listener (a start for a trained
policy elsewhere).  The connectivity graphs are
the config's default (``$DASA_CONNECTIVITY_DIR`` or ``./connectivity``).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def full_cfg(args):
    from dasa_tpu_torch.config import Config

    cfg = Config(
        encoder_type="Dic", include_vision=True, adain_type="channel",
        ab_type="a", a_type="sigmoid", use_shift=True,
        shift_kernel_size=5, depth_drop=True, consistent_drop=True,
        env_drop_stage="after_adain", angle_feat_size=128,
        feature_size=2048, d_enc_hidden_size=1024, d_hidden_size=1024,
        critic_dim=1024, d_vl_layers=3, d_la_layers=9, max_input=80,
        max_action=35, batch_size=args.batch_size, featdropout=0.4,
        optim="rms",
        # --lr / --warm_steps / --decay_* override the reference schedule
        # for the large-update arms: the schedule counts optimizer
        # iterations, so at the stream's coarser granularity an unscaled
        # run spends the A/B inside warmup.  Scale warmup / decay by 1/k
        # to re-align them in agent-steps, and lr by sqrt(k) (RMSprop's
        # per-parameter normalisation keeps the update's size about
        # invariant to the gradient's scale).
        lr=args.lr or 1e-4, use_lr_scheduler=True, ml_weight=0.2,
        warm_steps=args.warm_steps or 1000,
        decay_start=args.decay_start or 4000,
        decay_intervals=args.decay_intervals or 2000,
        # fuse_passes="auto" runs the split pair and prng_impl names a JAX
        # generator: both are the JAX script's, inert here
        compute_dtype="bfloat16", fuse_passes="auto", prng_impl="rbg",
        data_dir=args.data_dir, seed=1, name="stream_ab",
    )
    if args.fast:
        cfg = cfg.replace(
            d_la_layers=1, d_vl_layers=1, batch_size=4, max_action=6,
            feature_size=32, angle_feat_size=8, d_enc_hidden_size=16,
            d_hidden_size=32, critic_dim=32, max_input=20,
            compute_dtype="float32", lr=1e-3, optim="adam",
            prng_impl="threefry")
    return cfg


def run_regime(cfg, regime, milestones, log, device=None, save=None):
    """Train one regime, validating at each agent-step milestone.

    ``regime`` is "episodic", "stream" (the automatic geometry) or
    "stream:S" (windows of S scan steps: stream:8 gives about W * 8 /
    episode length agent-steps an optimizer update, the episodic pair's
    granularity, so that the A/B isolates the continuous batching from
    the update frequency).  ``save`` names a file for the trained
    listener's checkpoint."""
    from dasa_tpu_torch.train.trainer import World, make_agent

    if ":" in regime:
        mode, steps = regime.split(":")
        cfg = cfg.replace(rollout_mode=mode, stream_steps=int(steps))
    else:
        cfg = cfg.replace(rollout_mode=regime)
    world = World(cfg)
    agent = make_agent(cfg, world, device=device)
    train_env = world.envs["train"]
    assert agent.use_device_rollout()
    if regime == "stream":
        assert agent.use_stream_rollout()
    # the JAX script compiles its programs here; eager torch has none
    log(f"[{regime}] compile skipped (eager)")

    def validate(steps):
        row = {"agent_steps": int(steps),
               "iters": int(agent.iter_count)}
        for env_name in ("val_seen", "val_unseen"):
            agent.env = world.envs[env_name]
            results = agent.test(feedback="argmax")
            summary, _ = world.evaluators[env_name].score(results)
            row[env_name] = {k: round(float(v), 4)
                             for k, v in summary.items()}
        agent.env = train_env
        log(f"[{regime}] steps={steps} it={agent.iter_count} "
            + " ".join(f"{e} SR={row[e]['success_rate']:.3f} "
                       f"SPL={row[e]['spl']:.3f}"
                       for e in ("val_seen", "val_unseen")))
        return row

    rows = [validate(0)]
    t0 = time.time()
    next_ms = 0
    while next_ms < len(milestones):
        agent.zero_grad()
        agent.accumulate_gradient("sample")
        agent.optim_step()
        steps = agent.env_steps_total()
        if steps >= milestones[next_ms]:
            rows.append(validate(steps))
            next_ms += 1
    train_s = time.time() - t0
    if save:
        agent.save(agent.iter_count, save)
    log(f"[{regime}] trained {rows[-1]['agent_steps']} agent-steps / "
        f"{agent.iter_count} iters in {train_s:.0f}s (incl. "
        f"validations)")
    return {"regime": regime, "rows": rows, "train_seconds": train_s}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", default="data/task")
    ap.add_argument("--total_steps", type=int, default=600_000)
    ap.add_argument("--n_milestones", type=int, default=6)
    ap.add_argument("--fast", action="store_true",
                    help="tiny dims + CPU (plumbing smoke)")
    ap.add_argument("--regimes", default="episodic,stream")
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--batch_size", type=int, default=20,
                    help="the stream window is 2 * batch slots wide")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "stream_ab.json"))
    ap.add_argument("--lr", type=float, default=None,
                    help="override lr (sqrt(update-size ratio) rule "
                         "for the large-update arms)")
    ap.add_argument("--warm_steps", type=int, default=None)
    ap.add_argument("--decay_start", type=int, default=None)
    ap.add_argument("--decay_intervals", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="default: cuda, or cpu under --fast")
    ap.add_argument("--save_dir", default=None,
                    help="write each run's trained listener to "
                         "<dir>/<regime>_seed<seed>")
    ap.add_argument("--use_pallas", default="auto",
                    choices=("auto", "always", "never"),
                    help="the kernels' routing (auto: the LSTMs; always: "
                         "the AdaIN gate and shift attention too)")
    args = ap.parse_args(argv)
    device = args.device
    if args.fast:
        device = device or "cpu"
        if args.total_steps > 2000:
            args.total_steps = 2000
            args.n_milestones = 2

    if not os.path.isdir(args.data_dir):
        raise SystemExit(f"{args.data_dir} missing — run python -m "
                         "dasa_tpu_torch.scripts.make_task --out "
                         f"{args.data_dir}")

    milestones = [args.total_steps * (i + 1) // args.n_milestones
                  for i in range(args.n_milestones)]

    def log(msg):
        print(msg, flush=True)

    out = {"milestones": milestones, "runs": []}
    for seed in [int(s) for s in args.seeds.split(",")]:
        for regime in args.regimes.split(","):
            cfg = full_cfg(args).replace(seed=seed,
                                         use_pallas=args.use_pallas)
            save = args.save_dir and os.path.join(
                args.save_dir, f"{regime.replace(':', '_')}_seed{seed}")
            run = run_regime(cfg, regime, milestones, log, device, save)
            run["seed"] = seed
            run["schedule"] = {"lr": cfg.lr,
                               "warm_steps": cfg.warm_steps,
                               "decay_start": cfg.decay_start,
                               "decay_intervals": cfg.decay_intervals,
                               "batch_size": cfg.batch_size}
            out["runs"].append(run)
            with open(args.out, "w") as f:
                json.dump(out, f, indent=2)

    # a markdown table, one row per (regime, seed)
    print("\n| regime | seed | " + " | ".join(
        f"{m // 1000}k seen/unseen SR" for m in [0] + milestones)
        + " | mean last-2 seen | mean last-2 unseen |")
    print("|" + "---|" * (4 + len(milestones)))
    for r in out["runs"]:
        cells = [f"{row['val_seen']['success_rate']:.3f}/"
                 f"{row['val_unseen']['success_rate']:.3f}"
                 for row in r["rows"]]
        last2 = r["rows"][-2:]
        m_seen = sum(x["val_seen"]["success_rate"]
                     for x in last2) / len(last2)
        m_unseen = sum(x["val_unseen"]["success_rate"]
                       for x in last2) / len(last2)
        print(f"| {r['regime']} | {r['seed']} | " + " | ".join(cells)
              + f" | {m_seen:.3f} | {m_unseen:.3f} |")
    print(f"\nwrote {args.out}")
    return out


if __name__ == "__main__":
    main()
