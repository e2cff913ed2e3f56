"""Generate speaker-annotated augmentation paths (an ``R2R_aug``-style
file).

The reference consumes a downloaded aug_paths.json (EnvDrop's released
speaker data, r2r_src/train.py:631) but cannot produce one: the
speaker-follower subpackage that built it (tasks/R2R/speaker/) is wired to
no driver.  This script closes the loop with the port's speaker, which
makes ``auglistener`` self-contained:

1. sample shortest paths in the train scans that the train split does not
   already cover (a hop range like the aug data's 4-6),
2. annotate each with a trained ``SpeakerAgent`` (greedy, or
   ``--sampling``),
3. write the items in the R2R schema that ``--aug`` reads.

    python -m dasa_tpu_torch.scripts.make_aug_paths --data_dir data/task \
        --out data/task/R2R_aug_gen.json \
        --load snap/speaker/state_dict/best_val_seen_bleu \
        --n_per_scan 30 --min_hops 4 --max_hops 6

The config's flags (feature sizes, ``--connectivity_dir``, ...) are taken
beside the script's.  ``--load`` reads the port's speaker files and the JAX
package's.  Without it the speaker keeps its random initial weights:
mechanically valid output, gibberish text (the smoke mode; a warning is
printed).  The speaker runs on CUDA unless ``--device`` names another
device.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import random
import sys
import time


def sample_new_paths(scans, existing, connectivity_dir, n_per_scan,
                     min_hops, max_hops, seed):
    """R2R items over shortest paths NOT in ``existing`` (a set of (scan,
    path tuple)); the instructions are left for the speaker.  The sampler
    mirrors ``data/datasets.py:generate_synthetic_dataset``."""
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path as sp_unweighted

    from dasa_tpu_torch.sim.graph import load_scan_graph

    rng = random.Random(seed)
    items, path_id = [], 10_000_000  # clear of real R2R path ids
    seen = set(existing)
    for scan in sorted(scans):
        g = load_scan_graph(scan, connectivity_dir)
        g.compute_shortest_paths()
        inc = np.nonzero(g.included)[0]
        adj = g.nav_adjacency()
        hop_d = sp_unweighted(csr_matrix(adj.astype(np.float64)),
                              method="D", unweighted=True,
                              directed=False)
        got = 0
        for _try in range(50 * n_per_scan):
            if got >= n_per_scan:
                break
            src = int(rng.choice(list(inc)))
            nh = hop_d[src]
            ok = np.nonzero((nh >= min_hops) & (nh <= max_hops)
                            & g.included)[0]
            if len(ok) == 0:
                continue
            dst = int(rng.choice(list(ok)))
            path = tuple(g.ids[i] for i in g.shortest_path(src, dst))
            if (scan, path) in seen:
                continue
            seen.add((scan, path))
            items.append({
                "scan": scan,
                "path_id": path_id,
                "path": list(path),
                "heading": rng.uniform(0, 2 * math.pi),
                "distance": float(g.dist[src, dst]),
                # a non-empty placeholder (an empty one encodes to None
                # and the expander drops the item); the speaker's words
                # replace it
                "instructions": ["placeholder"],
            })
            path_id += 1
            got += 1
    return items


def caption_paths(speaker, env, tok, sampling: bool = False):
    """Caption every item of ``env`` in its order: ``env.size() // batch
    + 1`` batches, whose last one wraps around to the first items; the
    first caption of a ``path_id`` is kept.  Returns (path_id -> word
    ids, seconds a batch)."""
    path2inst, seconds = {}, []
    env.reset_epoch(shuffle=False)
    for _ in range(env.size() // env.batch_size + 1):
        env.reset()
        start = time.perf_counter()
        words = speaker.infer_batch(sampling=sampling)  # ends on the host
        seconds.append(time.perf_counter() - start)
        for item, inst in zip(env.batch, words):
            path2inst.setdefault(item["path_id"], tok.shrink(list(inst)))
    return path2inst, seconds


def main(argv=None):
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--out", required=True)
    ap.add_argument("--n_per_scan", type=int, default=30)
    ap.add_argument("--min_hops", type=int, default=4)
    ap.add_argument("--max_hops", type=int, default=6)
    ap.add_argument("--sampling", action="store_true",
                    help="sample words instead of greedy decode")
    ap.add_argument("--seed_paths", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the speaker's device (default: cuda)")
    args, rest = ap.parse_known_args(argv)

    from dasa_tpu_torch.agents.speaker import SpeakerAgent
    from dasa_tpu_torch.config import parse_args
    from dasa_tpu_torch.data.datasets import expand_instructions
    from dasa_tpu_torch.train.trainer import World

    cfg = parse_args(rest)
    world = World(cfg, splits=("train",), val_splits=())
    train_env = world.envs["train"]
    existing = {(it["scan"], tuple(it["path"])) for it in train_env.data}
    scans = {it["scan"] for it in train_env.data}

    raw = sample_new_paths(scans, existing, cfg.connectivity_dir,
                           args.n_per_scan, args.min_hops, args.max_hops,
                           args.seed_paths)
    print(f"sampled {len(raw)} new paths over {len(scans)} scans",
          flush=True)
    items = expand_instructions(raw, world.tok, cfg.max_input)
    env = world._make_env(items, "auggen")

    speaker = SpeakerAgent(cfg, env, world.feature_db,
                           vocab_size=len(world.tok), tok=world.tok,
                           device=args.device)
    if cfg.load:
        speaker.load(cfg.load)
    else:
        print("WARNING: no --load — annotating with a randomly "
              "initialized speaker (smoke mode)", file=sys.stderr)

    path2inst, seconds = caption_paths(speaker, env, world.tok,
                                       args.sampling)
    print(f"decoded {len(seconds)} batches of {env.batch_size} on "
          f"{speaker.device}: {', '.join(f'{s:.4f}' for s in seconds)} s",
          flush=True)
    for it in raw:
        sent = world.tok.decode_sentence(path2inst[it["path_id"]])
        # an immediate-EOS decode (an untrained speaker) would be dropped
        # by the aug loader's tokenizer: keep the item loadable
        it["instructions"] = [sent or "placeholder"]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(raw, f)
    print(f"wrote {len(raw)} speaker-annotated items -> {args.out}",
          flush=True)
    return raw


if __name__ == "__main__":
    main()
