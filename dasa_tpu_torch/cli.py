"""Command line of the PyTorch port, the counterpart of ``train.py``:

    python -m dasa_tpu_torch.cli --train listener ...       # IL + A2C
    python -m dasa_tpu_torch.cli --train auglistener --aug <json> ...
    python -m dasa_tpu_torch.cli --train auglistener --aug <json>
        --selfTrain --speaker <ckpt> ...   # speaker back-translation
    python -m dasa_tpu_torch.cli --train validlistener [--load <ckpt>]
        [--submit]                         # submit_{split}.json files
    python -m dasa_tpu_torch.cli --train validlistener --beam
        [--speaker <ckpt>] [--candidates K] [--param_search]
    python -m dasa_tpu_torch.cli --train beamvalid ...  # the same search
    python -m dasa_tpu_torch.cli --train simpleagents   # Stop / Random /
                                                        # Shortest
    python -m dasa_tpu_torch.cli --train speaker ...
    python -m dasa_tpu_torch.cli --train validspeaker [--load <ckpt>]
    python -m dasa_tpu_torch.cli --train pretrain ...   # MLM + next action
    python -m dasa_tpu_torch.cli --train listener
        --pretrain_model_name <dir or checkpoint> ...   # pretrained encoder
    python -m dasa_tpu_torch.cli --train ndh --history all ...  # NDH
    python -m dasa_tpu_torch.cli --train validndh [--load <ckpt>]

The flags are ``train.py``'s (the reference's spellings and snake_case),
parsed by the port's copy of the config.  ``--device`` picks the device
(CUDA by default; ``--device cpu`` for a small run without a card).
``--search_type state_factored`` picks the speaker-follower search for
``--beam`` / ``beamvalid``.  ``--pretrain_model_name`` takes an HF
directory or ``pytorch_model.bin`` (the DicAdd / DicPM and Vic families)
or a Pretrainer ``checkpoint-N`` of the port or of the JAX package
(``utils/pretrain_load.py``).  ``--train ndh`` / ``ndhlistener`` train and
``--train validndh`` validates the listener on CVDN dialogs
(``NDH_{split}.json`` in ``--data_dir``; ``--path_type`` and ``--history``
pick the supervision path and the dialog context, and set
``max_action`` / ``max_input`` unless they are given).
"""

from __future__ import annotations

import argparse
import sys

from dasa_tpu_torch.config import parse_args
from dasa_tpu_torch.train import trainer


def main(argv=None) -> None:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default=None)
    known, rest = pre.parse_known_args(sys.argv[1:] if argv is None
                                       else argv)
    cfg = parse_args(rest)
    print(cfg.to_json())
    if cfg.train in ("listener", "auglistener"):
        trainer.train(cfg, device=known.device)
    elif cfg.train == "validlistener" and cfg.beam:
        # Dijkstra-search validation (train.py:530-579)
        trainer.beam_valid(cfg, device=known.device)
    elif cfg.train == "validlistener":
        trainer.valid(cfg, device=known.device)
    elif cfg.train == "beamvalid":
        trainer.beam_valid(cfg, device=known.device)
    elif cfg.train == "simpleagents":
        from dasa_tpu_torch.agents.simple import eval_simple_agents

        world = trainer.World(cfg)
        for env_name in ("val_seen", "val_unseen"):
            out = eval_simple_agents(world.envs[env_name],
                                     world.evaluators[env_name],
                                     episode_len=cfg.max_action)
            for agent_name, summary in out.items():
                print("%s %s: %s" % (env_name, agent_name, ", ".join(
                    "%s: %.4f" % (m, v) for m, v in summary.items())),
                    flush=True)
    elif cfg.train == "speaker":
        trainer.train_speaker(cfg, device=known.device)
    elif cfg.train == "validspeaker":
        trainer.valid_speaker(cfg, device=known.device)
    elif cfg.train == "pretrain":
        from dasa_tpu_torch.pretrain.trainer import run_pretrain

        run_pretrain(cfg, device=known.device)
    elif cfg.train in ("ndh", "ndhlistener"):
        world = trainer.World(cfg, ndh=True)
        trainer.train(cfg, world=world, device=known.device)
    elif cfg.train == "validndh":
        world = trainer.World(cfg, ndh=True)
        trainer.valid(cfg, world=world, device=known.device)
    else:
        raise NotImplementedError(
            f"--train {cfg.train} is not ported yet (ROADMAP.md)")


if __name__ == "__main__":
    main()
