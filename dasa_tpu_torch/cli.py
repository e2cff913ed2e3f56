"""Command line of the PyTorch port, the counterpart of ``train.py``:

    python -m dasa_tpu_torch.cli --train listener ...       # IL + A2C
    python -m dasa_tpu_torch.cli --train auglistener --aug <json> ...
    python -m dasa_tpu_torch.cli --train auglistener --aug <json>
        --selfTrain --speaker <ckpt> ...   # speaker back-translation
    python -m dasa_tpu_torch.cli --train validlistener [--load <ckpt>]
    python -m dasa_tpu_torch.cli --train speaker ...
    python -m dasa_tpu_torch.cli --train validspeaker [--load <ckpt>]

The flags are ``train.py``'s (the reference's spellings and snake_case),
parsed by the port's copy of the config.  ``--device`` picks the device
(CUDA by default; ``--device cpu`` for a small run without a card).  The
other ``--train`` modes and ``--beam`` come with later slices
(ROADMAP.md).
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
    elif cfg.train == "validlistener" and not cfg.beam:
        trainer.valid(cfg, device=known.device)
    elif cfg.train == "speaker":
        trainer.train_speaker(cfg, device=known.device)
    elif cfg.train == "validspeaker":
        trainer.valid_speaker(cfg, device=known.device)
    else:
        raise NotImplementedError(
            f"--train {cfg.train}{' --beam' if cfg.beam else ''} is not "
            "ported yet (ROADMAP.md)")


if __name__ == "__main__":
    main()
