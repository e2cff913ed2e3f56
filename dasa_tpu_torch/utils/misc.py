"""Small shared helpers (reference: r2r_src/utils.py misc sections)."""

from __future__ import annotations

import random
import time
from collections import defaultdict
from typing import Dict, Optional, Sequence

import numpy as np


def length2mask(lengths: Sequence[int], size: Optional[int] = None) -> np.ndarray:
    """Boolean mask, True at padded positions (utils.py:503-508)."""
    lengths = np.asarray(lengths)
    size = int(lengths.max()) if size is None else size
    return np.arange(size)[None, :] >= lengths[:, None]


def set_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)


class Timer:
    """tic/toc aggregate profiler (utils.py:427-456)."""

    def __init__(self):
        self.culmu: Dict[str, float] = defaultdict(float)
        self.start_times: Dict[str, float] = {}
        self.iteration = 0
        self.start_time = time.time()

    def reset(self):
        self.culmu.clear()
        self.start_times.clear()
        self.iteration = 0
        self.start_time = time.time()

    def tic(self, key: str):
        self.start_times[key] = time.time()

    def toc(self, key: str):
        self.culmu[key] += time.time() - self.start_times[key]

    def step(self):
        self.iteration += 1

    def show(self):
        total = time.time() - self.start_time
        for key, spent in sorted(self.culmu.items(), key=lambda kv: -kv[1]):
            print(
                "%s: %.2fs (%.1f%%, 1/it: %.4fs)"
                % (key, spent, spent * 100.0 / total, spent / max(1, self.iteration))
            )
        print("Total: %.2fs over %d iterations" % (total, self.iteration))


class GracefulKiller:
    """SIGINT/SIGTERM latch (utils.py:416-423); ``restore`` puts the
    previous handlers back."""

    def __init__(self):
        import signal

        self.kill_now = False
        self._previous = {sig: signal.signal(sig, self._exit)
                          for sig in (signal.SIGINT, signal.SIGTERM)}

    def _exit(self, signum, frame):
        self.kill_now = True

    def restore(self):
        import signal

        for sig, handler in self._previous.items():
            signal.signal(sig, handler)
