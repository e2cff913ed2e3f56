"""Training metrics: TensorBoard when available, JSONL always.

A copy of ``dasa_tpu/train/metrics.py``, which replaces the reference's
SummaryWriter + pandas CSV logging (r2r_src/train.py:95, 256-302,
374-383)."""

from __future__ import annotations

import json
import os
import time


class MetricsWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl_path = os.path.join(log_dir, "metrics.jsonl")
        self._jsonl = open(self.jsonl_path, "a")
        self.tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(log_dir=log_dir)
            except Exception:
                self.tb = None

    def add_scalar(self, tag: str, value: float, step: int):
        value = float(value)  # device scalars (lazy agent logs) -> host
        self._jsonl.write(json.dumps(
            {"t": time.time(), "tag": tag, "value": value,
             "step": int(step)}) + "\n")
        if self.tb is not None:
            self.tb.add_scalar(tag, value, step)

    def write_csv_row(self, row: dict, name: str = "plot_log.csv"):
        """Append one validation row to the reference's plot CSV
        (train.py:374-383 writes plot_log.csv with a 20-attempt retry;
        here a plain append)."""
        import csv

        path = os.path.join(os.path.dirname(self.jsonl_path), name)
        exists = os.path.exists(path)
        with open(path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(row))
            if not exists:
                w.writeheader()
            w.writerow(row)

    def flush(self):
        self._jsonl.flush()
        if self.tb is not None:
            self.tb.flush()

    def close(self):
        self._jsonl.close()
        if self.tb is not None:
            self.tb.close()
