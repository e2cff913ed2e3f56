"""Training-curve plots from a run's logs.

The legacy task layer's plot tooling (reference tasks/R2R/plot.py:20-129
renders loss / navigation error / success-rate curves from the
plot_log.csv written during training into plots/training.png and
error.png).  This renders the same three panels from either the
``plot_log.csv`` or the ``metrics.jsonl`` that ``train/metrics.py`` writes:

    python -m dasa_tpu_torch.scripts.plot_curves --run snap/<name> \
        [--out plots/]

Needs matplotlib, imported when :func:`main` runs.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
from collections import defaultdict


def load_series(run_dir: str) -> dict:
    """-> {tag: (steps, values)} from plot_log.csv or metrics.jsonl."""
    series = defaultdict(lambda: ([], []))
    csv_path = os.path.join(run_dir, "plot_log.csv")
    jsonl_path = os.path.join(run_dir, "metrics.jsonl")
    if os.path.exists(csv_path):
        with open(csv_path) as f:
            for row in csv.DictReader(f):
                it = int(float(row["iteration"]))
                for key, val in row.items():
                    if key == "iteration" or val in ("", None):
                        continue
                    s, v = series[key.replace(" ", "_")]
                    s.append(it)
                    v.append(float(val))
    if os.path.exists(jsonl_path):
        with open(jsonl_path) as f:
            for line in f:
                rec = json.loads(line)
                tag = rec["tag"].replace("metric/", "").replace(
                    "loss/", "loss_")
                s, v = series[tag]
                s.append(rec["step"])
                v.append(rec["value"])
    return series


def _plot(ax, series, tag, width) -> None:
    s, v = series[tag]
    order = sorted(range(len(s)), key=lambda i: s[i])
    ax.plot([s[i] for i in order], [v[i] for i in order], label=tag,
            linewidth=width)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", required=True,
                    help="run log dir (e.g. snap/<name>)")
    ap.add_argument("--out", default=None,
                    help="output dir (default <run>/plots)")
    args = ap.parse_args(argv)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out = args.out or os.path.join(args.run, "plots")
    os.makedirs(out, exist_ok=True)
    series = load_series(args.run)
    if not series:
        print(f"no plot_log.csv or metrics.jsonl under {args.run}")
        sys.exit(1)

    # the reference's panels (tasks/R2R/plot.py:30-35): loss, navigation
    # error, success rate
    panels = [
        ("Loss", lambda t: "loss" in t),
        ("Navigation Error (m)", lambda t: "nav_error" in t),
        ("Success rate",
         lambda t: "success_rate" in t or t.endswith("spl")),
    ]
    fig, axes = plt.subplots(1, 3, figsize=(16, 4.5))
    for ax, (title, match) in zip(axes, panels):
        for tag in sorted(series):
            if match(tag):
                _plot(ax, series, tag, 1.4)
        ax.set_title(title)
        ax.set_xlabel("iteration")
        ax.grid(alpha=0.3)
        if ax.lines:
            ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(os.path.join(out, "training.png"), dpi=130)

    # error.png: the navigation-error panel alone (the reference's plot.py
    # writes a second figure)
    fig2, ax = plt.subplots(figsize=(6.5, 4.5))
    for tag in sorted(series):
        if "nav_error" in tag or "oracle_error" in tag:
            _plot(ax, series, tag, 1.4)
    ax.set_title("Navigation / oracle error")
    ax.set_xlabel("iteration")
    ax.set_ylabel("m")
    ax.grid(alpha=0.3)
    if ax.lines:
        ax.legend(fontsize=8)
    fig2.tight_layout()
    fig2.savefig(os.path.join(out, "error.png"), dpi=130)
    print(f"wrote {out}/training.png and {out}/error.png "
          f"({len(series)} series)")


if __name__ == "__main__":
    main()
