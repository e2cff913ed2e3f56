"""Interactive episode driver: walk the navigation graph by hand.

The analog of the reference's keyboard driver
(src/driver/mattersim_main.cpp:1-101), which rendered the cubemap and
moved on keystrokes.  The training path is feature-based (no rendering),
so this driver shows the simulator's state as text (the viewpoint, the
pose and the navigable candidates with their relative headings) and steps
on typed candidate indices:

    python -m dasa_tpu_torch.scripts.interactive_agent --scan 17DRP5sb8fy
    > 2          # move to candidate 2
    > l          # turn left 30 degrees
    > quit
"""

from __future__ import annotations

import argparse
import math

from dasa_tpu_torch.config import _default_connectivity_dir
from dasa_tpu_torch.sim.engine import Simulator


def describe(state) -> None:
    deg = 180.0 / math.pi
    print(f"\nviewpoint {state.location.viewpointId}  "
          f"heading {state.heading * deg:.0f}deg  "
          f"elevation {state.elevation * deg:.0f}deg  "
          f"viewIndex {state.viewIndex}  step {state.step}")
    print("candidates (relative to gaze):")
    for i, c in enumerate(state.navigableLocations[1:], start=1):
        print(f"  [{i}] {c.viewpointId}  "
              f"rel_heading {c.rel_heading * deg:+.0f}deg  "
              f"rel_elevation {c.rel_elevation * deg:+.0f}deg  "
              f"distance {c.rel_distance:.2f} m")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scan", default="17DRP5sb8fy")
    ap.add_argument("--viewpoint", default="",
                    help="start viewpoint id (default: random)")
    ap.add_argument("--connectivity_dir",
                    default=_default_connectivity_dir())
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--discretized", action="store_true",
                    help="snap turns to the 30-degree grid")
    args = ap.parse_args(argv)

    sim = Simulator(connectivity_dir=args.connectivity_dir)
    sim.setDiscretizedViewingAngles(args.discretized)
    sim.setSeed(args.seed)
    sim.init()
    sim.newEpisode(args.scan, args.viewpoint)
    turn = math.pi / 6
    print("commands: <index> move | l/r turn | u/d look | quit")
    while True:
        state = sim.getState()
        describe(state)
        try:
            cmd = input("> ").strip().lower()
        except EOFError:
            break
        if cmd in ("quit", "q", "stop", "s"):
            break
        if cmd in ("l", "r", "u", "d"):
            dh = {"l": -turn, "r": turn}.get(cmd, 0.0)
            de = {"u": turn, "d": -turn}.get(cmd, 0.0)
            sim.makeAction(0, dh, de)
            continue
        try:
            ix = int(cmd)
        except ValueError:
            print("?")
            continue
        n = len(state.navigableLocations)
        if not 1 <= ix < n:
            print(f"index out of range (1..{n - 1})")
            continue
        sim.makeAction(ix, 0.0, 0.0)


if __name__ == "__main__":
    main()
