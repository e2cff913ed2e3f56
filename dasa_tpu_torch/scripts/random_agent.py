"""Random-agent demo over the graph simulator (reference analog:
src/driver/random_agent.cpp, a seeded random policy smoke loop):

    python -m dasa_tpu_torch.scripts.random_agent --connectivity \
        connectivity --scan 17DRP5sb8fy --steps 10
"""

from __future__ import annotations

import argparse
import random

from dasa_tpu_torch.config import _default_connectivity_dir
from dasa_tpu_torch.sim import Simulator


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--connectivity", default=_default_connectivity_dir())
    p.add_argument("--scan", default="17DRP5sb8fy")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)

    sim = Simulator(args.connectivity)
    sim.setRenderingEnabled(False)
    sim.setDiscretizedViewingAngles(True)
    sim.setSeed(args.seed)
    sim.init()
    sim.newEpisode(args.scan)
    rng = random.Random(args.seed)
    for _ in range(args.steps):
        st = sim.getState()
        print(f"step {st.step}: at {st.location.viewpointId} "
              f"view {st.viewIndex} heading {st.heading:.2f} "
              f"({len(st.navigableLocations) - 1} neighbors)")
        ix = rng.randrange(len(st.navigableLocations))
        sim.makeAction(ix, rng.choice([-1, 0, 1]), rng.choice([-1, 0, 1]))
    print("done")


if __name__ == "__main__":
    main()
