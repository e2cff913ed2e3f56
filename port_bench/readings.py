"""The readings a cell's limits are set from: the program's numbers on
many seeds (a run with no measured window) and, with ``--control 1``, the
control's (the reference with its weight products rounded to fp8, put in
the program's place) on the same seeds, in one process.  Each line gives
the verdict of the cell's limits on the program (``correct``) and on the
control (``control_correct``).

    python3 -m port_bench.readings --workload <cell> --seeds 1,2,3
        [--control 1] [--fault frozen|half|token]

Prints one JSON line a seed and writes them to
``chiprun_out/readings-<cell>.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from port_bench import run


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control", type=int, default=0)
    parser.add_argument("--fault", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    # the control rounds tensors of a whole pool of rows: growable
    # segments keep the allocator from fragmenting between them
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    root = os.getcwd()
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    out = os.path.join(root, "chiprun_out",
                       f"readings-{args.workload}"
                       f"{'-' + args.fault if args.fault else ''}.jsonl")
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        res = run.run_cell(root, args.workload, seed, 0.0, 0,
                           device=args.device, fault=args.fault,
                           control=bool(args.control))
        ctl = res.get("control")
        line = {"seed": seed, "correct": res["correct"],
                "program": {k: v["value"]
                            for k, v in res["compared"].items()},
                "control_correct": ctl and ctl["correct"],
                "control": ctl and {k: v["value"] for k, v
                                    in ctl["compared"].items()},
                "seconds": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        with open(out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
