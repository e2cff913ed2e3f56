"""Run one cell of the port's benchmark once.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration (``port_bench/configs/``) and a
traffic mix (``port_bench/traffic/``).  Set-up makes the inputs from the
seed, builds the agent and runs the mix's checked windows, which warm
every shape up; the measured window then runs the agent's training call
for ``--seconds``, with ``--trace 1`` under the profiler (device activity
only, reduced in memory).  After the window the program is freed and the
reference follows the checked windows; the comparison decides
``correct``.  The last line of standard output is the result as JSON; the
numbers compared, each beside its limit, are the last lines of standard
error and the result's last key.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dasa_tpu")
NAME_CHARS = 100


def forbidden_modules():
    """Loaded modules whose top-level name is one the benchmark may not
    load, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def load_json(path):
    with open(path) as f:
        return json.load(f)


def find_cell(root, name):
    """(cell, configuration, traffic mix, its metrics by kind)."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[cell["config"]]["file"]))
    traffic = load_mix(root, cell["traffic"])
    metrics = {kind: [m for m in bench[kind]
                      if name in m.get("workloads", [name])]
               for kind in ("end_to_end", "per_layer")}
    return cell, config, traffic, metrics


def load_mix(root, name):
    return load_json(os.path.join(root, "port_bench", "traffic",
                                  f"{name}.json"))


def read_metric(root, name, ctx):
    path = os.path.join(root, "port_bench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"port_bench_metric_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


class Setup:
    """The inputs, the world and the agent of one run."""

    def __init__(self, config, traffic, seed, device, work):
        import torch

        from port_bench import data, program

        # seconds from the process's start to the end of each stage
        self.stages = {"imports": time.perf_counter() - T_START}

        def mark(stage):
            self.stages[stage] = time.perf_counter() - T_START

        self.mark = mark
        self.settings = {**config["settings"], **traffic["settings"]}
        s = self.settings
        self.seed = seed % (2 ** 31 - 1)
        table_dtype = (torch.bfloat16 if s["compute_dtype"] == "bfloat16"
                       and device != "cpu" else torch.float32)
        self.seeds = {"weights": self.seed, "features": self.seed,
                      "rollout": self.seed, "table_dtype": table_dtype}
        self.task = data.write_task(work, traffic, self.seed)
        mark("inputs")
        cfg = program.make_config(s, self.task["data"],
                                  self.task["connectivity"], self.seed)
        split = traffic["split"]["name"]
        self.world = program.BenchWorld(cfg, split, self.task["feature_ids"],
                                        traffic["task"] == "ndh")
        mark("world")
        tables = data.feature_tables(len(self.task["feature_ids"]), 36,
                                     s["feature_size"], self.seeds["features"],
                                     device, table_dtype)
        self.agent = program.build_agent(
            cfg, self.world, split,
            lambda shapes: data.weights(shapes, self.seeds["weights"],
                                        device), tables, device)
        if device != "cpu":
            torch.cuda.synchronize()
        mark("agent")


def checked_windows(agent, n):
    """The checked windows: ``n`` training iterations whose records the
    reference follows.  Returns the program's readings and the staged
    episodes of each window."""
    import torch

    from port_bench import program

    params = program.trained_params(agent)
    p0 = {k: p.detach().clone() for k, p in params.items()}
    prog = {"losses": [], "grads": {}}
    staged = []
    for k in range(n):
        program.check_window(agent)
        staged.append(program.staged_ids(agent))
        prog["losses"].append(float(agent.losses[-1]))
        if k == 0:
            prog["grads"] = program.grad_norms_from_state(agent)
    prog["changes"] = {k: float(torch.linalg.vector_norm(
        params[k].detach() - p0[k])) for k in params}
    prog["records"] = program.records_of(agent)
    return prog, staged


def measure(call, steps_of, seconds, trace, device):
    """Run ``call()`` until ``seconds`` have passed and the device has
    finished; returns the window's wall, calls, work, peak memory, the
    calls' results and, traced, the reduced device trace."""
    import torch

    from port_bench import trace as tr

    cuda = device != "cpu"
    profiler = None
    if trace and cuda:
        profiler = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        profiler.__enter__()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    steps0 = steps_of()
    results = []
    t0 = time.perf_counter()
    calls = 0
    while time.perf_counter() - t0 < seconds:
        results.append(call())
        calls += 1
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"wall_s": wall, "calls": calls, "steps": steps_of() - steps0,
           "peak": torch.cuda.max_memory_allocated() if cuda else None,
           "results": results, "trace": None}
    if profiler is not None:
        profiler.__exit__(None, None, None)
        events = tr.device_events(profiler)
        del profiler
        lo = min((e[2] for e in events), default=0)
        out["trace"] = tr.reduce(events, lo, lo + int(wall * 1e9))
    return out


def run_cell(root, workload, seed, seconds, trace, device="cuda",
             fault=None, tmp=None, control=False):
    """One run of ``workload``; returns the result dict.  ``fault`` plants
    a known fault in the program (the tests' use): ``frozen`` (the update
    leaves the parameters unchanged), ``half`` (the teacher half of the
    slots left out of the loss), ``token`` (every sampled action altered
    where it is drawn).  ``control`` also reads the control."""
    import torch

    from port_bench import check, flops, program

    cell, config, traffic, metric_defs = find_cell(root, workload)
    if traffic["regime"] != "train-stream":
        raise SystemExit(f"regime {traffic['regime']!r} has no checked "
                         "driver")
    with tempfile.TemporaryDirectory(dir=tmp) as work:
        su = Setup(config, traffic, seed, device, work)
        agent = su.agent
        restore = plant(agent, fault)
        prog, staged = checked_windows(agent, traffic["check_windows"])
        counters = program.WindowCounters(agent)
        if device != "cpu":
            torch.cuda.synchronize()
        su.mark("checked windows")
        setup_s = time.perf_counter() - T_START

        def train():
            agent.train(1, feedback="sample")
            return agent.losses[-1]

        win = measure(train, lambda: program.agent_steps(agent, 0),
                      seconds, trace, device)
        failed = sum(1 for x in win.pop("results")
                     if not bool(torch.isfinite(x)))
        starved, slot_steps = counters.starved_total(), counters.slot_steps
        episodes = counters.episodes_total()
        restore()
        del agent, su.agent, su.world, counters
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()

        # ---- the reference follows the checked windows
        t_ref = time.perf_counter()
        actions = [r["rec_action"] for r in prog["records"]]
        ref = check.reference_run(su.settings, su.task, traffic, su.seeds,
                                  staged, actions, device)
        numbers = check.compare(prog, ref)
        control_numbers = None
        if control:
            low = check.reference_run(su.settings, su.task, traffic,
                                      su.seeds, staged, actions, device,
                                      fp8=True)
            control_numbers = check.compare(check.as_program(low), ref)
        ref_s = time.perf_counter() - t_ref
    limits = check.load_limits(root, workload)
    correct, rows = check.judge(numbers, limits)

    ctx = {"wall_s": win["wall_s"], "agent_steps": win["steps"],
           "trace": win["trace"],
           "model_flops": flops.stream_window_flops(
               su.settings, episodes, win["calls"]),
           "kernel_bound_s": win["calls"]
           * flops.stream_window_kernel_bound_s(su.settings),
           "starved": starved, "slot_steps": slot_steps,
           "setup_s": setup_s, "peak_bytes": win["peak"]}
    result = report(root, metric_defs, ctx, win, trace, device)
    result["correct"] = bool(correct and failed == 0)
    result["failed"] = failed
    result["window"] = {"wall_s": win["wall_s"], "calls": win["calls"],
                        "agent_steps": win["steps"], "slot_steps": slot_steps,
                        "starved": starved, "episodes": episodes}
    result["setup_stages"] = su.stages
    result["reference_s"] = ref_s
    if control_numbers is not None:
        # the control judged as the program is, against the cell's limits
        ctl_correct, ctl_rows = check.judge(control_numbers, limits)
        result["control"] = {"correct": bool(ctl_correct),
                             "compared": {k: {"value": v, "limit": lim}
                                          for k, v, lim in ctl_rows}}
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, v, lim in rows}
    return result


def report(root, metric_defs, ctx, win, trace, device):
    """The result but ``correct``, ``failed`` and ``compared``."""
    import torch

    metrics = {}
    for m in metric_defs["per_layer" if trace else "end_to_end"]:
        value = read_metric(root, m["name"], ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = device != "cpu"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": win["peak"],
           "power_limit_w": power_limit() if cuda else None}
    result = {"correct": False, "attempted": win["calls"], "failed": 0,
              "metrics": metrics, "device": dev}
    tr = win["trace"]
    if tr is not None:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        result["breakdown"] = {
            "device_ops": [[n[:NAME_CHARS], t] for n, t in tr["device_ops"]],
            "idle_gaps": tr["idle_gaps"]}
    return result


def plant(agent, fault):
    """Plant ``fault`` in the program; returns the undo."""
    import torch

    if fault is None:
        return lambda: None
    if fault == "frozen":
        agent.optimizer.step = lambda: None
        return lambda: None
    if fault == "half":
        agent.cfg = agent.cfg.replace(ml_weight=0.0)
        return lambda: None
    if fault == "token":
        draw = torch.multinomial

        def altered(probs, n, *args, **kwargs):
            got = draw(probs, n, *args, **kwargs)
            other = probs.clone().scatter_(1, got, 0.0)
            alt = other.argmax(1, keepdim=True)
            return torch.where(other.amax(1, keepdim=True) > 0, alt, got)

        torch.multinomial = altered

        def undo():
            torch.multinomial = draw
        return undo
    raise ValueError(fault)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = os.getcwd()
    cell, _config, _traffic, _metrics = find_cell(root, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"port_bench: the cell needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    result = run_cell(root, args.workload, args.seed, args.seconds,
                      args.trace)
    found = forbidden_modules()
    if found:
        print(f"port_bench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    print("set-up stages, s from the start: " + ", ".join(
        f"{k} {v:.2f}" for k, v in result["setup_stages"].items()),
        file=sys.stderr)
    print(f"reference check: {result['reference_s']:.1f} s",
          file=sys.stderr)
    for name, row in result["compared"].items():
        print(f"compared {name}: {row['value']!r} (limit {row['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
