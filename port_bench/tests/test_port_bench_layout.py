"""BENCHMARK.json against the layout the harness reads: every cell's
configuration, traffic mix and limits resolve to files, every metric to
its reader, and every name keeps to the allowed characters."""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys

from port_bench.tests.conftest import PB, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "dasa_tpu"}


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_entry_resolves():
    b = bench()
    assert b["paths"] == ["port_bench"]
    configs = {c["name"]: c for c in b["configs"]}
    used = set()
    for cell in b["workloads"]:
        assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
        assert cell["config"] in configs and cell["chips"] in (1, 4)
        used.add(cell["config"])
        for path in (f"traffic/{cell['traffic']}.json",
                     f"limits/{cell['name']}.json"):
            assert os.path.exists(os.path.join(PB, path)), path
        with open(os.path.join(PB, "traffic",
                               f"{cell['traffic']}.json")) as f:
            assert json.load(f)["regime"] == "train-stream"
    assert used == set(configs)
    for c in b["configs"]:
        assert NAME.match(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert os.path.exists(os.path.join(PB, "metrics",
                                           f"{m['name']}.py")), m["name"]
    for m in b["per_layer"]:
        assert m["moves"] in e2e
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def imports_of(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    """An AST walk of every module under port_bench: no import whose
    top-level name, compared whole, is JAX's or the JAX package's; the
    reference imports nothing of the port either."""
    for d, _dirs, files in os.walk(PB):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(d, name)
            tops = {m.split(".")[0] for m in imports_of(path)}
            assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
            if os.sep + "reference" + os.sep in path:
                assert "dasa_tpu_torch" not in tops, path


def test_the_run_module_loads_no_jax():
    """At run time, after importing the harness and the program."""
    code = ("import sys, port_bench.run, port_bench.program, "
            "port_bench.check; from port_bench.run import forbidden_modules;"
            " print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
