"""What the benchmark loads: after a CPU run of the harness and its
reference no top-level module name in `sys.modules` is `jax`, `jaxlib`,
`flax` or the JAX package `gpnerf_tpu` (whole names: the port's name
begins with the JAX package's); no file under benchmark/ imports them, and
no file of the reference imports the port. Each configuration's reference
module is held to the same: no file of its directory imports them or the
port, and importing it loads none of them. In a directory that holds only
BENCHMARK.json and benchmark/, a run fails with no result line."""

import ast
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import system

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "gpnerf_tpu"}
BENCH = os.path.join(ROOT, "benchmark")

CONFS = {c["name"]: json.load(open(os.path.join(ROOT, c["file"])))
         for c in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["configs"]}

IMPORT = """
import json, sys
sys.path.insert(0, {root!r})
import {module}
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})))
"""

RUN = """
import json, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from conftest import run_harness
rc, line, err = run_harness({cell!r})
bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})
print(json.dumps({{"rc": rc, "correct": line and line["correct"], "bad": bad}}))
"""


def python_files(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("cell", ["zju-fast-views", "zju-train-1024"])
def test_a_run_loads_no_jax(cell):
    code = RUN.format(root=ROOT, tests=os.path.join(BENCH, "tests"), cell=cell,
                      forbidden=FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"rc": 0, "correct": True, "bad": []}


def test_no_file_imports_jax_and_the_reference_imports_no_port():
    for path in python_files(BENCH):
        for mod in imported(path):
            assert mod.split(".")[0] not in FORBIDDEN, (path, mod)
            if os.sep + "reference" + os.sep in path:
                assert mod.split(".")[0] != "gpnerf_tpu_torch", (path, mod)


def test_fails_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    code = ("import sys; sys.path.insert(0, '.'); sys.path.insert(0, 'benchmark/tests');"
            "from conftest import run_harness; print(run_harness('zju-fast-views'))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=600)
    assert out.returncode != 0 and out.stdout == ""
    assert "gpnerf_tpu_torch" in out.stderr


@pytest.mark.parametrize("conf", sorted(CONFS))
def test_each_configurations_reference_imports_no_jax_and_no_port(conf):
    module = system.reference_name(CONFS[conf])
    top = os.path.dirname(importlib.util.find_spec(module).origin)
    for path in python_files(top):
        for mod in imported(path):
            assert mod.split(".")[0] not in FORBIDDEN | {"gpnerf_tpu_torch"}, (path, mod)
    code = IMPORT.format(root=ROOT, module=module, forbidden=FORBIDDEN | {"gpnerf_tpu_torch"})
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
