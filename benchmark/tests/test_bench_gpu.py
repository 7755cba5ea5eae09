"""On the card, at each cell's own size: the control (the reference one
precision step below the configuration's) fails the cell's limits on three
seeds while the program passes them, the half-batch fault fails the train
cell's, and a short run of each cell prints a correct result line.

    python -m pytest benchmark/tests -m gpu -q      # on the GPU machine
"""

import json
import os
import subprocess
import sys

import pytest

from benchmark import calibrate
from benchmark.harness import Spec

from conftest import ROOT

SEEDS = [2**31 + 7001, 2**31 + 7002, 2**31 + 7003]


def over(numbers, limits):
    return [k for k, lim in limits.items() if numbers[k] > lim]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["zju-fast-views", "zju-paper-views", "zju-train-1024"])
def test_control_fails_where_the_program_passes(cell, cuda_device):
    spec = Spec(cell)
    loop = spec.traffic["loop"]
    limits = spec.conf["limits"][loop]
    fn = calibrate.view_readings if loop == "views" else calibrate.train_readings
    out = fn(spec, SEEDS, set(SEEDS), cuda_device)
    for seed in SEEDS:
        assert not over(out["program"][seed], limits), (seed, out["program"][seed])
        for side in out:
            if side != "program":
                assert over(out[side][seed], limits), (side, seed, out[side][seed])


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["zju-fast-views", "zju-paper-views", "zju-train-1024"])
def test_a_short_run_is_correct(cell, cuda_device):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          str(SEEDS[0]), "--seconds", "5", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "check" and "setup_s" in line["metrics"]
    assert os.path.isdir(os.path.join(ROOT, "gpnerf_tpu_torch", "_build"))
