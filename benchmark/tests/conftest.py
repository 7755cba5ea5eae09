"""Shared pieces of the benchmark's tests: the cells cut to a size the
CPU runs in seconds (128x128 frames, small caps, a pool of 2, training at
128 rays x 16 samples), and a harness run under that cut."""

import contextlib
import io
import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SEED = 2**31 + 12345


def small(conf, traffic):
    """A configuration and traffic cut to the CPU's size, in place."""
    c = conf["cfg"]
    c["dataset"]["H"] = c["dataset"]["W"] = 128
    c["tpu"].update(ray_cap=9216, sigma_cap=262144 if c["tpu"]["tight_cull"] else 1048576,
                    rgb_cap=262144)
    c["train"].update(n_rays=128, n_samples=16)
    traffic.update(pool=2, check_items=2, warm_requests=1, trace_seconds=1.0, batches=3,
                   threads=2)
    return conf


def run_harness(workload, trace=0, seconds=1.0, seed=SEED):
    """(exit code, result line or None, stderr) of one CPU run of the
    harness at the small size."""
    from benchmark.harness import main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace)], need_cuda=False, overrides=small)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


@pytest.fixture(autouse=True, scope="session")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda", 0)
