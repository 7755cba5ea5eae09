"""The `neuralbody-zju` configuration and its cell `nbody-zju-views`.

  * The configuration names the port's `NeuralBody` renderer and the
    reference benchmark.reference.nbody, which raises for a train loop.
  * The checkpoint's maker (tools/make_nbody_ckpt.py) imports neither
    JAX nor the port: the weights come from the reference's code alone.
  * The frozen counts (benchmark/nbody_costs.py) are the published
    widths'.
  * The four readers on a hand-built trace: each gives its value, and None
    where the program opened no `nbody.render` span in each request.
  * A CPU run of the cell at 64x64 is correct, with either trace setting.
  * On the card (`-m gpu`): the program passes the cell's limit on three
    seeds, and the fp8 control and a program whose sparse stack gives zero
    volumes fail it; a short run of the cell prints a correct line.
"""

import ast
import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import calibrate, costs, nbody_costs, system
from benchmark.harness import Context, Spec, main, reader
from benchmark.trace import Trace

from conftest import ROOT, SEED

CELL = "nbody-zju-views"
CONF = json.load(open(os.path.join(ROOT, "benchmark", "configs", "neuralbody-zju.json")))
METRICS = ("nbody_volume_ms.render", "nbody_points_ms.render", "nbody_points_roofline",
           "mfu.nbody")
# the generic readers of the host's dispatch and the device's idle share
GENERIC = ("launches_per_frame", "host_syncs_per_frame", "device_idle_share.render")
MAKER = os.path.join(ROOT, "tools", "make_nbody_ckpt.py")
FORBIDDEN = {"jax", "jaxlib", "flax", "gpnerf_tpu", "gpnerf_tpu_torch"}
GPU_SEEDS = [2**31 + 7101, 2**31 + 7102, 2**31 + 7103]


def test_configuration_names_its_program_and_reference():
    from gpnerf_tpu_torch.render import neural_body

    assert system.builder(CONF, "views") is neural_body.build_render
    ref = system.reference(CONF)
    assert ref.__name__ == "benchmark.reference.nbody"
    with pytest.raises(NotImplementedError, match="no train cell"):
        ref.train_readings(CONF, None, None, None, 0, [], None)
    spec = Spec(CELL)
    assert spec.conf["name"] == "neuralbody-zju" and spec.traffic["loop"] == "views"
    assert {m["name"] for m in spec.per_layer()} == set(METRICS + GENERIC)
    assert {m["name"] for m in spec.end_to_end()} == {"frames_per_s", "frame_p95_ms", "setup_s"}


def test_the_checkpoint_maker_imports_no_jax_and_no_port():
    for node in ast.walk(ast.parse(open(MAKER).read())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                 [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
        assert not {n.split(".")[0] for n in names} & FORBIDDEN, names
    code = (f"import json, runpy, sys; runpy.run_path({MAKER!r}); "
            f"print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_frozen_counts_are_the_published_widths():
    assert nbody_costs.MULTIPLY_ADDS == 429952 and nbody_costs.POINT_FLOPS == 859904
    # the sparse stack at a frame's active sites, levels 0-4
    assert nbody_costs.volume_flops([6717, 15336, 6922, 1944, 512]) == 15496068096
    # level volumes (48, 160, 112) x 32, (24, 80, 56) x 64, (12, 40, 28) x 128,
    # (6, 20, 14) x 128 in bfloat16, and 16 B a sample
    assert nbody_costs.point_bytes(10, (96, 320, 224)) == 2 * (
        48 * 160 * 112 * 32 + 24 * 80 * 56 * 64 + 12 * 40 * 28 * 128 + 6 * 20 * 14 * 128) + 160


def _x(name, ts, dur, cat="user_annotation", **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def _events(n=2, render="nbody.render"):
    """n requests; in each the volume launches a kernel of 30 us, the
    points two of 100 and 60 us, the composite one of 10 us."""
    ev = [_x("bench.window", 0, 10000)]
    corr = 0
    for i in range(n):
        t = 1000 + 3000 * i
        ev += [_x("bench.request", t, 2500), _x(render, t + 100, 2000),
               _x("nbody.volume", t + 100, 300), _x("nbody.points", t + 500, 1000),
               _x("nbody.composite", t + 1600, 300)]
        for at, dur in ((t + 150, 30), (t + 600, 100), (t + 800, 60), (t + 1650, 10)):
            ev += [_x("cudaLaunchKernel", at, 1, cat="cuda_runtime", correlation=corr),
                   _x(f"kernel_{corr}", at + 5, dur, cat="kernel", correlation=corr)]
            corr += 1
    return ev


def _ctx(events):
    ref = {3: {"points": 4_000_000, "sites": [6717, 15336, 6922, 1944, 512],
               "out_sh": [96, 320, 224]},
           9: {"points": 5_000_000, "sites": [6720, 15300, 6900, 1950, 510],
               "out_sh": [96, 320, 224]}}
    return Context(trace=Trace(events, "bench.request"), items=[3, 9], ref=ref,
                   device_name=costs.H100)


def test_readers_on_a_hand_built_trace():
    ctx = _ctx(_events())
    assert reader("nbody_volume_ms.render")(ctx) == pytest.approx(0.03)
    assert reader("nbody_points_ms.render")(ctx) == pytest.approx(0.16)
    peak_b, peak_f = costs.PEAKS[costs.H100]["hbm_bytes_per_s"], costs.PEAKS[costs.H100]["bfloat16"]
    bound = sum(max(nbody_costs.point_bytes(r["points"], r["out_sh"]) / peak_b,
                    nbody_costs.point_flops(r["points"]) / peak_f) for r in ctx.ref.values())
    assert reader("nbody_points_roofline")(ctx) == pytest.approx(100 * bound / 320e-6)
    flops = sum(nbody_costs.volume_flops(r["sites"]) + nbody_costs.point_flops(r["points"])
                for r in ctx.ref.values())
    assert reader("mfu.nbody")(ctx) == pytest.approx(100 * flops / 0.01 / peak_f)


def test_span_readers_read_none_without_one_render_a_request():
    for events in (_events(render="gpnerf.render"),
                   [e for e in _events() if e["name"] != "nbody.render" or e["ts"] < 3000]):
        ctx = _ctx(events)
        assert reader("nbody_volume_ms.render")(ctx) is None
        assert reader("nbody_points_ms.render")(ctx) is None
    no_points = [e for e in _events() if e["name"] != "nbody.points"]
    assert reader("nbody_points_roofline")(_ctx(no_points)) is None


def _small(conf, traffic):
    conf["cfg"]["dataset"]["H"] = conf["cfg"]["dataset"]["W"] = 64
    traffic.update(pool=2, check_items=2, warm_requests=1, trace_seconds=1.0, threads=2)
    return conf


@pytest.mark.parametrize("trace", [0, 1])
def test_a_cpu_run_is_correct(trace):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = main(["--workload", CELL, "--seed", str(SEED), "--seconds", "1", "--trace",
                   str(trace)], need_cuda=False, overrides=_small)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True, line["check"]
    if trace:
        # the card's peaks name no CPU: the shares read None there
        assert set(line["metrics"]) == {"nbody_volume_ms.render", "nbody_points_ms.render",
                                        *GENERIC}
    else:
        assert set(line["metrics"]) == {"frames_per_s", "frame_p95_ms", "setup_s"}


def _over(numbers, limits):
    return [k for k, lim in limits.items() if numbers[k] > lim]


@pytest.mark.gpu
def test_control_and_zeroed_volumes_fail_where_the_program_passes(cuda_device, monkeypatch):
    from gpnerf_tpu_torch.models.neural_body import NeuralBody

    spec = Spec(CELL)
    limits = spec.conf["limits"]["views"]
    out = calibrate.view_readings(spec, GPU_SEEDS, set(GPU_SEEDS), cuda_device)
    for seed in GPU_SEEDS:
        assert not _over(out["program"][seed], limits), (seed, out["program"][seed])
        assert _over(out["control"][seed], limits), (seed, out["control"][seed])
    volumes = NeuralBody.volumes
    monkeypatch.setattr(NeuralBody, "volumes",
                        lambda self, *a: [torch.zeros_like(v) for v in volumes(self, *a)])
    fault = calibrate.view_readings(spec, GPU_SEEDS[:1], set(), cuda_device)
    assert _over(fault["program"][GPU_SEEDS[0]], limits), fault["program"]


@pytest.mark.gpu
def test_a_short_run_is_correct(cuda_device):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
                          str(GPU_SEEDS[0]), "--seconds", "5", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
