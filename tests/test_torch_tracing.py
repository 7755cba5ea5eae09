"""The port's spans and counters (gpnerf_tpu_torch/utils/profiling.py) and
the benchmark's readers of them (benchmark/spans.py, benchmark/metrics/).

  * A profiled request (upload, `render_demo`, download) holds each render
    span once, nested as the calls nest, siblings disjoint; the upload and
    the download lie outside `gpnerf.render`, all inside the request.
  * A profiled `train_step` holds its four phase spans once each, in order
    and disjoint.
  * The counters equal what they count: the uploaded tensors' bytes, the
    point stages' P and the render dict's `counts[2]`.
  * Without a profiler a render enters no `record_function` and counts
    nothing; the image is bitwise the profiled one's.
  * Each reader gives its value on a hand-built Chrome trace, and None
    where the program has no such span or counter, or where the counted
    renders differ from the traced requests.

A 64^2 demo render with the trained checkpoint and a tiny 128^2 train
step, on the CPU."""

import contextlib
import json
import os
import random

import numpy as np
import pytest
import torch

from benchmark import spans
from benchmark.harness import Context, reader
from benchmark.trace import Trace
from gpnerf_tpu_torch.config import cfg as port_cfg
from gpnerf_tpu_torch.registry import get as port_get
from gpnerf_tpu_torch.render import demo
from gpnerf_tpu_torch.render.base import batch_to_device
from gpnerf_tpu_torch.render.base import build_render as build_train_render
from gpnerf_tpu_torch.train.checkpoint import load_eval_model
from gpnerf_tpu_torch.train.criterion import Criterion
from gpnerf_tpu_torch.train.step import make_optimizer, train_step
from gpnerf_tpu_torch.utils import profiling

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "artifacts", "bench_ckpt.pth")
STAGES = ("gpnerf.encoder", "gpnerf.frame_stage", "gpnerf.ray_pipeline", "gpnerf.assemble")
PHASES = ("gpnerf.train.forward", "gpnerf.train.loss", "gpnerf.train.backward",
          "gpnerf.train.optimizer")


def _cfg(**over):
    cfg = port_cfg.clone()
    cfg.defrost()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "synthetic.yaml"))
    for k, v in over.items():
        node = cfg
        *path, leaf = k.split(".")
        for p in path:
            node = getattr(node, p)
        setattr(node, leaf, v)
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_counts():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


@pytest.fixture(scope="module")
def scene():
    """(renderer, host batch) of the 64^2 synthetic view, every pixel a ray."""
    cfg = _cfg(**{"dataset.H": 64, "dataset.W": 64, "head.sigma.code_dim": 32,
                  "render.file": "demo_render", "tpu.ray_cap": 4096})
    random.seed(0)
    np.random.seed(0)
    host = port_get("dataset", cfg.dataset.test.file)(cfg, is_train=False)[0]
    render = port_get("render", "demo_render")(cfg, device="cpu")
    load_eval_model(CKPT, render)
    return render.eval(), host


def _request(render, host, dev=torch.device("cpu")):
    """One request as a client makes it: (uploaded batch, render dict, image)."""
    on = profiling.recording()
    with torch.profiler.record_function("bench.request") if on else contextlib.nullcontext():
        batch = batch_to_device(host, dev)
        ret = render.render_demo_fn()(batch)
        img = demo.pred_img_hwc(ret)
    return batch, ret, img


def _profiled(fn, tmp_path):
    """(fn's result, the trace's spans as {name: [(start, end)]})."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    found = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            found.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    return out, found


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _in_order_disjoint(ivs):
    return all(a[1] <= b[0] for a, b in zip(ivs, ivs[1:]))


def test_render_spans_nest_as_the_calls(scene, tmp_path):
    render, host = scene
    _, found = _profiled(lambda: _request(render, host), tmp_path)
    names = ("bench.request", "gpnerf.upload", "gpnerf.render", "gpnerf.point_stages",
             "gpnerf.download") + STAGES
    assert {n: len(found.get(n, [])) for n in names} == {n: 1 for n in names}
    one = {n: found[n][0] for n in names}
    req, whole = one["bench.request"], one["gpnerf.render"]
    assert all(_inside(one[n], req) for n in names)
    assert _in_order_disjoint([one["gpnerf.upload"], whole, one["gpnerf.download"]])
    assert all(_inside(one[n], whole) for n in STAGES)
    assert _in_order_disjoint([one[n] for n in STAGES])
    assert _inside(one["gpnerf.point_stages"], one["gpnerf.ray_pipeline"])


def test_train_step_phases_in_order(tmp_path):
    cfg = _cfg(**{"encoder.name": "tiny", "dataset.H": 128, "dataset.W": 128,
                  "head.sigma.code_dim": 16, "train.n_rays": 256, "train.n_samples": 8})
    random.seed(0)
    np.random.seed(0)
    host = port_get("dataset", cfg.dataset.train.file)(cfg, is_train=True)[0]
    render = build_train_render(cfg, device="cpu")
    torch.manual_seed(0)
    render.init_variables(0)
    opt, sched, _ = make_optimizer(render, cfg)
    batch = batch_to_device(host, torch.device("cpu"))
    t_rand = torch.rand(cfg.train.n_rays, cfg.train.n_samples,
                        generator=torch.Generator().manual_seed(0))
    (metrics, _), found = _profiled(
        lambda: train_step(render, Criterion(cfg), opt, sched, batch, t_rand=t_rand), tmp_path)
    assert torch.isfinite(metrics["loss"])
    assert {n: len(found.get(n, [])) for n in PHASES} == {n: 1 for n in PHASES}
    assert _in_order_disjoint([found[n][0] for n in PHASES])
    assert profiling.counters().get("renders") is None  # the train render is not a view


def test_counters_equal_what_they_count(scene, tmp_path, monkeypatch):
    render, host = scene
    seen = []
    orig = demo.Renderer._point_stages

    def spy(self, batch, pre, tables, pts_c, *args, **kw):
        seen.append(pts_c.shape[0])
        return orig(self, batch, pre, tables, pts_c, *args, **kw)

    monkeypatch.setattr(demo.Renderer, "_point_stages", spy)
    (batch, ret, _), _ = _profiled(lambda: _request(render, host), tmp_path)
    uploaded = sum(v.numel() * v.element_size() for v in batch.values()
                   if isinstance(v, torch.Tensor))
    assert len(seen) == 1 and seen[0] > 0
    assert profiling.counters() == {"renders": 1, "upload_bytes": uploaded,
                                    "point_slots": seen[0],
                                    "colored_points": int(ret["counts"][2])}
    assert 0 < int(ret["counts"][2]) <= seen[0]


def test_no_profiler_no_span_no_count(scene, tmp_path, monkeypatch):
    render, host = scene
    _, _, img = _request(render, host)  # warm

    (_, _, traced_img), _ = _profiled(lambda: _request(render, host), tmp_path)
    profiling.reset_counters()

    class Refused:
        def __init__(self, *a, **k):
            raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", Refused)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Refused)
    assert not profiling.recording()
    _, _, plain_img = _request(render, host)
    profiling.count("renders", 1)
    assert profiling.counters() == {}
    assert np.array_equal(plain_img, traced_img) and np.array_equal(plain_img, img)


# --- the readers, on hand-built Chrome-trace events ---------------------

def _x(name, ts, dur, cat="user_annotation", **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def _launch(ts, corr, kernel_ts, kernel_dur):
    return [_x("cudaLaunchKernel", ts, 1, cat="cuda_runtime", correlation=corr),
            _x(f"kernel_{corr}", kernel_ts, kernel_dur, cat="kernel", correlation=corr)]


def _view_events(n=2):
    """`n` requests of 1,000 µs each from t = 1,000: upload 100 µs; render
    (800 µs) = encoder (100, one kernel of 50 in bench.encoder) + frame
    stage (200, kernels of 30 and 40) + ray pipeline (300, a kernel of 20,
    and in its point stages (100) one of 60) + assemble (100, a kernel of
    10); download 50. The device is busy 210 µs of each render."""
    ev = [_x("bench.window", 0, 1000 * (n + 2))]
    corr = 0
    for i in range(n):
        t = 1000 * (i + 1)
        ev += [_x("bench.request", t, 1000), _x("gpnerf.upload", t, 100),
               _x("gpnerf.render", t + 100, 800), _x("gpnerf.encoder", t + 100, 100),
               _x("bench.encoder", t + 110, 80), _x("gpnerf.frame_stage", t + 200, 200),
               _x("gpnerf.ray_pipeline", t + 400, 300), _x("gpnerf.point_stages", t + 500, 100),
               _x("gpnerf.assemble", t + 700, 100), _x("gpnerf.download", t + 900, 50)]
        for at, kt, dur in ((t + 120, t + 120, 50), (t + 210, t + 220, 30),
                            (t + 250, t + 260, 40), (t + 410, t + 420, 20),
                            (t + 510, t + 520, 60), (t + 710, t + 720, 10)):
            corr += 1
            ev += _launch(at, corr, kt, dur)
    return ev


def _train_events(n=2):
    """`n` steps of 1,000 µs: forward 300, loss 50, backward 400,
    optimizer 150."""
    ev = [_x("bench.window", 0, 1000 * (n + 2))]
    for i in range(n):
        t = 1000 * (i + 1)
        ev += [_x("bench.step", t, 1000), _x("gpnerf.train.forward", t, 300),
               _x("gpnerf.train.loss", t + 300, 50), _x("gpnerf.train.backward", t + 350, 400),
               _x("gpnerf.train.optimizer", t + 750, 150)]
    return ev


def _count(monkeypatch, **values):
    """The program's counters as a profiled window would leave them."""
    with monkeypatch.context() as m:
        m.setattr(profiling, "recording", lambda: True)
        for k, v in values.items():
            profiling.count(k, v)


VIEW_EXPECTED = {
    "upload_ms.render": 0.1,
    "upload_mb_per_frame": 3.0,
    "frame_stage_ms.render": 0.07,
    "ray_pipeline_ms.render": 0.03,
    "point_stages_ms.render": 0.06,
    "colored_point_share": 25.0,
    "fetched_slot_share": 75.0,
    "render_idle_ms.render": 0.8 - 0.21,
}
TRAIN_EXPECTED = {"forward_ms.train": 0.3, "backward_ms.train": 0.4,
                  "optimizer_ms.train": 0.15}


@pytest.mark.parametrize("name", sorted(VIEW_EXPECTED))
def test_view_reader_on_a_hand_built_trace(name, monkeypatch):
    _count(monkeypatch, renders=2, upload_bytes=6_000_000, point_slots=800,
           colored_points=torch.tensor(200), kernel_fetched_slots=600)
    ctx = Context(trace=Trace(_view_events(), "bench.request"))
    assert reader(name)(ctx) == pytest.approx(VIEW_EXPECTED[name])
    # a program without the spans, or without the counters: nothing read,
    # nothing raised
    bare = [e for e in _view_events() if not e["name"].startswith("gpnerf.")]
    assert reader(name)(Context(trace=Trace(bare, "bench.request"))) is None
    profiling.reset_counters()
    assert reader(name)(ctx) is None


@pytest.mark.parametrize("name", sorted(VIEW_EXPECTED))
def test_view_reader_refuses_a_render_count_unlike_the_requests(name, monkeypatch):
    _count(monkeypatch, renders=3, upload_bytes=6_000_000, point_slots=800,
           colored_points=200, kernel_fetched_slots=800)
    assert reader(name)(Context(trace=Trace(_view_events(), "bench.request"))) is None


@pytest.mark.parametrize("name", sorted(TRAIN_EXPECTED))
def test_train_reader_on_a_hand_built_trace(name):
    ctx = Context(trace=Trace(_train_events(), "bench.step"))
    assert reader(name)(ctx) == pytest.approx(TRAIN_EXPECTED[name])
    bare = [e for e in _train_events() if not e["name"].startswith("gpnerf.")]
    assert reader(name)(Context(trace=Trace(bare, "bench.step"))) is None


def test_span_helpers_on_a_hand_built_trace():
    tr = Trace(_view_events(), "bench.request")
    assert spans.host_ms(tr, "gpnerf.render") == pytest.approx(1.6)
    # the render's own host time: 800 less the four stages' 700, twice
    assert spans.self_ms(tr, "gpnerf.render") == pytest.approx(0.2)
    assert spans.self_ms(tr, "gpnerf.ray_pipeline") == pytest.approx(0.4)
    # the encoder's kernel belongs to the innermost span, bench.encoder
    assert spans.device_ms(tr, "gpnerf.encoder") == 0.0
    assert spans.device_ms(tr, "bench.encoder") == pytest.approx(0.1)
    assert spans.idle_ms(tr, "gpnerf.upload") == pytest.approx(0.2)
    assert spans.device_ms(tr, "gpnerf.nothing") is None
    assert spans.idle_ms(tr, "gpnerf.nothing") is None


def test_every_new_metric_is_declared():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        per_layer = {m["name"]: m for m in json.load(f)["per_layer"]}
    for name in VIEW_EXPECTED:
        assert per_layer[name]["workloads"] == ["zju-fast-views", "zju-paper-views"]
        assert per_layer[name]["moves"] == "frames_per_s"
    for name in TRAIN_EXPECTED:
        assert per_layer[name]["workloads"] == ["zju-train-1024"]
        assert per_layer[name]["moves"] == "train_step_ms"
