"""What a configuration names: the program each loop runs (a `render`
builder of the port's registry) and the reference that checks it.

GP-NeRF's two configurations name neither and get the builders and the
reference they always ran. A stub architecture, written here as new files
and entries only (a configuration, a BENCHMARK.json with one more cell, a
registered renderer with no encoder, its checkpoint, and a reference
module on `sys.path`), runs through the harness on the CPU: correct with
either trace setting, not correct against a reference whose image is off
by more than the limit, and refused with the key's name where its program
is not registered. The encoder's reader reads the program's own span, not
a hook on the model."""

import contextlib
import copy
import hashlib
import io
import json
import os
import sys

import pytest
import torch
from torch import nn

from benchmark import system
from benchmark.harness import Context, main, reader
from benchmark.trace import Trace

from conftest import ROOT, SEED, small

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CONFS = {c["name"]: json.load(open(os.path.join(ROOT, c["file"]))) for c in BENCH["configs"]}
STUB = "BenchStubRender"
CELL = "stub-views"
# the per-layer metrics the stub cell reports: encoder_ms.render finds no
# `gpnerf.encoder` span there and is left out of the line
STUB_METRICS = ("launches_per_frame", "device_idle_share.render", "encoder_ms.render")

REFERENCE = '''
import torch

from benchmark import pool
from benchmark.reference.build import check_weights
from benchmark.reference.eager.data.base import HumanNVSDataset
from benchmark.reference.eager.render.base import batch_to_device

OFFSET = {offset!r}


def render_items(conf, scene, poses, cams, seed, items, device, control=False):
    ds = pool.make_dataset(HumanNVSDataset, scene, poses, cams, "test", conf["cfg"])
    mix = torch.load(check_weights(conf["weights"]))["mix"].to(device)
    out = {{}}
    for i in items:
        src = batch_to_device(pool.build_batches(ds, seed, [i], pool.VIEW_TAG)[0],
                              device)["src_imgs"]
        image = (src.float().mean(0) / 255) @ mix.T + OFFSET
        out[i] = {{"image": image.cpu().numpy()}}
    return out
'''


class StubRender(nn.Module):
    """A renderer of another architecture: a color mix of the mean source
    image, with no encoder; its image comes out as `pred_chw`."""

    def __init__(self):
        super().__init__()
        self.mix = nn.Parameter(torch.zeros(3, 3))

    def render_demo_fn(self):
        return self.render_demo

    @torch.no_grad()
    def render_demo(self, batch):
        image = (batch["src_imgs"].float().mean(0) / 255) @ self.mix.T
        return {"pred_chw": image.permute(2, 0, 1)}


def build_stub(cfg, device=None):
    return StubRender().to(device)


@pytest.fixture
def stub_root(tmp_path, monkeypatch):
    """A checkout root whose BENCHMARK.json adds the stub's configuration
    and cell; returns a function that writes its configuration file."""
    from gpnerf_tpu_torch import registry

    ckpt = tmp_path / "stub-arch.pt"
    torch.save({"mix": torch.rand((3, 3), generator=torch.Generator().manual_seed(SEED)) / 3},
               ckpt)
    weights = {"file": str(ckpt), "sha256": hashlib.sha256(ckpt.read_bytes()).hexdigest()}
    (tmp_path / "bench_stub_reference.py").write_text(REFERENCE.format(offset=0.0))
    (tmp_path / "bench_stub_reference_off.py").write_text(REFERENCE.format(offset=0.01))
    monkeypatch.syspath_prepend(str(tmp_path))
    for name in ("bench_stub_reference", "bench_stub_reference_off"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setitem(registry._REGISTRY.setdefault("render", {}), STUB, build_stub)

    bench = copy.deepcopy(BENCH)
    bench["configs"].append({"name": "stub-arch", "source": "https://example.org/stub",
                             "file": "benchmark/configs/stub-arch.json", "reduced": [],
                             "why": "a second architecture"})
    bench["workloads"].append({"name": CELL, "config": "stub-arch", "traffic": "views",
                               "chips": 1, "why": "the stub's views"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("frames_per_s",) + STUB_METRICS:
            m["workloads"].append(CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "benchmark" / "configs").mkdir(parents=True)

    def write(**keys):
        conf = dict(copy.deepcopy(CONFS["gpnerf-zju-fast"]), name="stub-arch",
                    program={"views": STUB}, reference="bench_stub_reference",
                    weights=weights)
        conf.update(keys)
        (tmp_path / "benchmark" / "configs" / "stub-arch.json").write_text(json.dumps(conf))
        return tmp_path

    return write


def run_stub(root, trace=0):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["--workload", CELL, "--seed", str(SEED), "--seconds", "1",
                   "--trace", str(trace)], need_cuda=False, overrides=small, root=str(root))
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("conf", sorted(CONFS))
def test_gpnerf_configurations_resolve_as_before(conf):
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render import base, demo
    from gpnerf_tpu_torch.train import criterion

    c = CONFS[conf]
    assert "program" not in c and "reference" not in c
    assert system.builder(c, "views") is demo.build_render
    assert system.builder(c, "train_steps") is base.build_render
    assert system.reference(c).__name__ == "benchmark.reference.tasks"
    cfg = system.port_cfg(c, torch.device("cpu"))
    assert get("criterion", cfg.train.criterion_file) is criterion.build_criterion


@pytest.mark.parametrize("trace", [0, 1])
def test_stub_architecture_is_correct(stub_root, trace):
    rc, line = run_stub(stub_root(), trace)
    assert rc == 0 and line["correct"] is True, line["check"]
    assert line["check"]["image_rmse"]["value"] == 0.0
    if trace:
        assert set(line["metrics"]) == {"launches_per_frame", "device_idle_share.render"}
    else:
        assert set(line["metrics"]) == {"frames_per_s", "setup_s"}


def test_stub_against_an_image_off_by_more_than_the_limit(stub_root):
    rc, line = run_stub(stub_root(reference="bench_stub_reference_off"))
    assert rc == 0 and line["correct"] is False
    rmse = line["check"]["image_rmse"]
    assert rmse["value"] == pytest.approx(0.01) and rmse["value"] > rmse["limit"]


def test_unregistered_program_is_refused(stub_root):
    with pytest.raises(SystemExit, match=r"'stub-arch': program.views is 'NoSuchRender'"):
        run_stub(stub_root(program={"views": "NoSuchRender"}))


def _x(name, ts, dur, cat="user_annotation", **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def test_encoder_reader_reads_the_program_span(monkeypatch):
    """Two requests; in each, `gpnerf.encoder` launches kernels of 50 and
    30 us, and the frame stage one of 40 us."""
    from gpnerf_tpu_torch.utils import profiling

    ev = [_x("bench.window", 0, 4000)]
    for i, t in enumerate((1000, 2000)):
        ev += [_x("bench.request", t, 1000), _x("gpnerf.render", t + 100, 800),
               _x("gpnerf.encoder", t + 100, 100), _x("gpnerf.frame_stage", t + 200, 200)]
        for k, (at, dur) in enumerate(((t + 110, 50), (t + 150, 30), (t + 210, 40))):
            corr = 10 * i + k
            ev += [_x("cudaLaunchKernel", at, 1, cat="cuda_runtime", correlation=corr),
                   _x(f"kernel_{corr}", at + 5, dur, cat="kernel", correlation=corr)]
    with monkeypatch.context() as m:
        m.setattr(profiling, "recording", lambda: True)
        profiling.count("renders", 2)
    try:
        read = reader("encoder_ms.render")
        assert read(Context(trace=Trace(ev, "bench.request"))) == pytest.approx(0.08)
        bare = [e for e in ev if e["name"] != "gpnerf.encoder"]
        assert read(Context(trace=Trace(bare, "bench.request"))) is None
    finally:
        profiling.reset_counters()


def test_half_batch_cuts_a_criterion_of_any_class(monkeypatch):
    """The half-batch fault wraps whatever criterion the train step built:
    here one of no class of the port's."""
    from benchmark import calibrate

    seen = []

    def other(ret, batch, is_train=True):
        seen.append(batch["ray_valid"])
        return {"loss": ret}

    monkeypatch.setattr(system.TrainStep, "__init__",
                        lambda self, conf, device: setattr(self, "criterion", other))
    valid = torch.ones(6, dtype=torch.uint8)
    with calibrate.half_batch():
        step = system.TrainStep(None, None)
    assert step.criterion(1.0, {"ray_valid": valid}) == {"loss": 1.0}
    assert seen[0].tolist() == [1, 1, 1, 0, 0, 0] and valid.tolist() == [1] * 6
    assert system.TrainStep(None, None).criterion is other
