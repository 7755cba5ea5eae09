"""The port's quality and profiling tools against the JAX package's:
`gpnerf_tpu_torch/utils/bench_frames.py` (the bench frame protocol and its
disk cache), `utils/profiling.py` and `tools/quality_sweep_torch.py`'s
`sweep`, at 128^2 on the CPU.

bench_frames: with `n_frames=None` both packages walk the full test set in
the same order with the same per-item seeds (a registered stand-in dataset
records the indices and one draw of each RNG per item, so nothing is
rendered); the first 2 host batches of the synthetic test set equal JAX's,
integers bitwise and floats exactly; a second call reads the cache and
returns the same batches; the port's cache directory is its own.

The sweep over 2 items with the trained checkpoint: every key of the JAX
tool's lines, and each frame's PSNR and SSIM equal to those the Evaluator
takes in `Trainer.evaluate` of the same frames, and the means its means."""

import io
import json
import os
import random
import sys

import numpy as np
import pytest
import torch

import gpnerf_tpu.registry as jax_registry
import gpnerf_tpu.utils.bench_frames as jax_bench_frames
import gpnerf_tpu_torch.registry as port_registry
from gpnerf_tpu.config import cfg as jax_cfg
from gpnerf_tpu_torch.config import cfg as port_cfg
from gpnerf_tpu_torch.registry import get as port_get
from gpnerf_tpu_torch.train.checkpoint import load_eval_model
from gpnerf_tpu_torch.utils import bench_frames, profiling
from test_torch_datasets import same_host_kernels  # noqa: F401  (autouse: host-kernel route)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "artifacts", "bench_ckpt.pth")
sys.path.insert(0, os.path.join(ROOT, "tools"))

import quality_sweep_torch  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Whole-frame renders under parallel test files (tests/test_torch_opbyop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(base, dataset_file=None, ray_cap=None, **extra):
    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "synthetic.yaml"))
    cfg.dataset.H = 128
    cfg.dataset.W = 128
    cfg.head.sigma.code_dim = 32
    cfg.render.file = "demo_render"
    if dataset_file:
        cfg.dataset.test.file = dataset_file
    if ray_cap:
        cfg.tpu.ray_cap = ray_cap
    for k, v in extra.items():
        setattr(cfg, k, v)
    cfg.freeze()
    return cfg


class _Recorder:
    """A test set of 7 items whose item is its index and one draw of each
    RNG the protocol seeds."""

    def __init__(self, cfg, is_train=False):
        pass

    def __len__(self):
        return 7

    def __getitem__(self, i):
        return {"i": i, "random": random.random(), "np": float(np.random.rand())}


@pytest.fixture(scope="module")
def recorder():
    jax_registry.register("dataset", "_bench_frames_recorder", _Recorder)
    port_registry.register("dataset", "_bench_frames_recorder", _Recorder)
    return "_bench_frames_recorder"


@pytest.mark.parametrize("n_frames", [None, 3, 7])
def test_bench_protocol_indices_and_seeds(tmp_path, recorder, n_frames):
    """n_frames=None: the full set, stride 1, seed = index; else the
    stride over the set. Same items and draws as JAX's, in order."""
    port = bench_frames.get_bench_frames(_cfg(port_cfg, recorder), n_frames,
                                         cache_root=str(tmp_path / "port"), verbose=False)
    ref = jax_bench_frames.get_bench_frames(_cfg(jax_cfg, recorder), n_frames,
                                            cache_root=str(tmp_path / "jax"), verbose=False)
    assert port == ref
    want = list(range(7)) if n_frames is None else [i * (7 // n_frames) for i in range(n_frames)]
    assert [f["i"] for f in port] == want


@pytest.fixture(scope="module")
def synthetic_frames(tmp_path_factory):
    root = tmp_path_factory.mktemp("frame_cache")
    port = bench_frames.get_bench_frames(_cfg(port_cfg), 2, cache_root=str(root / "port"),
                                         verbose=False)
    ref = jax_bench_frames.get_bench_frames(_cfg(jax_cfg), 2, cache_root=str(root / "jax"),
                                            verbose=False)
    return port, ref, root


def _assert_batches_equal(a, b):
    assert len(a) == len(b)
    for fa, fb in zip(a, b):
        assert set(fa) == set(fb)
        for k in fa:
            x, y = np.asarray(fa[k]), np.asarray(fb[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, err_msg=k)


def test_bench_frames_equal_jax(synthetic_frames):
    """The first 2 bench frames of the 128^2 synthetic test set: every
    array equal to JAX's (integers bitwise, floats exactly)."""
    port, ref, _ = synthetic_frames
    _assert_batches_equal(port, ref)


def test_bench_frames_cache(synthetic_frames, capsys):
    """The first call wrote one pickle; the second reads it (its message
    says so) and returns the same batches; the default directory is the
    port's own, not the JAX package's."""
    port, _, root = synthetic_frames
    files = os.listdir(root / "port")
    assert len(files) == 1 and files[0].startswith("frames_") and files[0].endswith(".pkl")
    again = bench_frames.get_bench_frames(_cfg(port_cfg), 2, cache_root=str(root / "port"))
    assert "frame cache hit" in capsys.readouterr().err
    _assert_batches_equal(again, port)
    assert os.path.basename(bench_frames.CACHE_ROOT) == "frame_cache_torch"
    jax_root = os.path.join(os.path.dirname(jax_bench_frames.__file__), "..", "..", "artifacts",
                            "frame_cache")
    assert os.path.realpath(bench_frames.CACHE_ROOT) != os.path.realpath(jax_root)


def test_trace_writes_a_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(32, 32).sum()
    assert prof is not None
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "tr" / files[0]) as f:
        assert "traceEvents" in json.load(f)


def test_device_memory_stats_cpu():
    assert profiling.device_memory_stats("cpu") == {}
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}


@pytest.fixture(scope="module")
def sweep_run(synthetic_frames, tmp_path_factory):
    frames = synthetic_frames[0]
    # the bench frames hold 4,982 and 8,284 rays at 128^2: a ray cap of 12288
    # drops none, and the CPU's point stages run over K x ray_cap points
    cfg = _cfg(port_cfg, ray_cap=12288, result_dir=str(tmp_path_factory.mktemp("results")))
    render = port_get("render", cfg.render.file)(cfg, device="cpu")
    load_eval_model(CKPT, render)
    out = io.StringIO()
    rows, summary = quality_sweep_torch.sweep(cfg, render, frames, torch.device("cpu"),
                                              overrides=["tpu.tap_window", "32"], out=out)
    return cfg, render, frames, rows, summary, out.getvalue().splitlines()


def test_sweep_lines_have_every_key(sweep_run):
    _, _, frames, rows, summary, lines = sweep_run
    assert len(lines) == len(frames) + 1
    parsed = [json.loads(line) for line in lines]
    assert parsed[:-1] == rows and parsed[-1] == summary
    for i, r in enumerate(rows):
        assert set(r) == {"i", "psnr", "ssim", "overflows", "counts"} and r["i"] == i
        assert len(r["overflows"]) == 4 and len(r["counts"]) == 3 and r["overflows"][0] == 0
        # the checkpoint was trained at 512^2: at 128^2 it reads 11-14 dB
        assert np.isfinite(r["psnr"]) and 0.0 < r["ssim"] <= 1.0
    assert set(summary) == {"n", "psnr_mean", "ssim_mean", "psnr_min", "max_overflows",
                            "wall_s", "overrides"}
    assert summary["n"] == len(frames) and summary["overrides"] == ["tpu.tap_window", "32"]
    assert summary["psnr_min"] == min(r["psnr"] for r in rows)
    assert summary["max_overflows"] == np.max([r["overflows"] for r in rows], axis=0).tolist()


def test_sweep_frames_equal_trainer_evaluate(sweep_run, tmp_path, monkeypatch):
    """Each row's PSNR and SSIM are, rounded, those `Trainer.evaluate`'s
    Evaluator takes of its own render of the same frame; the summary's
    means are its means, its max overflows the rows' max."""
    from gpnerf_tpu_torch.train import trainer as trainer_mod

    cfg, render, frames, rows, summary, _ = sweep_run
    seen = {}
    summarize = trainer_mod.Evaluator.summarize

    def record(ev):
        seen.update(psnr=list(ev.psnr), ssim=list(ev.ssim))
        return summarize(ev)

    monkeypatch.setattr(trainer_mod.Evaluator, "summarize", record)
    trainer = port_get("trainer", cfg.train.file)(cfg, render=render,
                                                  performance_indicator=cfg.pi)
    metrics, _ = trainer.evaluate(frames, str(tmp_path))
    assert [r["psnr"] for r in rows] == [round(float(v), 4) for v in seen["psnr"]]
    assert [r["ssim"] for r in rows] == [round(float(v), 5) for v in seen["ssim"]]
    assert summary["psnr_mean"] == round(metrics["psnr"], 4)
    assert summary["ssim_mean"] == round(metrics["ssim"], 5)
    assert summary["max_overflows"] == metrics["overflows_max"]
