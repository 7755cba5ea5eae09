"""tools/inference_torch.py, the port's evaluation CLI, on the CPU in a
subprocess, as a user calls it: `--cfg` plus dotted overrides, the
progressive renderer, FrameSampler, a checkpoint in the reference's .pth
layout. On the synthetic fixture with the small training config of the
README (tiny encoder, 128^2) and on the fabricated ZJU-MoCap tree of
tests/test_dataset_fixtures.py (the pattern of tests/test_real_data_drill.py,
which runs the JAX CLI): each run exits 0 and prints the metric means and
the render time; `test.is_vis` writes the frames' images. Without a CUDA
device and without `device cpu` the CLI fails, naming the way out."""

import os
import subprocess
import sys

import pytest

from gpnerf_tpu_torch.config import cfg as port_cfg
from gpnerf_tpu_torch.render.base import build_render
from gpnerf_tpu_torch.train.checkpoint import save_checkpoint

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CLI = os.path.join(ROOT, "tools", "inference_torch.py")
SMALL = ["encoder.name", "tiny", "head.sigma.code_dim", "16", "device", "cpu", "workers", "0",
         "render.file", "demo_render", "dataset.test.sampler", "FrameSampler",
         "tpu.eval_ray_cap", "4096", "tpu.eval_chunk", "1024"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """Seeded fresh parameters of the small config, in the reference's
    checkpoint layout."""
    cfg = port_cfg.clone()
    cfg.defrost()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "synthetic.yaml"))
    cfg.merge_from_list(SMALL[:4])
    cfg.freeze()
    render = build_render(cfg, device="cpu").init_variables(0)
    out = tmp_path_factory.mktemp("ckpt")
    save_checkpoint({"epoch": 0, "model": "demo_render", "performance/psnr": 0.0,
                     "state_dict": render.state_dict()}, False, str(out), "small.pth")
    return str(out / "small.pth")


def run_cli(cwd, *args, env=None):
    """The CLI with few torch threads (the test files run in parallel)."""
    env = dict(os.environ, OMP_NUM_THREADS="2", **(env or {}))
    return subprocess.run([sys.executable, CLI, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=600)


def _metric(stdout, key):
    line = [s for s in stdout.splitlines() if s.startswith(f"{key}: ")][-1]
    return float(line.split(": ")[1])


def test_synthetic_small(tmp_path, ckpt):
    out = run_cli(tmp_path, "--cfg", os.path.join(ROOT, "configs", "synthetic.yaml"), *SMALL,
                  "dataset.H", "128", "dataset.W", "128", "tpu.ray_cap", "16384",
                  "render.resume_path", ckpt, "test.is_vis", "True",
                  "result_dir", str(tmp_path / "results"))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    # FrameSampler: frame 0 of the 30, at both test cams
    assert 0 < _metric(out.stdout, "psnr") < 60 and 0 <= _metric(out.stdout, "ssim") <= 1
    assert "overflows(ray,perrayK,sigma,rgb): max=[0," in out.stdout
    assert "avg total render time (encoder excluded)" in out.stdout
    res = tmp_path / "results" / "synthetic"
    assert {"0.jpg", "1.jpg", "metrics.npy"} <= set(os.listdir(res))
    assert os.path.isdir(tmp_path / "work_dirs")


@pytest.mark.parametrize("config", ["trainzju_valzju.yaml", "trainthu_valzju.yaml"])
def test_zjumocap_tree(tmp_path, ckpt, zju_root, config):
    """The published evaluation command's shape (README) on the fabricated
    ZJU tree at ratio 0.125 (1024 -> 128), for both paper configs (both
    validate on ZJU-MoCap), in the port's fast mode: the configs' own
    default of split projection tables under the tight cull
    (`tpu.merge_lowres_src False`) is a switch the port still refuses."""
    out = run_cli(tmp_path, "--cfg", os.path.join(ROOT, "configs", config),
                  *SMALL, "render.resume_path", ckpt, "dataset.test.shuffle", "False",
                  "dataset.test.data_root", zju_root, "dataset.test.seq_list",
                  "['CoreView_387']", "test.test_seq", "CoreView_387", "dataset.ratio", "0.125",
                  "tpu.ray_cap", "8192", "tpu.merge_lowres_src", "True", "test.is_vis", "True",
                  "test.save_imgs", "True", "result_dir", str(tmp_path / "results"))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert 0 < _metric(out.stdout, "psnr") < 60
    res = tmp_path / "results" / "CoreView_387"
    # frame 0 at each of the four test cams, and the per-frame gt | pred pairs
    assert {"0.jpg", "3.jpg", "metrics.npy", "0_cam0.jpg"} <= set(os.listdir(res))


def test_needs_a_card_or_device_cpu(tmp_path):
    args = [a for a in SMALL if a not in ("device", "cpu")]
    # no card visible, on any machine
    out = run_cli(tmp_path, "--cfg", os.path.join(ROOT, "configs", "synthetic.yaml"), *args,
                  env={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "device cpu" in out.stderr
    assert "psnr" not in out.stdout
