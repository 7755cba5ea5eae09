"""tools/inference_torch.py, the port's evaluation CLI, on the CPU in a
subprocess, as a user calls it: `--cfg` plus dotted overrides, the
progressive renderer, FrameSampler, a checkpoint in the reference's .pth
layout. On the synthetic fixture with the small training config of the
README (tiny encoder, 128^2) and on the fabricated ZJU-MoCap tree of
tests/test_dataset_fixtures.py (the pattern of tests/test_real_data_drill.py,
which runs the JAX CLI): each run exits 0 and prints the metric means and
the render time; `test.is_vis` writes the frames' images. Without a CUDA
device and without `device cpu` the CLI fails, naming the way out."""

import ast
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


def test_synthetic_compacted(tmp_path):
    """`tpu.dense_slots False` on the command line with the trained
    checkpoint at 128^2: the global sigma compaction, at a sigma_cap of one
    point per ray, which the frames' valid slots overflow; the overflow
    line's sigma column counts the dropped slots."""
    out = run_cli(tmp_path, "--cfg", os.path.join(ROOT, "configs", "synthetic.yaml"), *SMALL[4:],
                  "head.sigma.code_dim", "32", "dataset.H", "128", "dataset.W", "128",
                  "tpu.ray_cap", "16384", "tpu.dense_slots", "False", "tpu.sigma_cap", "16384",
                  "render.resume_path", os.path.join(ROOT, "artifacts", "bench_ckpt.pth"),
                  "result_dir", str(tmp_path / "results"))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert 0 < _metric(out.stdout, "psnr") < 60
    line = [s for s in out.stdout.splitlines() if s.startswith("overflows(ray,perrayK,sigma,rgb)")][-1]
    ray, _, sigma, rgb = ast.literal_eval(line.split("max=")[1].split(" mean=")[0])
    assert ray == 0 and sigma > 0 and rgb == 0, line


def test_synthetic_mesh_branch(tmp_path, ckpt):
    """`head.rgb.use_rgbhead False` (the mesh branch): the renderer builds,
    every frame renders, and the CLI prints the timing lines but no metric
    means, as the JAX package's Trainer.evaluate does (trainer.py:373)."""
    out = run_cli(tmp_path, "--cfg", os.path.join(ROOT, "configs", "synthetic.yaml"), *SMALL,
                  "dataset.H", "128", "dataset.W", "128", "tpu.ray_cap", "16384",
                  "head.rgb.use_rgbhead", "False", "render.resume_path", ckpt,
                  "result_dir", str(tmp_path / "results"))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "avg total render time (encoder excluded)" in out.stdout
    assert "avg encoder time" in out.stdout
    assert not any(s.startswith(("mse: ", "psnr: ", "ssim: ")) for s in out.stdout.splitlines())


@pytest.mark.parametrize("config,tables", [
    pytest.param("trainzju_valzju.yaml", ["tpu.merge_lowres_src", "True"],
                 id="trainzju_valzju.yaml"),
    pytest.param("trainthu_valzju.yaml", ["tpu.merge_lowres_src", "True"],
                 id="trainthu_valzju.yaml"),
    pytest.param("trainzju_valzju.yaml", [], id="trainzju_valzju.yaml-paper-tables"),
])
def test_zjumocap_tree(tmp_path, ckpt, zju_root, config, tables):
    """The published evaluation command's shape (README) on the fabricated
    ZJU tree at ratio 0.125 (1024 -> 128), for both paper configs (both
    validate on ZJU-MoCap): in the fast mode's merged table
    (`tpu.merge_lowres_src True`), and with the config's own `tpu` section
    unchanged, whose default is split projection tables under the tight
    cull."""
    out = run_cli(tmp_path, "--cfg", os.path.join(ROOT, "configs", config),
                  *SMALL, "render.resume_path", ckpt, "dataset.test.shuffle", "False",
                  "dataset.test.data_root", zju_root, "dataset.test.seq_list",
                  "['CoreView_387']", "test.test_seq", "CoreView_387", "dataset.ratio", "0.125",
                  "tpu.ray_cap", "8192", *tables, "test.is_vis", "True",
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


def _script_dir(tmp_path):
    """A working directory with the repository's `tools` and `configs`, so
    that a root script's relative paths resolve and its outputs stay here."""
    for d in ("tools", "configs"):
        os.symlink(os.path.join(ROOT, d), tmp_path / d)
    return dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)


def test_test_torch_sh_on_zjumocap_tree(tmp_path, ckpt, zju_root):
    """test_torch.sh, test.sh's command with the port's CLI, on the
    fabricated ZJU tree at the small size: exit 0, the metric means, and
    the images `test.is_vis` asks for."""
    out = subprocess.run(
        ["bash", os.path.join(ROOT, "test_torch.sh"), ckpt, *SMALL, "dataset.test.data_root",
         zju_root, "dataset.test.seq_list", "['CoreView_387']", "test.test_seq", "CoreView_387",
         "dataset.ratio", "0.125", "tpu.ray_cap", "8192", "tpu.merge_lowres_src", "True",
         "result_dir", str(tmp_path / "results")],
        cwd=tmp_path, env=_script_dir(tmp_path), capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert 0 < _metric(out.stdout, "psnr") < 60
    assert {"0.jpg", "3.jpg", "metrics.npy"} <= set(os.listdir(tmp_path / "results" / "CoreView_387"))


def test_train_torch_sh_on_zjumocap_tree(tmp_path, zju_root):
    """train_torch.sh, train.sh's command with the port's CLI, on the
    fabricated ZJU tree at the small size: two steps, exit 0."""
    out = subprocess.run(
        ["bash", os.path.join(ROOT, "train_torch.sh"), "device", "cpu", "workers", "0",
         "encoder.name", "tiny", "head.sigma.code_dim", "16", "train.n_rays", "256",
         "train.n_samples", "8", "tpu.eval_ray_cap", "4096", "tpu.eval_chunk", "1024",
         "dataset.ratio", "0.125", "dataset.train.data_root", zju_root, "dataset.test.data_root",
         zju_root, "dataset.train.seq_list", "['CoreView_387']", "dataset.test.seq_list",
         "['CoreView_387']", "train.ep_iter", "2", "train.max_epoch", "0",
         "train.val_when_train", "False"],
        cwd=tmp_path, env=_script_dir(tmp_path), capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert os.path.isdir(tmp_path / "logs")
