"""The port's op-by-op point stages (tpu.pallas_point off) against the
port's own fused render and against each other, on the 128^2 synthetic frame
with the trained checkpoint, on the CPU: the routes of the merged table,
int4_feat off the fused path, and the fused path's trilinear cull with
kernel_octet off. tests/test_torch_opbyop.py holds the same renders against
the JAX package."""

import os
import random

import numpy as np
import pytest
import torch

from gpnerf_tpu_torch.config import cfg as port_cfg
from gpnerf_tpu_torch.registry import get as port_get
from gpnerf_tpu_torch.render.base import batch_to_device
from gpnerf_tpu_torch.train.checkpoint import load_eval_model

CKPT = os.path.join(os.path.dirname(__file__), "..", "artifacts", "bench_ckpt.pth")
H = W = 128
MODES = {
    # the capacities of tests/test_torch_demo.py and tests/test_torch_refmode.py
    "fast": dict(ray_cap=16384, sigma_cap=262144, rgb_cap=131072),
    "reference": dict(tight_cull=False, samples_per_ray=64, tap_window=0,
                      merge_lowres_src=False, ray_cap=9216, sigma_cap=1048576,
                      rgb_cap=262144),
}


def _cfg(dtype, mode, **tpu):
    cfg = port_cfg.clone()
    cfg.defrost()
    cfg.merge_from_file("configs/synthetic.yaml")
    cfg.dataset.H = H
    cfg.dataset.W = W
    cfg.head.sigma.code_dim = 32
    cfg.render.file = "demo_render"
    cfg.dataset.test.sampler = "FrameSampler"
    cfg.tpu.matmul_dtype = dtype
    cfg.tpu.eval_ray_cap = 16384
    cfg.tpu.eval_chunk = 4096
    for k, v in {**MODES[mode], **tpu}.items():
        cfg.tpu[k] = v
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """These tests launch thousands of small torch ops; with the test files
    run in parallel, every process spinning up a thread per core for each op
    costs far more than the threads save."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_renders():
    """(dtype, mode, switches) -> the port's render of one frame on the CPU
    (the port's own data copy builds the frame the JAX package builds:
    tests/test_torch_demo.py)."""
    cfg = _cfg("float32", "fast")
    np.random.seed(0)
    random.seed(0)
    batch = port_get("dataset", cfg.dataset.test.file)(cfg, is_train=False)[0]
    cache = {}

    def get(dtype, mode, **tpu):
        key = (dtype, mode, tuple(sorted(tpu.items())))
        if key not in cache:
            port = port_get("render", "demo_render")(_cfg(dtype, mode, **tpu), device="cpu")
            load_eval_model(CKPT, port)
            ret = port.render_demo_fn()(batch_to_device(batch, "cpu"))
            cache[key] = {k: v.numpy() for k, v in ret.items()}
        return cache[key]

    return get


def _image_stats(a, b, mask):
    d = np.abs(a["pred_chw"] - b["pred_chw"])
    dm = d[:, mask]
    return np.median(dm), np.percentile(dm, 99.9), d[:, 1:].max(), d[:, 0].max()


@pytest.mark.parametrize("dtype,mode", [("float32", "fast"), ("float32", "reference"),
                                        ("bfloat16", "fast")])
def test_opbyop_matches_port_fused(port_renders, dtype, mode):
    """Against the port's fused point stages (plain version of the kernel:
    bf16 dot inputs, float32 accumulation and activations)."""
    op = port_renders(dtype, mode, pallas_point=False)
    fused = port_renders(dtype, mode)
    for k in ("mask_at_box", "ray_pix_idx", "overflows"):
        np.testing.assert_array_equal(op[k], fused[k], err_msg=k)
    np.testing.assert_array_equal(op["counts"][:2], fused["counts"][:2])
    assert abs(int(op["counts"][2]) - int(fused["counts"][2])) <= 2e-3 * int(fused["counts"][2])
    m = op["mask_at_box"].reshape(H, W)
    got = _image_stats(op, fused, m)
    # measured median 4.6e-4 / 4.1e-4 / 7.7e-4, 99.9th percentile 2.9e-3 /
    # 7.6e-3 / 5.1e-3, max 3.9e-3 / 1.4e-2 / 6.4e-3
    assert 0 < got[0] < 2e-3 and got[1] < 0.015 and max(got[2:]) < 0.05, got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merged_table_routes(port_renders, dtype):
    """pallas_lerp (kernel route, float32 accumulation), the (P, V) gather
    and proj_vp_order: the two torch-op routes give the same image; the
    kernel route equals them in float32 and sits a bf16 accumulation away in
    the bf16 configuration."""
    kern = port_renders(dtype, "fast", pallas_point=False)
    pv = port_renders(dtype, "fast", pallas_point=False, pallas_lerp=False)
    vp = port_renders(dtype, "fast", pallas_point=False, pallas_lerp=False, proj_vp_order=True)
    np.testing.assert_array_equal(pv["pred_chw"], vp["pred_chw"])
    np.testing.assert_array_equal(pv["counts"], vp["counts"])
    np.testing.assert_array_equal(kern["counts"][:2], pv["counts"][:2])
    d = np.abs(kern["pred_chw"] - pv["pred_chw"])
    if dtype == "float32":
        assert d.max() == 0
    else:
        m = kern["mask_at_box"].reshape(H, W)
        # measured median 3.6e-4, max 7.6e-3
        assert 0 < np.median(d[:, m]) < 2e-3 and d.max() < 0.03, (np.median(d[:, m]), d.max())


def test_int4_feat_off_the_fused_path_is_the_int8_table(port_renders):
    """Only the fused kernel unpacks int4 rows: with pallas_point off
    int4_feat stores the int8 table, as the JAX package does."""
    i8 = port_renders("float32", "reference", pallas_point=False)
    i4 = port_renders("float32", "reference", pallas_point=False, int4_feat=True)
    np.testing.assert_array_equal(i8["pred_chw"], i4["pred_chw"])
    np.testing.assert_array_equal(i8["counts"], i4["counts"])


@pytest.mark.parametrize("switch", ["frame_mode", "sigma_query_cull"])
def test_fused_query_cull_with_kernel_octet_off(port_renders, switch):
    """The fused path with the geometry feature queried in torch ops takes
    the occupancy cull from the queried features (form b+c) where the
    in-kernel lerp takes it from the rows (form c+e): the same float32
    lerp, the same verdicts."""
    on = port_renders("float32", "reference", **{switch: True})
    off = port_renders("float32", "reference", kernel_octet=False, **{switch: True})
    for k in ("mask_at_box", "overflows", "counts"):
        np.testing.assert_array_equal(on[k], off[k], err_msg=k)
    np.testing.assert_array_equal(on["pred_chw"], off["pred_chw"])
