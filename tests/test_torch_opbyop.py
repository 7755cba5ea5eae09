"""Slice-level parity of the port's op-by-op point stages
(gpnerf_tpu_torch/render/demo.py with tpu.pallas_point off) against the JAX
package's `render_demo_fn` on the same 128^2 synthetic frame with the
trained checkpoint. On the CPU the JAX renderer runs its own op-by-op point
stages (its Pallas kernels are gated to the TPU backend), so in the float32
configuration this comparison has no bf16 kernel numerics in it: integers
agree bitwise and colors to float32 reassociation. In the bf16 configuration
both sides round every layer's products, sums and activations to bf16.
tests/test_torch_opbyop_port.py holds the op-by-op render against the port's
own fused render and its routes against each other."""

import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnerf_tpu.config import cfg as jax_cfg
from gpnerf_tpu.registry import get as jax_get
from gpnerf_tpu.train.checkpoint import load_eval_model as jax_load
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


def _cfg(base, dtype, mode, **tpu):
    cfg = base.clone()
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
    """The port's renders launch thousands of small torch ops; with the test
    files run in parallel, every process spinning up a thread per core for
    each op costs far more than the threads save."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batch():
    cfg = _cfg(jax_cfg, "float32", "fast")
    np.random.seed(0)
    random.seed(0)
    return jax_get("dataset", cfg.dataset.test.file)(cfg, is_train=False)[0]


@pytest.fixture(scope="module")
def jax_renders(batch):
    """(dtype, mode, switches) -> the JAX render of `batch`, made once."""
    cache = {}

    def get(dtype, mode, **tpu):
        key = (dtype, mode, tuple(sorted(tpu.items())))
        if key not in cache:
            jr = jax_get("render", "demo_render")(_cfg(jax_cfg, dtype, mode, **tpu))
            variables = jax_load(CKPT, jr.init_variables(0, batch), 4)
            ret = jr.render_demo_fn()(variables, {k: jnp.asarray(v) for k, v in batch.items()})
            cache[key] = {k: np.asarray(v) for k, v in ret.items()}
        return cache[key]

    return get


@pytest.fixture(scope="module")
def port_renders(batch):
    """(dtype, mode, switches) -> the port's render of `batch` on the CPU."""
    cache = {}

    def get(dtype, mode, **tpu):
        key = (dtype, mode, tuple(sorted(tpu.items())))
        if key not in cache:
            port = port_get("render", "demo_render")(_cfg(port_cfg, dtype, mode, **tpu),
                                                     device="cpu")
            load_eval_model(CKPT, port)
            ret = port.render_demo_fn()(batch_to_device(batch, "cpu"))
            cache[key] = {k: v.numpy() for k, v in ret.items()}
        return cache[key]

    return get


def _assert_same_rays(pret, jret):
    np.testing.assert_array_equal(pret["mask_at_box"], jret["mask_at_box"])
    np.testing.assert_array_equal(pret["ray_pix_idx"], jret["ray_pix_idx"])
    np.testing.assert_array_equal(pret["ray_ok"], jret["ray_ok"])
    # the blanket's AABB may differ in the last float32 bit (XLA fuses the
    # dense voxel walk into a multiply-add, tests/test_torch_refmode.py)
    np.testing.assert_allclose(pret["can_bounds"], jret["can_bounds"], rtol=0, atol=2e-7)
    np.testing.assert_array_equal(pret["overflows"], jret["overflows"])
    np.testing.assert_array_equal(pret["counts"][:2], jret["counts"][:2])


def _image_stats(a, b, mask):
    d = np.abs(a["pred_chw"] - b["pred_chw"])
    dm = d[:, mask]
    return np.median(dm), np.percentile(dm, 99.9), d[:, 1:].max(), d[:, 0].max()


# |d pred_chw| bounds over covered pixels: (median, 99.9th percentile, max
# outside image row 0, max on row 0), and the share of colored points
# (alpha > 1e-14) that may differ. Measured, (dtype, mode) in table order:
# float32: 3.0e-7 / 5.8e-4 / 0.024, 0 of 52,209 points; 2.8e-7 / 6.1e-4 /
# 0.052 on row 0, 29 of 106,347. The float32 tail comes from the few points
# whose density sits at the ReLU/alpha boundary, where a reassociated float32
# sum flips a sample on or off (the fused path's bf16 kernel numerics gave a
# median of 4.6e-4 in tests/test_torch_demo.py). bfloat16, on real bf16
# tensors: 1.2e-3 / 1.1e-2 / 0.025, 31 of 52,210; 9.7e-4 / 2.4e-2 / 0.039,
# 0.058 on row 0, 211 of 106,291: both sides
# round each of the 9 layers to bf16 (2^-8 relative) and the two encoders
# already differ by bf16 steps (tests/test_torch_modules.py). Row 0 of the
# blanket: a view flips in or out where a sample projects onto source row
# y = 0.0 to the last bit (tests/test_torch_refmode.py).
BOUNDS = {
    ("float32", "fast"): (5e-6, 3e-3, 0.05, 0.05, 2e-4),
    ("float32", "reference"): (5e-6, 3e-3, 0.05, 0.1, 1e-3),
    ("bfloat16", "fast"): (4e-3, 3e-2, 0.06, 0.06, 1e-3),
    ("bfloat16", "reference"): (4e-3, 5e-2, 0.1, 0.12, 3e-3),
}


@pytest.mark.parametrize("dtype,mode", sorted(BOUNDS))
def test_opbyop_render_matches_jax(jax_renders, port_renders, dtype, mode):
    jret = jax_renders(dtype, mode)
    pret = port_renders(dtype, mode, pallas_point=False)
    _assert_same_rays(pret, jret)
    if mode == "reference":
        assert (pret["overflows"] == 0).all() and pret["counts"][1] > 300000
    else:
        assert pret["overflows"][0] == 0 and pret["overflows"][1] > 0
    med, p999, mx, mx0, flips = BOUNDS[dtype, mode]
    n_j = int(jret["counts"][2])
    assert abs(int(pret["counts"][2]) - n_j) <= flips * n_j, (pret["counts"], jret["counts"])
    m = pret["mask_at_box"].reshape(H, W)
    assert m.sum() > 2000
    got = _image_stats(pret, jret, m)
    assert got[0] < med and got[1] < p999 and got[2] < mx and got[3] < mx0, got
    assert (pret["pred_chw"][:, ~m] == 0).all()


@pytest.mark.parametrize("switch", ["sigma_query_cull", "frame_mode"])
def test_opbyop_query_cull_matches_jax(jax_renders, port_renders, switch):
    """The level-1 trilinear occupancy read off the folded query
    (`with_l1_occ`): n_sigma counts the samples that pass it."""
    jret = jax_renders("float32", "reference", **{switch: True})
    pret = port_renders("float32", "reference", pallas_point=False, **{switch: True})
    _assert_same_rays(pret, jret)  # counts[1] included: the cull is a sign test
    n_j = int(jret["counts"][2])
    # measured 33 and 59 of 41,4xx colored points (ReLU/alpha boundary)
    assert abs(int(pret["counts"][2]) - n_j) <= 3e-3 * n_j
    m = pret["mask_at_box"].reshape(H, W)
    got = _image_stats(pret, jret, m)
    # measured median 6.0e-8, 99.9th percentile 5.6e-4, max 5.3e-3
    assert got[0] < 5e-6 and got[1] < 3e-3 and max(got[2:]) < 0.03, got
