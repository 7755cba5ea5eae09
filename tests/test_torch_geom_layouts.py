"""The progressive renderer under the geometry-table switches
(gpnerf_tpu_torch/render/demo.py `_geometry_tables`, `geometry_layout`; JAX
render/demo.py:1201-1370, 689-746) against the JAX package's
`render_demo_fn` on the same 128^2 synthetic frame with the trained
checkpoint, one frame per switch value, float32. On the CPU the JAX renderer
runs its op-by-op point stages and the port the plain version of its
point-stage kernel, or its own op-by-op stages: the ray set, the overflow
counters and the ray and sample counts agree exactly, the colors to the
kernel's bf16 numerics. The layouts the kernel lerps in its own geometry
tables are here; those the fused path queries into a (P, F) feature, the
dense-convolution stack and the float tables are in
tests/test_torch_geom_layouts_queried.py."""

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
from gpnerf_tpu_torch.ops import point_stages as ps
from gpnerf_tpu_torch.registry import get as port_get
from gpnerf_tpu_torch.render.base import batch_to_device
from gpnerf_tpu_torch.train.checkpoint import load_eval_model

CKPT = os.path.join(os.path.dirname(__file__), "..", "artifacts", "bench_ckpt.pth")
H = W = 128
# case -> (tpu overrides of configs/synthetic.yaml, the geometry layout the
# fused path hands the kernel)
CASES = {
    "coarse_nearest 1": (dict(coarse_nearest=1), "default"),
    "coarse_nearest 0": (dict(coarse_nearest=0), "coarse-octet"),
    "fold_coarse_fc off": (dict(fold_coarse_fc=False), "unfolded"),
    "merge_coarse_octet off": (dict(merge_coarse_octet=False), "four-level"),
    "l1_nearest 1": (dict(l1_nearest=1), "l1-nearest"),
    "l1_nearest 2": (dict(l1_nearest=2), "l1-nearest"),
}


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Whole-frame renders under parallel test files (tests/test_torch_opbyop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_cfg(base, **tpu):
    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file("configs/synthetic.yaml")
    cfg.dataset.H = H
    cfg.dataset.W = W
    cfg.head.sigma.code_dim = 32
    cfg.render.file = "demo_render"
    cfg.dataset.test.sampler = "FrameSampler"
    cfg.tpu.matmul_dtype = "float32"
    # the capacities of tests/test_demo_consistency.py at 128^2
    cfg.tpu.ray_cap = 16384
    cfg.tpu.sigma_cap = 262144
    cfg.tpu.rgb_cap = 131072
    for k, v in tpu.items():
        cfg.tpu[k] = v
    cfg.freeze()
    return cfg


def load_batch():
    """The test frame, as the JAX package's data pipeline builds it."""
    cfg = make_cfg(jax_cfg)
    np.random.seed(0)
    random.seed(0)
    return jax_get("dataset", cfg.dataset.test.file)(cfg, is_train=False)[0]


def jax_variables(batch):
    """The checkpoint's variables in the JAX renderer's tree, which no
    geometry-table switch changes."""
    jr = jax_get("render", "demo_render")(make_cfg(jax_cfg))
    return jax_load(CKPT, jr.init_variables(0, batch), 4)


def jax_render(batch, variables, tpu):
    jr = jax_get("render", "demo_render")(make_cfg(jax_cfg, **tpu))
    ret = jr.render_demo_fn()(variables, {k: jnp.asarray(v) for k, v in batch.items()})
    return {k: np.asarray(v) for k, v in ret.items()}


def port_render(batch, tpu, layout=None, **extra):
    """The port's render on the CPU; `layout`: the geometry layout its fused
    path must hand the kernel, and it must have a library."""
    r = port_get("render", "demo_render")(make_cfg(port_cfg, **tpu, **extra), device="cpu")
    if layout is not None:
        assert r.kernel_form()[1] == layout and r.kernel_form() in ps.FORMS
    load_eval_model(CKPT, r)
    return {k: v.numpy() for k, v in r.render_demo_fn()(batch_to_device(batch, "cpu")).items()}


def assert_matches_jax(pret, jret, median_tol=5e-4, max_tol=0.035):
    """Integers exactly; colored points within 0.2% (bf16 dot inputs move
    near-zero densities across the alpha boundary); colors on the covered
    pixels: |d| median <= median_tol, max <= max_tol, and the images >= 40
    dB apart. Returns (median, max, PSNR).

    The last image row is held to 0.05 instead: pixel (127, 58)'s samples
    project onto source view 0's last row, y = 127 to within a float32 ulp,
    where the in-bounds test flips with the rounding of the projection
    product (the border-row flip of tests/test_torch_refmode.py's row 0).
    The float32 op-by-op path, median 3e-7 elsewhere, differs there by as
    much: 0.024 with the default tables, 0.038-0.039 with four coarse tables
    or the int4 coarse table."""
    for k in ("mask_at_box", "ray_pix_idx", "ray_ok", "overflows"):
        np.testing.assert_array_equal(pret[k], jret[k], err_msg=k)
    np.testing.assert_array_equal(pret["counts"][:2], jret["counts"][:2])
    assert abs(int(pret["counts"][2]) - int(jret["counts"][2])) <= 0.002 * jret["counts"][2]
    assert pret["overflows"][0] == 0
    m = pret["mask_at_box"].reshape(H, W)
    assert m.sum() > 2000
    full = np.abs(pret["pred_chw"] - jret["pred_chw"])
    diff = full[:, m]
    med, mx = float(np.median(diff)), float(diff.max())
    psnr = -10 * np.log10(float(np.mean(diff ** 2)))
    assert med <= median_tol, med
    assert full[:, :-1].max() <= max_tol, full[:, :-1].max()
    assert mx < max(max_tol, 0.05), mx
    assert psnr >= 40.0, psnr
    assert (pret["pred_chw"][:, ~m] == 0).all()
    return med, mx, psnr


@pytest.fixture(scope="module")
def batch():
    return load_batch()


@pytest.fixture(scope="module")
def jax_renders(batch):
    cache, variables = {}, jax_variables(batch)

    def get(case):
        if case not in cache:
            cache[case] = jax_render(batch, variables, CASES[case][0])
        return cache[case]

    return get


@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_matches_jax(case, batch, jax_renders):
    tpu, layout = CASES[case]
    assert_matches_jax(port_render(batch, tpu, layout), jax_renders(case))


def test_unfolded_opbyop_matches_jax(batch, jax_renders):
    """The op-by-op point stages with the coarse table unfolded: the
    128-channel query and out_geometry_fc (`query_sigma_feat_octet`)."""
    tpu, _ = CASES["fold_coarse_fc off"]
    assert_matches_jax(port_render(batch, tpu, pallas_point=False),
                       jax_renders("fold_coarse_fc off"))
