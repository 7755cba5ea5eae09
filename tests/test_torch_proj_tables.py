"""The progressive renderer under each projection-table choice the JAX
package makes, chosen apart from the cull (gpnerf_tpu_torch/render/demo.py
`projection_rows`; JAX render/demo.py:1376-1457), against the JAX package's
`render_demo_fn` on the same 128^2 synthetic frame with the trained
checkpoint: split tables under the tight cull (the paper configs' default),
merged tables under the blanket cull, `merge_src_feat`, `quantize_proj`
off (merged and split), float source images, `sigma_query_cull` in the
fast mode and the reference mode's `frame_mode` with `sigma_query_cull`.
On the CPU the JAX renderer runs its op-by-op float32 point stages and the
port the plain version of its point-stage kernel (bf16 dot inputs, float32
accumulation), or its own op-by-op stages: every integer output of the
frame and ray stages agrees exactly, the colors to the kernel's bf16
numerics. Also the frame stage's tables under bfloat16 against JAX's."""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnerf_tpu.config import cfg as jax_cfg
from gpnerf_tpu.registry import get as jax_get
from gpnerf_tpu.train.checkpoint import load_eval_model as jax_load
from gpnerf_tpu_torch.config import cfg as port_cfg
from gpnerf_tpu_torch.registry import get as port_get
from gpnerf_tpu_torch.render.base import batch_to_device, src_norm
from gpnerf_tpu_torch.train.checkpoint import load_eval_model

CKPT = os.path.join(os.path.dirname(__file__), "..", "artifacts", "bench_ckpt.pth")
H = W = 128
# the reference-semantics mode at 128^2 (tests/test_torch_refmode.py)
REF = dict(tight_cull=False, samples_per_ray=64, tap_window=0, ray_cap=9216,
           sigma_cap=1048576, rgb_cap=262144)
# case -> (tpu overrides of configs/synthetic.yaml, float source images)
CASES = {
    "split_tight": (dict(merge_lowres_src=False), False),
    "merged_blanket": (dict(REF, merge_lowres_src=True), False),
    "merge_src_feat": (dict(merge_src_feat=True), False),
    "float_merged": (dict(quantize_proj=False), False),
    "float_split": (dict(merge_lowres_src=False, quantize_proj=False), False),
    "float_sources": (dict(merge_lowres_src=False), True),
    "query_cull_fast": (dict(sigma_query_cull=True), False),
    "ref_frame_query": (dict(REF, merge_lowres_src=False, frame_mode=True,
                             sigma_query_cull=True), False),
}


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """The port's renders launch thousands of small torch ops; with the test
    files run in parallel, a thread per core for each op costs more than it
    saves (tests/test_torch_opbyop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(base, matmul_dtype="float32", **tpu):
    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file("configs/synthetic.yaml")
    cfg.dataset.H = H
    cfg.dataset.W = W
    cfg.head.sigma.code_dim = 32
    cfg.render.file = "demo_render"
    cfg.dataset.test.sampler = "FrameSampler"
    cfg.tpu.matmul_dtype = matmul_dtype
    # the capacities of tests/test_demo_consistency.py at 128^2
    cfg.tpu.ray_cap = 16384
    cfg.tpu.sigma_cap = 262144
    cfg.tpu.rgb_cap = 131072
    cfg.tpu.eval_ray_cap = 16384
    cfg.tpu.eval_chunk = 4096
    for k, v in tpu.items():
        cfg.tpu[k] = v
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module")
def batches():
    """The uint8 test frame and the same frame with float source images
    (the normalized frame, which `src_norm` passes through)."""
    cfg = _cfg(jax_cfg)
    np.random.seed(0)
    random.seed(0)
    b = jax_get("dataset", cfg.dataset.test.file)(cfg, is_train=False)[0]
    f = dict(b, src_imgs=(b["src_imgs"].astype(np.float32) / 127.5 - 1.0).astype(np.float32))
    return {False: b, True: f}


@pytest.fixture(scope="module")
def jax_renders(batches):
    """case -> (JAX renderer, variables, its render), made once."""
    cache = {}

    def get(case, matmul_dtype="float32"):
        key = (case, matmul_dtype)
        if key not in cache:
            tpu, flt = CASES[case]
            jr = jax_get("render", "demo_render")(_cfg(jax_cfg, matmul_dtype, **tpu))
            variables = jax_load(CKPT, jr.init_variables(0, batches[False]), 4)
            ret = jr.render_demo_fn()(variables, {k: jnp.asarray(v) for k, v in batches[flt].items()})
            cache[key] = (jr, variables, {k: np.asarray(v) for k, v in ret.items()})
        return cache[key]

    return get


def _port_render(case, batches, **extra):
    tpu, flt = CASES[case]
    port = port_get("render", "demo_render")(_cfg(port_cfg, **tpu, **extra), device="cpu")
    load_eval_model(CKPT, port)
    ret = port.render_demo_fn()(batch_to_device(batches[flt], "cpu"))
    return port, {k: v.numpy() for k, v in ret.items()}


def _assert_matches_jax(pret, jret, blanket):
    for k in ("mask_at_box", "ray_pix_idx", "ray_ok", "overflows"):
        np.testing.assert_array_equal(pret[k], jret[k], err_msg=k)
    # rays and kept samples: exact; colored points (alpha > 1e-14): bf16 dot
    # inputs move near-zero densities across the ReLU/alpha boundary for a
    # few points (tests/test_torch_demo.py, test_torch_refmode.py; measured
    # at most 15 of 52,214 here); bound the flips at 0.2%
    np.testing.assert_array_equal(pret["counts"][:2], jret["counts"][:2])
    assert abs(int(pret["counts"][2]) - int(jret["counts"][2])) <= 0.002 * jret["counts"][2]
    assert pret["overflows"][0] == 0
    m = pret["mask_at_box"].reshape(H, W)
    assert m.sum() > 2000
    diff = np.abs(pret["pred_chw"] - jret["pred_chw"])
    # the fused fast mode's recorded gap (median 4.6e-4, max 0.023): bf16
    # dot inputs through 4+5 MLP layers; measured here medians 1.1e-4 to
    # 4.8e-4, 99.9th percentiles to 3.1e-3, maxima to 0.033 (one pixel
    # whose alpha sits at the ReLU boundary)
    assert np.median(diff[:, m]) < 2e-3, np.median(diff[:, m])
    p999 = np.percentile(diff[:, m], 99.9)
    # (the bounds of tests/test_torch_demo.py and, blanket, test_torch_refmode.py)
    assert p999 < (0.015 if blanket else 0.01), p999
    rows = slice(1, None) if blanket else slice(None)
    # (blanket cull: image row 0's samples project onto source row y = 0.0,
    # where the rounding of the projection product flips a view in or out
    # for a few pixels, tests/test_torch_refmode.py)
    assert diff[:, rows].max() < 0.05, diff[:, rows].max()
    assert diff.max() < 0.1
    assert (pret["pred_chw"][:, ~m] == 0).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_table_choice_matches_jax(case, batches, jax_renders):
    port, pret = _port_render(case, batches)
    _assert_matches_jax(pret, jax_renders(case)[2], blanket=not port.tight_cull)


@pytest.mark.parametrize("case", ["split_tight", "merge_src_feat", "float_split"])
def test_table_choice_opbyop_matches_jax(case, batches, jax_renders):
    """The op-by-op point stages (pallas_point off) under the same choices:
    the projection tables sampled in torch ops or, for the merged table,
    through the quad-lerp plain version."""
    port, pret = _port_render(case, batches, pallas_point=False)
    _assert_matches_jax(pret, jax_renders(case)[2], blanket=not port.tight_cull)


def test_kernel_forms_of_the_cases():
    """The point-stage form each case's fused path launches."""
    want = {
        "split_tight": (("u8", "i8"), "default", False, 3),
        "merged_blanket": (("i8",), "default", False, 3),
        "merge_src_feat": (("f32",), "default", False, 3),
        "float_merged": (("f32",), "default", False, 3),
        "float_split": (("u8", "f32"), "default", False, 3),
        "float_sources": (("f32", "i8"), "default", False, 3),
        "query_cull_fast": (("i8",), "default", True, 3),
        "ref_frame_query": (("u8", "i8"), "default", True, 3),
    }
    for case, (tpu, flt) in CASES.items():
        r = port_get("render", "demo_render")(_cfg(port_cfg, **tpu), device="cpu")
        assert r.kernel_form(src_uint8=not flt) == want[case], case
    bf = port_get("render", "demo_render")(
        _cfg(port_cfg, "bfloat16", **CASES["merge_src_feat"][0]), device="cpu")
    assert bf.kernel_form() == (("bf16",), "default", False, 3)


@pytest.mark.parametrize("case", ["merge_src_feat", "float_split_sources"])
def test_bf16_tables_match_jax(case, batches):
    """The frame stage's projection tables in the compute dtype bfloat16
    (the full-resolution merged table; the split pair of float sources and
    unquantized features), from the same feature maps: dtype, shape and
    every row as JAX builds them."""
    tpu, flt = ({"merge_src_feat": (dict(merge_src_feat=True), False)}.get(case)
                or (dict(merge_lowres_src=False, quantize_proj=False), True))
    b = batches[flt]
    jr = jax_get("render", "demo_render")(_cfg(jax_cfg, "bfloat16", **tpu))
    variables = jax_load(CKPT, jr.init_variables(0, b), 4)

    @jax.jit
    def jax_tables(variables, bj, feat):
        _, tables, _ = jr._frame_stage(variables, bj, feat)
        return {k: v for k, v in tables.items()
                if k in ("src_quad", "feat_quad") and v is not None}

    port = port_get("render", "demo_render")(_cfg(port_cfg, "bfloat16", **tpu), device="cpu")
    load_eval_model(CKPT, port)
    pb = batch_to_device(b, "cpu")
    with torch.no_grad():
        feat = port.encoder(src_norm(pb["src_imgs"]))
        _, pt, _ = port._frame_stage(pb, feat)
    jt = jax_tables(variables, {k: jnp.asarray(v) for k, v in b.items()},
                    jnp.asarray(feat.float().numpy(), jnp.bfloat16))
    assert set(jt) == ({"src_quad"} if case == "merge_src_feat" else {"src_quad", "feat_quad"})
    for k, v in jt.items():
        assert pt[k].dtype == torch.bfloat16 and v.dtype == jnp.bfloat16, k
        assert tuple(pt[k].shape) == v.shape, k
        got, ref = pt[k].float().numpy(), np.asarray(v, np.float32)
        # the source rgb and the feature maps are bf16 on both sides and
        # their tables agree bitwise; the upsampled features are float32
        # matmuls (align-corners resampling) in two libraries, rounded to
        # bf16 once: a last-bit difference there moves a few values by one
        # bf16 step
        mismatch = np.mean(got != ref)
        assert mismatch < (2e-3 if case == "merge_src_feat" else 1e-12), (k, mismatch)
        np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=0)
    # unquantized tables carry unit scales (JAX's None)
    scales = ("proj_scale",) if case == "merge_src_feat" else ("src_scale", "feat_scale")
    for k in scales:
        assert bool((pt[k] == 1).all()), k
