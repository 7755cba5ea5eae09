"""Slice-level parity of the port's reference-semantics render mode
(gpnerf_tpu_torch/render/demo.py with tight_cull off: blanket occupancy
cull, all 64 samples kept, split projection tables) against the JAX
package's `render_demo_fn` on the same 128^2 synthetic frame with the
trained checkpoint, plus the port's own variants of that mode against each
other. On the CPU the JAX renderer runs its op-by-op float32 point stages
(the Pallas megakernel is gated to the TPU backend, and so is its int4
table) and the port runs the plain version of its point-stage kernel (bf16
dot inputs, f32 accumulation): every integer output of the frame and ray
stages agrees exactly, the colors to the kernel's bf16 numerics."""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnerf_tpu.config import cfg as jax_cfg
from gpnerf_tpu.registry import get as jax_get
from gpnerf_tpu.render.base import src_norm as jax_src_norm
from gpnerf_tpu.train.checkpoint import load_eval_model as jax_load
from gpnerf_tpu_torch.config import cfg as port_cfg
from gpnerf_tpu_torch.registry import get as port_get
from gpnerf_tpu_torch.render.base import batch_to_device, src_norm
from gpnerf_tpu_torch.train.checkpoint import load_eval_model

CKPT = os.path.join(os.path.dirname(__file__), "..", "artifacts", "bench_ckpt.pth")
H = W = 128
# the overrides of the reference-semantics mode; 9,036 blanket rays at 128^2
REF = dict(tight_cull=False, samples_per_ray=64, tap_window=0,
           merge_lowres_src=False, ray_cap=9216)


def _cfg(base, **tpu):
    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file("configs/synthetic.yaml")
    cfg.dataset.H = H
    cfg.dataset.W = W
    cfg.head.sigma.code_dim = 32
    cfg.render.file = "demo_render"
    cfg.dataset.test.sampler = "FrameSampler"
    cfg.tpu.matmul_dtype = "float32"
    cfg.tpu.sigma_cap = 1048576
    cfg.tpu.rgb_cap = 262144
    cfg.tpu.eval_ray_cap = 16384
    cfg.tpu.eval_chunk = 4096
    for k, v in {**REF, **tpu}.items():
        cfg.tpu[k] = v
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module")
def batch():
    cfg = _cfg(jax_cfg)
    np.random.seed(0)
    random.seed(0)
    return jax_get("dataset", cfg.dataset.test.file)(cfg, is_train=False)[0]


@pytest.fixture(scope="module")
def jax_renders(batch):
    """mode -> (JAX renderer, variables, its render of `batch`), made once."""
    cache = {}

    def get(**tpu):
        key = tuple(sorted(tpu.items()))
        if key not in cache:
            jr = jax_get("render", "demo_render")(_cfg(jax_cfg, **tpu))
            variables = jax_load(CKPT, jr.init_variables(0, batch), 4)
            ret = jr.render_demo_fn()(variables, {k: jnp.asarray(v) for k, v in batch.items()})
            cache[key] = (jr, variables, {k: np.asarray(v) for k, v in ret.items()})
        return cache[key]

    return get


@pytest.fixture(scope="module")
def port_renders(batch):
    """mode -> the port's render of `batch` on the CPU, made once."""
    cache = {}

    def get(**tpu):
        key = tuple(sorted(tpu.items()))
        if key not in cache:
            port = port_get("render", "demo_render")(_cfg(port_cfg, **tpu), device="cpu")
            load_eval_model(CKPT, port)
            ret = port.render_demo_fn()(batch_to_device(batch, "cpu"))
            cache[key] = {k: v.numpy() for k, v in ret.items()}
        return cache[key]

    return get


def _assert_same_rays(pret, jret):
    np.testing.assert_array_equal(pret["mask_at_box"], jret["mask_at_box"])
    np.testing.assert_array_equal(pret["ray_pix_idx"], jret["ray_pix_idx"])
    np.testing.assert_array_equal(pret["ray_ok"], jret["ray_ok"])
    # XLA fuses the dense voxel walk `iota * 2 * voxel + bounds` into one
    # multiply-add, the port rounds the product first: the AABB of the
    # occupied voxels may differ in the last float32 bit
    np.testing.assert_allclose(pret["can_bounds"], jret["can_bounds"], rtol=0, atol=2e-7)


def _assert_images_close(pret, jret):
    m = pret["mask_at_box"].reshape(H, W)
    assert m.sum() > 5000
    diff = np.abs(pret["pred_chw"] - jret["pred_chw"])
    # bf16 dot inputs through 4+5 MLP layers against float32 heads (the gap
    # tests/test_torch_demo.py measures for the fast mode); measured here
    # median 4.1e-4, 99.9th percentile 8.2e-3
    assert np.median(diff[:, m]) < 2e-3, np.median(diff[:, m])
    assert np.percentile(diff[:, m], 99.9) < 0.015, np.percentile(diff[:, m], 99.9)
    assert diff[:, 1:].max() < 0.05, diff[:, 1:].max()
    # image row 0: the target camera shares its row geometry with a source
    # camera, so these rays' samples project onto source row y = 0.0 to the
    # last bit, where the in-bounds test `y >= 0` is decided by the rounding
    # of the projection product and a view flips in or out (6 pixels,
    # largest |d| 0.052, the same with float32 dot inputs in the port)
    assert diff[:, 0].max() < 0.1, diff[:, 0].max()
    assert (pret["pred_chw"][:, ~m] == 0).all()


def test_frame_stage_blanket_matches_jax(batch, jax_renders):
    """Ray set, pix_idx, ray_overflow, the dilated occupancy volume and the
    quantized split tables of the blanket frame stage, bitwise."""
    jr, variables, _ = jax_renders()

    @jax.jit
    def jax_stage(variables, b):
        feat = jr.encoder.apply(variables["encoder"], jax_src_norm(b["src_imgs"]))
        _, tables, rd = jr._frame_stage(variables, b, feat)
        keep = ("occb", "src_quad", "feat_quad", "src_scale", "feat_scale")
        return feat, {k: tables[k] for k in keep}, {
            k: rd[k] for k in ("pix_idx", "ray_ok", "ray_overflow", "near", "far")}

    feat, jt, jrd = jax_stage(variables, {k: jnp.asarray(v) for k, v in batch.items()})
    port = port_get("render", "demo_render")(_cfg(port_cfg), device="cpu")
    load_eval_model(CKPT, port)
    b = batch_to_device(batch, "cpu")
    with torch.no_grad():
        # the two encoders agree to float32 rounding only (tests/
        # test_torch_modules.py), which flips a few int8 codes at rounding
        # ties; both frame stages get the JAX feature maps
        pfeat = port.encoder(src_norm(b["src_imgs"]))
        np.testing.assert_allclose(pfeat.numpy(), np.asarray(feat), rtol=0, atol=1e-3)
        _, pt, prd = port._frame_stage(b, torch.from_numpy(np.array(feat)))
    assert "proj_scale" not in pt and prd["bins"] is None
    for k in ("pix_idx", "ray_ok", "ray_overflow"):
        np.testing.assert_array_equal(prd[k].numpy(), np.asarray(jrd[k]), err_msg=k)
    assert int(prd["ray_overflow"]) == 0 and int(prd["ray_ok"].sum()) > 5000
    assert pt["occb"].dtype == torch.uint8 and pt["src_quad"].dtype == torch.uint8
    assert pt["feat_quad"].dtype == torch.int8
    assert tuple(pt["src_quad"].shape) == (3, H + 1, W + 1, 12)
    for k in ("occb", "src_quad", "feat_quad", "src_scale"):
        np.testing.assert_array_equal(pt[k].numpy(), np.asarray(jt[k]), err_msg=k)
    # inside a jit XLA rewrites `amax / 127` to `amax * (1 / 127)`, one
    # float32 ulp off the true quotient in some channels (1 of 32 here);
    # outside a jit the scales agree bitwise (tests/test_torch_modules.py)
    np.testing.assert_allclose(pt["feat_scale"].numpy(), np.asarray(jt["feat_scale"]),
                               rtol=1.2e-7, atol=0)
    ok = prd["ray_ok"].numpy()
    for k in ("near", "far"):  # downstream of can_bounds, see _assert_same_rays
        np.testing.assert_allclose(prd[k].numpy()[ok], np.asarray(jrd[k])[ok], rtol=0, atol=1e-6)


def test_reference_mode_matches_jax(jax_renders, port_renders):
    jret, pret = jax_renders()[2], port_renders()
    _assert_same_rays(pret, jret)
    # [ray, per-ray-K, sigma, rgb] overflows: K = S keeps every sample
    np.testing.assert_array_equal(pret["overflows"], jret["overflows"])
    assert (pret["overflows"] == 0).all()
    # rays and tapped samples: exact; colored points (alpha > 1e-14) within
    # 0.1% (bf16 dot inputs at the ReLU/alpha boundary)
    np.testing.assert_array_equal(pret["counts"][:2], jret["counts"][:2])
    assert pret["counts"][1] > 300000
    assert abs(int(pret["counts"][2]) - int(jret["counts"][2])) <= 0.001 * jret["counts"][2]
    _assert_images_close(pret, jret)


def test_frame_mode_matches_jax(jax_renders, port_renders):
    jret, pret = jax_renders(frame_mode=True)[2], port_renders(frame_mode=True)
    _assert_same_rays(pret, jret)
    np.testing.assert_array_equal(pret["overflows"], jret["overflows"])
    assert (pret["overflows"] == 0).all()
    # n_sigma counts the samples passing the trilinear level-1 occupancy
    # cull, a sum of non-negative terms compared with 0 on both sides
    np.testing.assert_array_equal(pret["counts"][:2], jret["counts"][:2])
    # colored points: the trilinear cull leaves the thin shell where small
    # densities sit at the ReLU boundary, so bf16 dot inputs flip a larger
    # share than in the tapped blanket (58 of 41,399 measured); within 0.2%
    assert abs(int(pret["counts"][2]) - int(jret["counts"][2])) <= 0.002 * jret["counts"][2]
    _assert_images_close(pret, jret)


def test_frame_mode_culls_like_dense_slots_with_query_cull(port_renders):
    """The dilated tap keeps a superset of the trilinear `sp_feats > 0`
    set, so dense slots + sigma_query_cull and the windowless frame mode
    cull the same samples (tests/test_demo_consistency.py:272); zero-alpha
    samples are composite-neutral, so the images agree to reassociation."""
    frame = port_renders(frame_mode=True)
    dense = port_renders(sigma_query_cull=True)
    plain = port_renders()
    np.testing.assert_array_equal(frame["mask_at_box"], dense["mask_at_box"])
    # the same kernel on the same points: colored points agree exactly, and
    # the frame's n_sigma is the tapped count less the tap's fringe
    assert frame["counts"][2] == dense["counts"][2]
    assert frame["counts"][1] <= dense["counts"][1] == plain["counts"][1]
    assert dense["counts"][2] <= plain["counts"][2]
    diff = np.abs(frame["pred_chw"] - dense["pred_chw"])
    assert diff.max() < 2e-5, diff.max()
    # and the query cull does bite on top of the tap
    assert np.abs(dense["pred_chw"] - plain["pred_chw"]).max() > 0


def test_splat_cap_is_exact_and_overflow_shows(port_renders):
    """Compacting the blanket's occupied voxels before the splats is exact
    when drop-free (tests/test_demo_consistency.py:202); an undersized cap
    is counted into ray_overflow."""
    capped = port_renders()  # splat_cap 393216, the default
    dense = port_renders(splat_cap=0)
    for k in ("pred_chw", "mask_at_box", "ray_pix_idx", "counts", "overflows"):
        np.testing.assert_array_equal(capped[k], dense[k], err_msg=k)
    small = port_renders(splat_cap=4096)
    assert small["overflows"][0] > 0
    assert small["counts"][0] < capped["counts"][0]


@pytest.mark.parametrize("mode", ["fast", "reference"])
def test_kernel_octet_off_matches_on(port_renders, mode):
    """Form (b): the geometry feature queried in torch ops and passed as a
    (P, 96) tensor equals the in-kernel lerp of the same rows."""
    base = {} if mode == "reference" else dict(
        tight_cull=True, samples_per_ray=13, tap_window=32, merge_lowres_src=True)
    on = port_renders(**base)
    off = port_renders(kernel_octet=False, **base)
    for k in ("mask_at_box", "overflows"):
        np.testing.assert_array_equal(on[k], off[k], err_msg=k)
    np.testing.assert_array_equal(on["counts"][:2], off["counts"][:2])
    # the same float32 lerp expressions in the same order on both routes
    np.testing.assert_array_equal(on["pred_chw"], off["pred_chw"])


def test_int4_feat_close_to_int8(port_renders):
    """The int4 split-packed feature table has no end-to-end JAX reference
    on the CPU; it is held against the port's own int8 render."""
    i8, i4 = port_renders(), port_renders(int4_feat=True)
    for k in ("mask_at_box", "overflows"):
        np.testing.assert_array_equal(i8[k], i4[k], err_msg=k)
    np.testing.assert_array_equal(i8["counts"][:2], i4["counts"][:2])
    m = i8["mask_at_box"].reshape(H, W)
    diff = np.abs(i8["pred_chw"] - i4["pred_chw"])[:, m]
    # 15 levels per feature channel instead of 255, on a network trained
    # without them. Measured: |d| median 0.010, 99th percentile 0.110, max
    # 0.263; PSNR of the int4 render against the int8 render 31.3 dB
    assert 0 < np.median(diff) < 0.02, np.median(diff)
    assert np.percentile(diff, 99) < 0.15, np.percentile(diff, 99)
    assert diff.max() < 0.4, diff.max()
    assert -10 * np.log10(float(np.mean(diff ** 2))) > 29.0


@pytest.mark.parametrize(
    "tpu,key",
    [
        (dict(samples_per_ray=32), "samples_per_ray"),
        (dict(tap_window=16), "tap_window"),
        (dict(merge_lowres_src=True), "merge_lowres_src"),
        (dict(dense_slots=False), "dense_slots"),
        (dict(quantize_proj=False), "quantize_proj"),
        (dict(frame_mode=True, int4_feat=True), "int4_feat"),
        (dict(int4_feat=True, kernel_octet=False), "kernel_octet"),
        (dict(tight_cull=True, tap_window=32, samples_per_ray=13,
              merge_lowres_src=True, int4_feat=True), "int4_feat"),
    ],
)
def test_build_render_raises_outside_the_modes(tpu, key):
    with pytest.raises(NotImplementedError, match=key):
        port_get("render", "demo_render")(_cfg(port_cfg, **tpu), device="cpu")


@pytest.mark.parametrize(
    "tpu",
    [
        {},
        dict(frame_mode=True),
        dict(sigma_query_cull=True),
        dict(int4_feat=True),
        dict(kernel_octet=False),
        dict(tight_cull=True, samples_per_ray=13, merge_lowres_src=True),
        dict(tight_cull=True, samples_per_ray=13, merge_lowres_src=True, kernel_octet=False),
    ],
)
def test_build_render_accepts_the_modes(tpu):
    r = port_get("render", "demo_render")(_cfg(port_cfg, **tpu), device="cpu")
    assert r.tight_cull == tpu.get("tight_cull", False)
