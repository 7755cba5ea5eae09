"""The port's quad-lerp plain versions, quad-table samplers and projection
gathers (gpnerf_tpu_torch/ops/quad_lerp.py, grid_sample.py, projection.py)
against the JAX package on the same numpy-seeded inputs. The Pallas kernels
run in interpret mode with block=128, as the JAX package's own tests run
them on the CPU."""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnerf_tpu.ops import grid_sample as jgs
from gpnerf_tpu.ops import pallas_lerp as jpl
from gpnerf_tpu.ops import projection as jproj
from gpnerf_tpu_torch.ops import grid_sample as pgs
from gpnerf_tpu_torch.ops import projection as pproj
from gpnerf_tpu_torch.ops import quad_lerp as pql

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
PDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(t):
    return t.float().numpy()


def _assert_lerp_close(got, ref, out):
    """XLA's CPU backend contracts the kernel's float32 multiply-add into an
    FMA, the plain version rounds the product first: the float32 sums differ
    by an ulp of the running sum (measured <= 1.0e-7 of max|out| on a third
    of the values). After the rounding to bf16 that shows only where the ulp
    straddles a rounding edge (measured on <= 0.02% of the values), as one
    bf16 step."""
    if out == "float32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=2.5e-7 * np.abs(ref).max())
    else:
        np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=0)
        assert np.mean(got != ref) < 1e-3


def _numpy_lerp(rows, w4, scale, out):
    """Independent float32 reference: products rounded, summed from 0 in tap
    order, scaled, rounded once."""
    V, _, P = w4.shape
    C = rows.shape[-1] // 4
    r = rows.reshape(V, P, 4, C)
    if r.dtype == np.float32:
        r = _np(torch.from_numpy(r).to(torch.bfloat16))
    acc = np.zeros((V, P, C), np.float32)
    for k in range(4):
        acc = acc + r[:, :, k].astype(np.float32) * w4[:, k, :, None]
    res = torch.from_numpy((acc * scale).transpose(0, 2, 1).copy())
    return _np(res.to(PDT[out]))


def _lerp_inputs(row_kind, C, V=3, P=300, seed=0):
    rs = np.random.RandomState(seed)
    if row_kind == "int8":
        rows = rs.randint(-127, 128, size=(V * P, 4 * C)).astype(np.int8)
    else:
        rows = rs.randn(V * P, 4 * C).astype(np.float32)
    w4 = (rs.rand(V, 4, P) * (rs.rand(V, 4, P) > 0.1)).astype(np.float32)
    scale = (0.02 + 0.05 * rs.rand(C)).astype(np.float32)
    return rows, w4, scale


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [6, 35])
@pytest.mark.parametrize("row_kind", ["int8", "float32"])
def test_vcp_plain_matches_pallas_interpret(row_kind, C, out):
    rows, w4, scale = _lerp_inputs(row_kind, C)
    ref = jpl.quad_lerp_rows_vcp(jnp.asarray(rows), jnp.asarray(w4), jnp.asarray(scale),
                                 out_dtype=JDT[out], interpret=True, block=128)
    got = pql.quad_lerp_rows_vcp_plain(torch.from_numpy(rows), torch.from_numpy(w4),
                                       torch.from_numpy(scale), out_dtype=PDT[out])
    assert got.dtype == PDT[out] and tuple(got.shape) == (3, C, 300)
    _assert_lerp_close(_np(got), np.asarray(ref, np.float32), out)
    # bitwise against the same arithmetic in numpy
    np.testing.assert_array_equal(_np(got), _numpy_lerp(rows, w4, scale, out))
    # and the CPU wrapper is the plain version
    again = pql.quad_lerp_rows_vcp(torch.from_numpy(rows), torch.from_numpy(w4),
                                   torch.from_numpy(scale), out_dtype=PDT[out])
    assert torch.equal(again, got)


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [6, 35])
@pytest.mark.parametrize("row_kind", ["int8", "float32"])
def test_cm_plain_matches_pallas_interpret(row_kind, C, out):
    rows, w4, scale = _lerp_inputs(row_kind, C, V=1, P=300, seed=1)
    w4 = w4[0]
    ref = jpl.quad_lerp_rows_cm(jnp.asarray(rows), jnp.asarray(w4), jnp.asarray(scale),
                                out_dtype=JDT[out], interpret=True, block=128)
    got = pql.quad_lerp_rows_cm(torch.from_numpy(rows), torch.from_numpy(w4),
                                torch.from_numpy(scale), out_dtype=PDT[out])
    assert got.dtype == PDT[out] and tuple(got.shape) == (C, 300)
    _assert_lerp_close(_np(got), np.asarray(ref, np.float32), out)
    np.testing.assert_array_equal(_np(got), _numpy_lerp(rows, w4[None], scale, out)[0])


def test_cm_of_flat_rows_is_vcp_transposed():
    rows, w4, scale = _lerp_inputs("int8", 35, seed=2)
    r, w, s = torch.from_numpy(rows), torch.from_numpy(w4), torch.from_numpy(scale)
    vcp = pql.quad_lerp_rows_vcp_plain(r, w, s)  # (V, C, P)
    cm = pql.quad_lerp_rows_cm_plain(r, w.permute(1, 0, 2).reshape(4, -1).contiguous(), s)
    assert torch.equal(cm, vcp.permute(1, 0, 2).reshape(35, -1))


def test_plain_handles_zero_weight_and_negative_zero():
    rows = np.full((1, 8), -5, np.int8)
    w4 = np.zeros((1, 4, 1), np.float32)
    out = pql.quad_lerp_rows_vcp_plain(torch.from_numpy(rows), torch.from_numpy(w4),
                                       torch.ones(2), out_dtype=torch.float32)
    # the sum starts from +0, so an all-masked point is +0, not -0
    assert not torch.signbit(out).any() and (out == 0).all()


# --- the quad-table samplers, on the inputs of tests/test_grid_sample.py:322-329


@pytest.fixture(scope="module")
def quad_case():
    rng = np.random.default_rng(7)
    V, H, W, C = 3, 12, 11, 6
    img = rng.standard_normal((V, H, W, C)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, size=(V, 300, 2)).astype(np.float32)
    q, sc = jgs.quantize_image_i8(jnp.asarray(img))
    tab = jgs.build_quad_table_2d(q)
    return dict(H=H, W=W, img=img, grid=grid, tab=np.asarray(tab), sc=np.asarray(sc))


def _interp(*a, **kw):
    kw.update(interpret=True, block=128)
    return _interp.orig(*a, **kw)


_interp.orig = jpl.quad_lerp_rows_vcp


@pytest.mark.parametrize("out", [None, "bfloat16"])
@pytest.mark.parametrize("form", ["nhwc", "pv", "kernel"])
def test_quad_samplers_match_jax(quad_case, form, out):
    c = quad_case
    jfn = {"nhwc": jgs.bilinear_quad_nhwc, "pv": jgs.bilinear_quad_nhwc_pv,
           "kernel": jgs.bilinear_quad_nhwc_pv_pallas}[form]
    pfn = {"nhwc": pgs.bilinear_quad_nhwc, "pv": pgs.bilinear_quad_nhwc_pv,
           "kernel": pgs.bilinear_quad_nhwc_pv_kernel}[form]
    with mock.patch.object(jpl, "quad_lerp_rows_vcp", _interp):
        ref = jfn(jnp.asarray(c["tab"]), jnp.asarray(c["grid"]), c["H"], c["W"],
                  scale=jnp.asarray(c["sc"]), out_dtype=None if out is None else JDT[out])
    got = pfn(torch.from_numpy(c["tab"]), torch.from_numpy(c["grid"]), c["H"], c["W"],
              scale=torch.from_numpy(c["sc"]), out_dtype=None if out is None else PDT[out])
    ref = np.asarray(ref, np.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    if form == "kernel":
        # float32 accumulation and one rounding on both sides
        _assert_lerp_close(got.numpy(), ref, out or "float32")
    elif out is None:
        # XLA contracts multiply-adds of the float32 sum into FMAs: an ulp
        # of the running sum (values up to 4.5 here)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    else:
        # every product and partial sum rounded to bf16 on both sides; a
        # rounding that XLA places elsewhere moves a value by one bf16 step
        # (2^-8 relative)
        np.testing.assert_allclose(got.numpy(), ref, rtol=2 ** -7, atol=1e-3)
        assert np.mean(got.numpy() == ref) > 0.95


def test_bf16_forms_differ_from_kernel_form(quad_case):
    """The torch-op forms accumulate in the compute dtype, the kernel form in
    float32 with one rounding: close, and not the same numbers."""
    c = quad_case
    args = (torch.from_numpy(c["tab"]), torch.from_numpy(c["grid"]), c["H"], c["W"])
    kw = dict(scale=torch.from_numpy(c["sc"]), out_dtype=torch.bfloat16)
    pv = pgs.bilinear_quad_nhwc_pv(*args, **kw)
    vp = pgs.bilinear_quad_nhwc(*args, **kw)
    kern = pgs.bilinear_quad_nhwc_pv_kernel(*args, **kw)
    assert torch.equal(pv, vp.transpose(0, 1))
    assert not torch.equal(pv, kern)
    f32 = pgs.bilinear_quad_nhwc_pv(*args, scale=kw["scale"])
    # one rounding is within half a bf16 step of float32, four within ~2
    assert (kern - f32).abs().max() <= 2 ** -8 * f32.abs().max()
    assert (pv - f32).abs().max() <= 2 ** -6 * f32.abs().max()


def test_quad_rows_and_weights_match_jax(quad_case):
    """The gather half the kernel form and the fused point stages share."""
    c = quad_case
    rows, w4 = pgs.quad_rows_and_weights(torch.from_numpy(c["tab"]), torch.from_numpy(c["grid"]))
    rows_b, w4_b = pgs.quad_rows_and_weights(
        torch.from_numpy(c["tab"]), torch.from_numpy(c["grid"]), batched=True)
    assert torch.equal(rows, rows_b) and torch.equal(w4, w4_b)
    assert tuple(rows.shape) == (900, 24) and tuple(w4.shape) == (3, 4, 300)
    # against the float32 sampler: sum of taps
    ref = pgs.bilinear_quad_nhwc(torch.from_numpy(c["tab"]), torch.from_numpy(c["grid"]),
                                 c["H"], c["W"], scale=torch.from_numpy(c["sc"]))
    out = pql.quad_lerp_rows_vcp_plain(rows, w4, torch.from_numpy(c["sc"]),
                                       out_dtype=torch.float32)
    np.testing.assert_array_equal(out.permute(0, 2, 1).numpy(), ref.numpy())


# --- projection gathers


@pytest.fixture(scope="module")
def proj_case():
    rs = np.random.RandomState(5)
    V, H, W, C, P = 3, 24, 20, 8, 257
    Hf, Wf = 12, 10
    src = rs.randint(0, 256, size=(V, H, W, 3)).astype(np.uint8)
    feat = rs.randn(V, Hf, Wf, C).astype(np.float32)
    # cameras looking down +z at points around z = 3, some off-image
    KE = np.zeros((V, 4, 4), np.float32)
    for v in range(V):
        K = np.array([[18.0, 0, W / 2 + v], [0, 18.0, H / 2 - v], [0, 0, 1]], np.float32)
        KE[v, :3, :3] = K
        KE[v, :3, 3] = K @ np.array([0.1 * v, -0.05 * v, 3.0], np.float32)
        KE[v, 3, 3] = 1.0
    xyz = (rs.randn(P, 3) * np.array([1.2, 1.2, 0.5])).astype(np.float32)
    return dict(H=H, W=W, src=src, feat=feat, KE=KE, xyz=xyz)


def test_project_and_gather_quad_matches_jax(proj_case):
    c = proj_case
    qf, fs = jgs.quantize_image_i8(jnp.asarray(c["feat"]))
    src_quad = jgs.build_quad_table_2d(jnp.asarray(c["src"]))
    feat_quad = jgs.build_quad_table_2d(qf)
    ss = np.full((3,), 1.0 / 255.0, np.float32)
    ref, ref_mask = jproj.project_and_gather_quad(
        jnp.asarray(c["xyz"]), jnp.asarray(c["KE"]), src_quad, feat_quad, c["H"], c["W"],
        src_scale=jnp.asarray(ss), feat_scale=fs)
    got, mask = pproj.project_and_gather_quad(
        torch.from_numpy(c["xyz"]), torch.from_numpy(c["KE"]),
        torch.from_numpy(np.asarray(src_quad)), torch.from_numpy(np.asarray(feat_quad)),
        c["H"], c["W"], src_scale=torch.from_numpy(ss), feat_scale=torch.from_numpy(np.asarray(fs)))
    assert tuple(got.shape) == (257, 3, 11) and tuple(mask.shape) == (257, 3)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    assert 0.1 < mask.mean() < 0.95
    # the projected pixel coordinates (up to 24) agree to a float32 ulp, so
    # the tap weights differ by ~2e-6 and the sums of values up to 4 by a
    # few 1e-6 (measured max 4.8e-6), XLA's FMA contraction included
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-5)


@pytest.mark.parametrize("out", [None, "bfloat16"])
@pytest.mark.parametrize("route", ["kernel", "vp_order", "pv"])
def test_project_and_gather_quad_merged_matches_jax(proj_case, route, out):
    c = proj_case
    rs = np.random.RandomState(6)
    comb = rs.randn(3, 12, 10, 11).astype(np.float32)
    q, sc = jgs.quantize_image_i8(jnp.asarray(comb))
    tab = jgs.build_quad_table_2d(q)
    with mock.patch.object(jpl, "quad_lerp_rows_vcp", _interp):
        ref, ref_mask = jproj.project_and_gather_quad_merged(
            jnp.asarray(c["xyz"]), jnp.asarray(c["KE"]), tab, c["H"], c["W"], scale=sc,
            out_dtype=None if out is None else JDT[out],
            vp_order=route == "vp_order", pallas=route == "kernel")
    got, mask = pproj.project_and_gather_quad_merged(
        torch.from_numpy(c["xyz"]), torch.from_numpy(c["KE"]), torch.from_numpy(np.asarray(tab)),
        c["H"], c["W"], scale=torch.from_numpy(np.asarray(sc)),
        out_dtype=None if out is None else PDT[out],
        vp_order=route == "vp_order", kernel=route == "kernel")
    ref = np.asarray(ref, np.float32)
    assert tuple(got.shape) == ref.shape == (257, 3, 11)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask, np.float32))
    if out is None:
        # pixel coordinates to a float32 ulp, see above (measured 4.8e-6)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-5)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=2 ** -7, atol=1e-3)  # one bf16 step


def test_kernel_form_rejects_a_mismatched_table(quad_case):
    c = quad_case
    with pytest.raises(ValueError, match="quad table"):
        pgs.bilinear_quad_nhwc_pv_kernel(torch.from_numpy(c["tab"]), torch.from_numpy(c["grid"]),
                                         c["H"] + 1, c["W"])
