"""Pieces of the port's op-by-op point stages against the JAX package: the
heads under the bf16 compute dtype against the flax modules, mean/variance,
the folded sigma-feature query; and the port's own `stop_stage` prefixes,
`Renderer.profile` and the renderer switches `build_render` accepts."""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpnerf_tpu.ops.grid_sample as jgs
from gpnerf_tpu.config import cfg as jax_cfg
from gpnerf_tpu.models.heads import fused_mean_variance as jax_mean_variance
from gpnerf_tpu.registry import get as jax_get
from gpnerf_tpu.train.checkpoint import load_eval_model as jax_load
import gpnerf_tpu_torch.ops.grid_sample as pgs
from gpnerf_tpu_torch.config import cfg as port_cfg
from gpnerf_tpu_torch.models.heads import fused_mean_variance
from gpnerf_tpu_torch.ops import point_stages as ps
from gpnerf_tpu_torch.registry import get as port_get
from gpnerf_tpu_torch.render import demo as port_demo
from gpnerf_tpu_torch.render.base import batch_to_device, src_norm
from gpnerf_tpu_torch.train.checkpoint import load_eval_model

CKPT = os.path.join(os.path.dirname(__file__), "..", "artifacts", "bench_ckpt.pth")
REF = dict(tight_cull=False, samples_per_ray=64, tap_window=0, merge_lowres_src=False,
           ray_cap=3072)
# the global compaction at 10 points per ray of ray_cap (4096 rays: the
# 64^2 frame's valid slots fit)
COMPACT = dict(dense_slots=False, sigma_cap=40960)
DTYPES = {"float32": (None, None), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfg(base, dtype="float32", size=64, **tpu):
    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file("configs/synthetic.yaml")
    cfg.dataset.H = cfg.dataset.W = size
    cfg.head.sigma.code_dim = 32
    cfg.render.file = "demo_render"
    cfg.tpu.matmul_dtype = dtype
    cfg.tpu.ray_cap = 4096  # every pixel of the 64^2 frame; all K slots are evaluated
    for k, v in tpu.items():
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
def batch():
    cfg = _cfg(jax_cfg)
    np.random.seed(0)
    random.seed(0)
    return jax_get("dataset", cfg.dataset.test.file)(cfg, is_train=False)[0]


@pytest.fixture(scope="module")
def heads(batch):
    """dtype -> (JAX renderer, its variables, the port's NeRFHead), both
    with the trained checkpoint."""
    out = {}
    for dtype in DTYPES:
        jr = jax_get("render", "demo_render")(_cfg(jax_cfg, dtype))
        shapes = jax.eval_shape(lambda key: jr._init_variables_impl(key, batch),
                                jax.random.PRNGKey(0))
        variables = jax_load(
            CKPT, jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes), 4)
        port = port_get("render", "demo_render")(_cfg(port_cfg, dtype), device="cpu")
        load_eval_model(CKPT, port)
        out[dtype] = (jr, variables["head"], port.nerfhead)
    return out


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _assert_bf16_close(got, ref, share_exact=0.995):
    """Both sides round every product, sum and activation to bf16 at the
    same places, so nearly every value is the same bf16 number (measured:
    100% for density, the folded query and mean/variance, 99.99% for
    color); where a float32 dot product summed in another order straddles a
    rounding edge, a value lands on the neighboring bf16 number (2^-8
    relative) and later layers carry that on."""
    np.testing.assert_allclose(got, ref, rtol=2 ** -5, atol=2e-3)
    assert np.mean(got == ref) >= share_exact, np.mean(got == ref)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_density_and_color_under_compute_dtype(heads, dtype):
    jr, hv, head = heads[dtype]
    jdt, _ = DTYPES[dtype]
    rs = np.random.RandomState(7)
    N, V, C = 400, 3, 35
    rgb_feat = (rs.randn(N, V, C) * 0.5).astype(np.float32)
    sigma_feat = rs.randn(N, 64).astype(np.float32)
    nvo = rs.randint(0, 4, size=(N, 1)).astype(np.float32)
    mean, var = rgb_feat.mean(1), rgb_feat.var(1)
    if jdt is not None:  # the op-by-op stages hand the heads bf16 values
        rgb_feat, sigma_feat, mean, var = (_bf16(a) for a in (rgb_feat, sigma_feat, mean, var))
    cast = (lambda a: jnp.asarray(a)) if jdt is None else (lambda a: jnp.asarray(a, jdt))
    s_j = jr.nerfhead.apply(hv, cast(sigma_feat), cast(mean), cast(var), jnp.asarray(nvo),
                            method=lambda m, *a: m.rgbhead.density(*a))
    c_j = jr.nerfhead.apply(hv, cast(rgb_feat), cast(mean[:, None]), cast(var[:, None]),
                            method=lambda m, *a: m.rgbhead.color(*a))
    t = torch.from_numpy
    with torch.no_grad():
        s_p = head.rgbhead.density(t(sigma_feat), t(mean), t(var), t(nvo)).numpy()
        c_p = head.rgbhead.color(t(rgb_feat), t(mean[:, None]), t(var[:, None])).numpy()
    s_j, c_j = np.asarray(s_j, np.float32), np.asarray(c_j, np.float32)
    assert s_p.shape == s_j.shape == (N, 1) and c_p.shape == c_j.shape == (N, 3)
    assert (s_p[nvo[:, 0] < 1] == 0).all()
    if jdt is None:
        np.testing.assert_allclose(s_p, s_j, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(c_p, c_j, atol=1e-6, rtol=1e-5)
    else:
        assert s_j.dtype == np.float32 and (s_p == _bf16(s_p)).all() and (c_p == _bf16(c_p)).all()
        _assert_bf16_close(s_p, s_j)
        _assert_bf16_close(c_p, c_j)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_mean_variance_matches_jax(dtype):
    jdt, pdt = DTYPES[dtype]
    rs = np.random.RandomState(3)
    x = (rs.randn(500, 3, 35) * 0.7).astype(np.float32)
    if jdt is not None:
        x = _bf16(x)
    # compiled, as the renderer runs it: XLA then keeps the square's excess
    # precision into the float32 sum
    m_j, v_j = jax.jit(jax_mean_variance)(jnp.asarray(x) if jdt is None else jnp.asarray(x, jdt))
    m_p, v_p = fused_mean_variance(torch.from_numpy(x), pdt)
    assert tuple(m_p.shape) == tuple(v_p.shape) == (500, 1, 35)
    if jdt is None:
        np.testing.assert_allclose(m_p.numpy(), np.asarray(m_j), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(v_p.numpy(), np.asarray(v_j), rtol=1e-5, atol=1e-7)
    else:
        # float32 sums rounded once to bf16 on both sides
        _assert_bf16_close(m_p.numpy(), np.asarray(m_j, np.float32))
        _assert_bf16_close(v_p.numpy(), np.asarray(v_j, np.float32))


@pytest.mark.parametrize("with_l1_occ", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_folded_sigma_feature_query(heads, dtype, with_l1_occ):
    jr, hv, head = heads[dtype]
    jdt, _ = DTYPES[dtype]
    rs = np.random.RandomState(8)
    out_sh = np.array([32, 64, 48])
    l1 = (16, 32, 24)
    oct_rows = rs.randint(0, 255, size=(17 * 33 * 25 + 1, 256)).astype(np.uint8)
    oct_rows[rs.rand(oct_rows.shape[0]) < 0.5] = 0  # empty cells: the occupancy bites
    near_rows = rs.randint(-127, 127, size=(16 * 32 * 24, 64)).astype(np.int8)
    sc = [(rs.rand(32) * 0.02).astype(np.float32), (rs.rand(64) * 0.02).astype(np.float32)]
    dhw = (rs.rand(600, 3) * (out_sh + 4) - 2).astype(np.float32)
    ref = jr.nerfhead.apply(
        hv, jgs.FlatOctetTable(jnp.asarray(oct_rows), (17, 33, 25)),
        jgs.NearestTable(jnp.asarray(near_rows), l1, 2), jnp.asarray(dhw), jnp.asarray(out_sh),
        scales=[jnp.asarray(x) for x in sc], with_l1_occ=with_l1_occ,
        method=lambda m, *a, **k: m.sigmahead.query_sigma_feat_octet_folded(*a, **k))
    with torch.no_grad():
        got = head.sigmahead.query_sigma_feat_octet_folded(
            pgs.FlatOctetTable(torch.from_numpy(oct_rows), (17, 33, 25)),
            pgs.NearestTable(torch.from_numpy(near_rows), l1, 2),
            torch.from_numpy(dhw), torch.from_numpy(out_sh),
            scales=[torch.from_numpy(x) for x in sc], with_l1_occ=with_l1_occ)
    if with_l1_occ:
        (ref, occ_j), (got, occ_p) = ref, got
        occ_j = np.asarray(occ_j, np.float32)
        # the cull is the sign of a sum of non-negative terms
        np.testing.assert_array_equal(occ_p.numpy() > 0, occ_j > 0)
        assert 0.1 < (occ_j > 0).mean() < 0.95
    ref = np.asarray(ref, np.float32)
    assert tuple(got.shape) == ref.shape == (600, 64)
    if jdt is None:
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    else:
        _assert_bf16_close(got.numpy(), ref)


# --- stop_stage, profile, switches (the port alone)


@pytest.fixture(scope="module")
def small_renders(batch):
    """(switches -> the port's renderer with the checkpoint, the 64^2 batch,
    its encoded feature maps: the encoder is the same in every mode)."""
    cache = {}

    def get(**tpu):
        key = tuple(sorted(tpu.items()))
        if key not in cache:
            r = port_get("render", "demo_render")(_cfg(port_cfg, **tpu), device="cpu")
            cache[key] = load_eval_model(CKPT, r)
        return cache[key]

    b = batch_to_device(batch, "cpu")
    with torch.no_grad():
        featmaps = get().encoder(src_norm(b["src_imgs"]))
    return get, b, featmaps


@pytest.mark.parametrize("mode", ["fast", "reference", "frame_mode", "compacted"])
@pytest.mark.parametrize("stage", port_demo.STOP_STAGES)
def test_every_stop_stage_returns(small_renders, stage, mode):
    get, b, featmaps = small_renders
    tpu = {"fast": {}, "compacted": COMPACT}.get(
        mode, dict(REF, frame_mode=mode == "frame_mode"))
    r = get(**tpu)  # pallas_point on: a stop still takes the op-by-op stages
    with torch.no_grad():
        assert r._demo_impl(b, featmaps, stop_stage=stage) is None


def test_stop_stage_names_are_the_jax_package_s(small_renders):
    assert port_demo.STOP_STAGES == (
        "pre", "codes", "fuse", "occv", "volume", "rays", "cull_occ", "cull_slots",
        "cull_compact", "cull", "sigma_q", "meanvar", "sigma", "rgb")
    assert set(port_demo.PROFILE_LADDER[:-1]) <= set(port_demo.STOP_STAGES)
    get, b, _ = small_renders
    with pytest.raises(ValueError, match="stop_stage"):
        get()._demo_impl(b, None, stop_stage="composite")


@pytest.mark.parametrize("pallas_point", [True, False])
def test_profile_returns_the_reference_slots(small_renders, pallas_point):
    get, b, _ = small_renders
    r = get(pallas_point=pallas_point)
    out = r.profile([b] if pallas_point else b, reps=1)
    assert r.pallas_point == pallas_point  # restored after the ladder
    want = {"etime", "rtime", "totals", "time_slots"} | (
        {"rtime_production"} if pallas_point else set())
    assert set(out) == want
    # each prefix of the ladder, the whole op-by-op render last
    assert list(out["totals"]) == list(port_demo.PROFILE_LADDER)
    assert out["totals"][None] == out["rtime"]
    assert out["time_slots"]["sp_encode"] == out["totals"]["volume"]
    # the slot names and mapping of gpnerf_tpu/render/demo.py:1833-1845
    assert list(out["time_slots"]) == [
        "bc_attn", "sigma_attn", "sigma_c", "sp_encode", "bc_time", "bf_sigma", "sigma_f",
        "bf_rgb", "rgb_f", "bc_render"]
    for k in ("bc_attn", "sigma_attn", "sigma_c", "bf_rgb", "bc_render"):
        assert out["time_slots"][k] == 0.0
    assert out["etime"] > 0 and out["rtime"] > 0 and out["time_slots"]["sp_encode"] > 0
    # the deltas add up to the whole op-by-op render
    np.testing.assert_allclose(sum(out["time_slots"].values()), out["rtime"], rtol=1e-9)


@pytest.mark.parametrize(
    "tpu",
    [
        dict(pallas_point=False),
        dict(pallas_point=False, pallas_lerp=False),
        dict(pallas_point=False, pallas_lerp=False, proj_vp_order=True),
        dict(pallas_point=False, proj_vp_order=True),
        dict(pallas_lerp=False, proj_vp_order=True),
        dict(REF, pallas_point=False),
        dict(REF, pallas_point=False, pallas_lerp=False, proj_vp_order=True),
        dict(REF, pallas_point=False, frame_mode=True),
        dict(REF, pallas_point=False, sigma_query_cull=True),
        dict(REF, pallas_point=False, int4_feat=True),
        dict(REF, pallas_point=False, kernel_octet=False),
        dict(REF, frame_mode=True, kernel_octet=False),
        dict(REF, sigma_query_cull=True, kernel_octet=False),
        dict(REF, int4_feat=True, kernel_octet=False),
        dict(pallas_point=False, frame_mode=True),
        dict(pallas_point=False, merge_src_feat=True),
        dict(REF, pallas_point=False, quantize_proj=False),
        dict(REF, pallas_point=False, frame_mode=True, sigma_query_cull=True),
    ],
)
def test_build_render_accepts_the_switches(tpu):
    r = port_get("render", "demo_render")(_cfg(port_cfg, **tpu), device="cpu")
    for k in ("pallas_point", "pallas_lerp", "proj_vp_order"):
        assert getattr(r, k) == tpu.get(k, k != "proj_vp_order")


@pytest.mark.parametrize("tpu,sigma_cap", [({}, 40960), (dict(REF, samples_per_ray=32), 98304)],
                         ids=["fast", "reference-K32"])
def test_op_by_op_compacted_render_equals_dense_slots(small_renders, tpu, sigma_cap):
    """`dense_slots False` on the op-by-op path: the valid slots compacted to
    sigma_cap (above the 64^2 frame's valid slots) evaluate to the
    dense-slot render bit for bit."""
    get, b, featmaps = small_renders
    with torch.no_grad():
        dense = get(pallas_point=False, **tpu)._demo_impl(b, featmaps)
        comp = get(pallas_point=False, **tpu, dense_slots=False,
                   sigma_cap=sigma_cap)._demo_impl(b, featmaps)
    assert int(comp["overflows"][2]) == 0 and int(comp["counts"][1]) > 0
    for k in ("pred_chw", "overflows", "counts"):
        assert torch.equal(comp[k], dense[k]), k


@pytest.mark.parametrize(
    "tpu,key",
    [
        # combinations whose fused point-stage key FORMS does not name
        (dict(merge_src_feat=True, kernel_octet=False), "kernel_octet"),
        (dict(REF, quantize_proj=False, frame_mode=True), "frame_mode"),
        # the geometry-table switches beside float rows
        (dict(merge_src_feat=True, merge_coarse_octet=False), "merge_coarse_octet"),
        (dict(REF, quantize_proj=False, fold_coarse_fc=False), "fold_coarse_fc"),
        (dict(merge_src_feat=True, sigma_query_cull=True), "sigma_query_cull"),
    ],
)
def test_build_render_still_raises_for_what_is_not_ported(tpu, key):
    """Combinations refused while the fused point-stage kernel had a closed
    table of libraries build: the kernel is built for the key they
    select."""
    r = port_get("render", "demo_render")(_cfg(port_cfg, **tpu), device="cpu")
    assert r.pallas_point and ps.check_key(r.kernel_form()) == r.kernel_form()
    assert r.kernel_form() not in ps.FORMS
