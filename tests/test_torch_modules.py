"""Module-level parity of the port (gpnerf_tpu_torch) against the JAX package
on one seeded 64^2 synthetic frame with the trained checkpoint, float32:
encoder featmaps, SMPL features and code fusion, the sparse conv level
features and occupancy field, the gather tables (bitwise from a shared
float input), the row gathers, rays and the heads. The port's copies of the
config and data pipeline must build the same batch as the JAX package's."""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpnerf_tpu.ops.grid_sample as jgs
from gpnerf_tpu.config import cfg as jax_cfg
from gpnerf_tpu.ops.projection import project_gather_rows_merged as jax_rows_merged
from gpnerf_tpu.ops.rays import pixel_rays as jax_pixel_rays
from gpnerf_tpu.ops.rays import ray_aabb_near_far as jax_near_far
from gpnerf_tpu.registry import get as jax_get
from gpnerf_tpu.render.base import src_norm as jax_src_norm
from gpnerf_tpu.train.checkpoint import load_eval_model as jax_load
import gpnerf_tpu_torch.ops.grid_sample as pgs
from gpnerf_tpu_torch.config import cfg as port_cfg
from gpnerf_tpu_torch.models.encoder import ResUNet
from gpnerf_tpu_torch.models.sparse_net import SparseConvNet, occupancy_volume
from gpnerf_tpu_torch.ops.projection import project_gather_rows_merged
from gpnerf_tpu_torch.ops.rays import pixel_rays, ray_aabb_near_far
from gpnerf_tpu_torch.registry import get as port_get
from gpnerf_tpu_torch.render.base import batch_to_device, prepare_frame, src_norm
from gpnerf_tpu_torch.train.checkpoint import load_eval_model
from test_torch_datasets import same_host_kernels  # noqa: F401  (autouse: host-kernel route)

CKPT = os.path.join(os.path.dirname(__file__), "..", "artifacts", "bench_ckpt.pth")


def _cfg(base, size=64):
    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file("configs/synthetic.yaml")
    cfg.dataset.H = cfg.dataset.W = size
    cfg.head.sigma.code_dim = 32
    cfg.render.file = "demo_render"
    cfg.tpu.matmul_dtype = "float32"
    cfg.freeze()
    return cfg


def _np(x):
    return np.asarray(x) if not isinstance(x, torch.Tensor) else x.detach().numpy()


@pytest.fixture(scope="module")
def frame():
    cfg = _cfg(jax_cfg)
    np.random.seed(0)
    random.seed(0)
    batch = jax_get("dataset", cfg.dataset.test.file)(cfg, is_train=False)[0]
    jr = jax_get("render", "demo_render")(cfg)
    shapes = jax.eval_shape(
        lambda key: jr._init_variables_impl(key, batch), jax.random.PRNGKey(0)
    )
    variables = jax_load(
        CKPT, jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes), 4
    )
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def jax_frame(variables, b):
        featmaps = jr.encoder.apply(variables["encoder"], jax_src_norm(b["src_imgs"]))
        pre = jr.prepare_frame(b, featmaps)
        fused = jr.nerfhead.apply(
            variables["head"], pre["smpl_feat"],
            method=lambda m, s: m.sigmahead.fuse_codes(s),
        )
        feats = jr.nerfhead.apply(
            variables["head"], pre["smpl_feat"], pre["vertex_rows"], pre["grids"],
            train=False, method="volume",
        )
        from gpnerf_tpu.models.sparse_net import occupancy_volume as jocc

        return featmaps, pre["smpl_feat"], fused, feats, jocc(feats, pre["grids"])

    jout = jax.tree_util.tree_map(np.asarray, jax_frame(variables, jb))
    port = port_get("render", "demo_render")(_cfg(port_cfg), device="cpu")
    load_eval_model(CKPT, port)
    return {"batch": batch, "jr": jr, "variables": variables, "jax": jout,
            "port": port, "pb": batch_to_device(batch, "cpu")}


def test_config_copy_matches():
    assert _cfg(port_cfg) == _cfg(jax_cfg)


def test_dataset_copy_builds_the_same_batch(frame):
    cfg = _cfg(port_cfg)
    np.random.seed(0)
    random.seed(0)
    pbatch = port_get("dataset", cfg.dataset.test.file)(cfg, is_train=False)[0]
    assert set(pbatch) == set(frame["batch"])
    for k, v in frame["batch"].items():
        assert np.asarray(pbatch[k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(pbatch[k], v, err_msg=k)


def test_encoder_featmaps(frame):
    featmaps = frame["jax"][0]
    with torch.no_grad():
        out = frame["port"].encoder(src_norm(frame["pb"]["src_imgs"])).numpy()
    assert out.shape == featmaps.shape == (3, 16, 16, 32)
    # float32 convolutions summed in another order through 23 conv layers
    # with InstanceNorm: measured max |d| 6.5e-5 at mean |featmap| 0.55
    np.testing.assert_allclose(out, featmaps, atol=3e-4, rtol=1e-4)


def test_encoder_featmaps_bf16(frame):
    """compute_dtype bf16 (the shipped tpu.matmul_dtype): conv operands
    rounded to bf16, float32 accumulation, bf16 conv outputs."""
    jenc = frame["jr"].encoder.clone(compute_dtype=jnp.bfloat16)
    ref = np.asarray(
        jax.jit(jenc.apply)(frame["variables"]["encoder"],
                            jax_src_norm(jnp.asarray(frame["batch"]["src_imgs"])))
    ).astype(np.float32)
    enc = ResUNet(32, "resnet34", torch.bfloat16)
    enc.load_state_dict(frame["port"].encoder.state_dict())
    with torch.no_grad():
        out = enc(src_norm(frame["pb"]["src_imgs"]))
    assert out.dtype == torch.bfloat16  # real bf16 feature maps, as JAX's
    out = out.float().numpy()
    # two bf16 computations whose sums run in different orders drift apart
    # at bf16 resolution (1 ulp = 0.0156 at magnitude 2-4) through 23 conv
    # layers, exactly as far as JAX's own bf16 and float32 encoders do:
    # measured port-vs-JAX bf16 median 0.0156 / 99th pct 0.094 / max 0.21,
    # JAX bf16-vs-f32 median 0.010 / 0.11 / 0.30, at mean |featmap| 0.55
    d = np.abs(out - ref)
    d_ref = np.abs(ref - frame["jax"][0])
    assert np.median(d) < 2 * np.median(d_ref), (np.median(d), np.median(d_ref))
    assert np.percentile(d, 99) < 2 * np.percentile(d_ref, 99)
    assert d.max() < 0.5
    assert np.abs(out - frame["jax"][0]).max() > 0  # the bf16 path really rounds


def test_smpl_features_code_fusion_and_volume(frame):
    featmaps, smpl_feat, fused, feats, masks3d = frame["jax"]
    port, pb = frame["port"], frame["pb"]
    with torch.no_grad():
        pre = prepare_frame(pb, torch.from_numpy(featmaps), port.max_out_sh)
        np.testing.assert_allclose(pre["smpl_feat"].numpy(), smpl_feat, atol=1e-4, rtol=1e-4)
        sf = torch.from_numpy(smpl_feat)
        p_fused = port.nerfhead.sigmahead.fuse_codes(sf)
        np.testing.assert_allclose(p_fused.numpy(), fused, atol=1e-5, rtol=1e-4)
        p_feats = port.nerfhead.volume(sf, pre["vertex_rows"], pre["grids"])
        p_occ = occupancy_volume(p_feats, pre["grids"])
    for i, (a, b) in enumerate(zip(p_feats, feats)):
        valid = pb[f"lvl{i + 1}_valid"].numpy()
        # 9 sparse convs + eval BatchNorm in float32, sums in another order
        np.testing.assert_allclose(_np(a)[valid], b[valid], atol=2e-4, rtol=2e-4, err_msg=f"level {i + 1}")
    assert p_occ.shape == masks3d.shape
    np.testing.assert_allclose(p_occ.numpy(), masks3d, atol=1e-3, rtol=1e-4)
    # the splat source's occupancy election is a threshold on masks3d
    np.testing.assert_array_equal(p_occ.numpy() > 0.1, masks3d > 0.1)


def test_quantized_tables_bitwise_from_shared_float_input(frame):
    feats = frame["jax"][3]
    pb = frame["pb"]
    valid = pb["lvl1_valid"]
    rows0 = np.where(valid.numpy()[:, None], feats[0], 0.0).astype(np.float32)
    q_p, s_p = pgs.quantize_volume_u8(torch.from_numpy(rows0))
    q_j, s_j = jgs.quantize_volume_u8(jnp.asarray(rows0))
    np.testing.assert_array_equal(q_p.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_j))
    shape = tuple(int(v) >> 1 for v in frame["port"].max_out_sh)
    t_p = pgs.build_octet_table_scatter(q_p, pb["lvl1_coords"], valid, shape)
    t_j = jgs.build_octet_table_scatter(
        q_j, jnp.asarray(pb["lvl1_coords"].numpy(), jnp.int32), jnp.asarray(valid.numpy()), shape
    )
    assert t_p.shape == t_j.shape
    np.testing.assert_array_equal(t_p.rows.numpy(), np.asarray(t_j.rows))
    # int8 image / volume quantization and the quad table
    rs = np.random.RandomState(3)
    img = (rs.randn(3, 17, 19, 35) * 2).astype(np.float32)
    qi_p, si_p = pgs.quantize_image_i8(torch.from_numpy(img))
    qi_j, si_j = jgs.quantize_image_i8(jnp.asarray(img))
    np.testing.assert_array_equal(qi_p.numpy(), np.asarray(qi_j))
    np.testing.assert_array_equal(si_p.numpy(), np.asarray(si_j))
    np.testing.assert_array_equal(
        pgs.build_quad_table_2d(qi_p).numpy(), np.asarray(jgs.build_quad_table_2d(qi_j))
    )
    vol = rs.randint(0, 255, size=(5, 6, 7, 4)).astype(np.uint8)
    np.testing.assert_array_equal(
        pgs.build_octet_table_3d(torch.from_numpy(vol)).numpy(),
        np.asarray(jgs.build_octet_table_3d(jnp.asarray(vol))),
    )


def test_resample_matrices_and_volumes(frame):
    for n_out, n_in, so, si in ((160, 80, 128, 64), (80, 40, 64, 16), (16, 4, 16, 4)):
        m_p = pgs._axis_resample_matrix(n_out, n_in, so, si)
        m_j = np.asarray(jgs._axis_resample_matrix(
            n_out, n_in, jnp.asarray(so, jnp.int32), jnp.asarray(si, jnp.int32)))
        np.testing.assert_array_equal(m_p, m_j)
    rs = np.random.RandomState(4)
    vol = rs.randn(6, 10, 7, 5).astype(np.float32)
    out_p = pgs.resample_volume_to(torch.from_numpy(vol), (12, 20, 14), (12, 16, 14), (6, 8, 7))
    out_j = jgs.resample_volume_to(jnp.asarray(vol), (12, 20, 14),
                                   jnp.asarray([12, 16, 14]), jnp.asarray([6, 8, 7]))
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_j), atol=1e-6, rtol=1e-6)
    img = rs.rand(3, 9, 11, 4).astype(np.float32)
    np.testing.assert_allclose(
        pgs.upsample_image_align_corners(torch.from_numpy(img), 5, 6).numpy(),
        np.asarray(jgs.upsample_image_align_corners(jnp.asarray(img), 5, 6)),
        atol=1e-6, rtol=1e-6,
    )


def test_level1_table_end_to_end_lsb_budget(frame):
    """From each package's own level features the u8 level-1 codes may
    differ by float summation order: within 1 LSB on <= 0.1% of entries."""
    feats = frame["jax"][3]
    pb = frame["pb"]
    valid = pb["lvl1_valid"]
    with torch.no_grad():
        pre = prepare_frame(pb, torch.from_numpy(frame["jax"][0]), frame["port"].max_out_sh)
        p_feats = frame["port"].nerfhead.volume(pre["smpl_feat"], pre["vertex_rows"], pre["grids"])
    q_p, _ = pgs.quantize_volume_u8(torch.where(valid[:, None], p_feats[0], 0.0))
    q_j, _ = jgs.quantize_volume_u8(jnp.asarray(np.where(valid.numpy()[:, None], feats[0], 0.0)))
    d = np.abs(q_p.numpy().astype(np.int32) - np.asarray(q_j).astype(np.int32))
    assert d.max() <= 1
    assert (d > 0).mean() <= 1e-3, (d > 0).sum()


def test_row_gathers_bitwise(frame):
    rs = np.random.RandomState(5)
    P = 500
    vol = rs.randint(0, 255, size=(6, 7, 8, 32)).astype(np.uint8)
    oct_j = jgs.FlatOctetTable(
        jgs.build_octet_table_3d(jnp.asarray(vol)).reshape(-1, 256), (7, 8, 9))
    oct_p = pgs.FlatOctetTable(torch.from_numpy(np.asarray(oct_j.rows)), (7, 8, 9))
    pos = (rs.rand(P, 3) * np.array([7.0, 8.0, 9.0]) - 0.7).astype(np.float32)
    size = np.array([6, 7, 8])
    r_j, w_j = jgs.octet_rows_and_weights(oct_j, jnp.asarray(pos), jnp.asarray(size))
    r_p, w_p = pgs.octet_rows_and_weights(oct_p, torch.from_numpy(pos), torch.from_numpy(size))
    np.testing.assert_array_equal(r_p.numpy(), np.asarray(r_j))
    np.testing.assert_array_equal(w_p.numpy(), np.asarray(w_j))
    rows = rs.randint(-127, 127, size=(6 * 7 * 8, 64)).astype(np.int8)
    n_j = jgs.NearestTable(jnp.asarray(rows), (6, 7, 8), 2)
    n_p = pgs.NearestTable(torch.from_numpy(rows), (6, 7, 8), 2)
    r_j, w_j = jgs.nearest_row_and_weight(n_j, jnp.asarray(pos), jnp.asarray(size))
    r_p, w_p = pgs.nearest_row_and_weight(n_p, torch.from_numpy(pos), torch.from_numpy(size))
    np.testing.assert_array_equal(r_p.numpy(), np.asarray(r_j))
    np.testing.assert_array_equal(w_p.numpy(), np.asarray(w_j))
    # projection quad rows through the frame's cameras
    pb = frame["pb"]
    pre_ke = frame["jr"].prepare_frame(
        {k: jnp.asarray(v) for k, v in frame["batch"].items()}, jnp.asarray(frame["jax"][0])
    )["KE"]
    quad = rs.randint(-127, 127, size=(3, 17, 17, 140)).astype(np.int8)
    pts = (np.asarray(frame["batch"]["can_bounds"]).mean(0) + rs.randn(P, 3) * 0.1).astype(np.float32)
    rj, wj, vj = jax_rows_merged(jnp.asarray(pts), pre_ke, jnp.asarray(quad), 64, 64)
    with torch.no_grad():
        ke = prepare_frame(pb, torch.from_numpy(frame["jax"][0]), frame["port"].max_out_sh)["KE"]
    rp, wp, vp = project_gather_rows_merged(torch.from_numpy(pts), ke, torch.from_numpy(quad), 64, 64)
    np.testing.assert_allclose(ke.numpy(), np.asarray(pre_ke), rtol=1e-6)
    np.testing.assert_array_equal(vp.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(rp.numpy(), np.asarray(rj))
    np.testing.assert_allclose(wp.numpy(), np.asarray(wj), atol=1e-5)
    assert vp.numpy().mean() > 0.2


def test_rays_and_near_far(frame):
    b = frame["batch"]
    rs = np.random.RandomState(6)
    xy1 = np.stack([rs.rand(400) * 64, rs.rand(400) * 64, np.ones(400)], -1).astype(np.float32)
    tp = b["target_pose"]
    o_j, d_j = jax_pixel_rays(jnp.asarray(xy1), jnp.asarray(b["target_K_inv"]),
                              jnp.asarray(tp[:, :3]), jnp.asarray(tp[:, 3:]))
    t = torch.from_numpy
    o_p, d_p = pixel_rays(t(xy1), t(b["target_K_inv"]), t(tp[:, :3]), t(tp[:, 3:]))
    np.testing.assert_allclose(o_p.numpy(), np.asarray(o_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_j), rtol=1e-6, atol=1e-6)
    nj, fj, mj = jax_near_far(o_j, d_j, jnp.asarray(b["can_bounds"]))
    n_p, f_p, m_p = ray_aabb_near_far(t(np.asarray(o_j)), t(np.asarray(d_j)), t(b["can_bounds"]))
    np.testing.assert_array_equal(m_p.numpy(), np.asarray(mj))
    m = m_p.numpy()
    assert 0.05 < m.mean() < 0.95
    np.testing.assert_allclose(n_p.numpy()[m], np.asarray(nj)[m], rtol=1e-6)
    np.testing.assert_allclose(f_p.numpy()[m], np.asarray(fj)[m], rtol=1e-6)


def test_density_and_color_heads(frame):
    rs = np.random.RandomState(7)
    N, V, C = 300, 3, 35
    rgb_feat = (rs.randn(N, V, C) * 0.5).astype(np.float32)
    sigma_feat = rs.randn(N, 64).astype(np.float32)
    nvo = rs.randint(0, 4, size=(N, 1)).astype(np.float32)
    mean, var = rgb_feat.mean(1), rgb_feat.var(1)
    hv = frame["variables"]["head"]
    jr = frame["jr"]
    s_j = jr.nerfhead.apply(hv, jnp.asarray(sigma_feat), jnp.asarray(mean), jnp.asarray(var),
                            jnp.asarray(nvo), method=lambda m, *a: m.rgbhead.density(*a))
    c_j = jr.nerfhead.apply(hv, jnp.asarray(rgb_feat), jnp.asarray(mean[:, None]),
                            jnp.asarray(var[:, None]), method=lambda m, *a: m.rgbhead.color(*a))
    head = frame["port"].nerfhead.rgbhead
    t = torch.from_numpy
    with torch.no_grad():
        s_p = head.density(t(sigma_feat), t(mean), t(var), t(nvo))
        c_p = head.color(t(rgb_feat), t(mean[:, None]), t(var[:, None]))
    np.testing.assert_allclose(s_p.numpy(), np.asarray(s_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(c_p.numpy(), np.asarray(c_j), atol=1e-6, rtol=1e-5)
    assert (s_p.numpy()[nvo[:, 0] < 1] == 0).all()


def test_query_octet2(frame):
    """The two-table multi-scale query (level-1 octet + folded-coarse
    nearest) equals the JAX sparse net's query_octet2 on shared tables."""
    rs = np.random.RandomState(8)
    out_sh = np.array([32, 64, 48])
    l1 = (16, 32, 24)
    oct_rows = rs.randint(0, 255, size=(17 * 33 * 25 + 1, 256)).astype(np.uint8)
    near_rows = rs.randint(-127, 127, size=(16 * 32 * 24, 64)).astype(np.int8)
    sc = [(rs.rand(32) * 0.02).astype(np.float32), (rs.rand(64) * 0.02).astype(np.float32)]
    dhw = (rs.rand(600, 3) * (out_sh + 4) - 2).astype(np.float32)
    jt = (jgs.FlatOctetTable(jnp.asarray(oct_rows), (17, 33, 25)),
          jgs.NearestTable(jnp.asarray(near_rows), l1, 2))
    ref = frame["jr"].nerfhead.apply(
        frame["variables"]["head"], *jt, jnp.asarray(dhw), jnp.asarray(out_sh),
        scales=[jnp.asarray(x) for x in sc],
        method=lambda m, *a, **k: m.sigmahead.xyzc_net.query_octet2(*a, **k),
    )
    got = SparseConvNet.query_octet2(
        pgs.FlatOctetTable(torch.from_numpy(oct_rows), (17, 33, 25)),
        pgs.NearestTable(torch.from_numpy(near_rows), l1, 2),
        torch.from_numpy(dhw), torch.from_numpy(out_sh),
        scales=[torch.from_numpy(x) for x in sc],
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
