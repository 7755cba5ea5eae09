"""The modules behind the geometry-table switches (gpnerf_tpu_torch:
ops/grid_sample.py tables and samplers, models/sparse_net.py's four-table
and interleaved queries and dense-convolution stack, models/heads.py
`query_sigma_feat_octet`, the renderer's switch normalization and the
point-stage plain version on every geometry layout) against the JAX package
on the CPU, on inputs made from a seed with numpy: the table builders
bitwise from shared float inputs, the float32 samplers and queries within
1e-6, the dense stack within 1e-5, and the plain point stages against the
Pallas kernel in interpret mode."""

import itertools
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpnerf_tpu.ops.grid_sample as jgs
from gpnerf_tpu.config import cfg as jax_cfg
from gpnerf_tpu.models.sparse_net import occupancy_volume_dense as j_occ_dense
from gpnerf_tpu.models.sparse_net import sparse_net_dense_eval as j_dense_eval
from gpnerf_tpu.ops.pallas_point import fused_point_stages_tabs
from gpnerf_tpu.ops.pallas_point import pack_head_weights as jax_pack
from gpnerf_tpu.ops.sparse_conv import scatter_dense_rows as j_scatter_rows
from gpnerf_tpu.registry import get as jax_get
from gpnerf_tpu.render.base import src_norm as jax_src_norm
from gpnerf_tpu.train.checkpoint import load_eval_model as jax_load
import gpnerf_tpu_torch.ops.grid_sample as pgs
from gpnerf_tpu_torch.config import cfg as port_cfg
from gpnerf_tpu_torch.models.sparse_net import (
    SparseConvNet,
    occupancy_volume,
    occupancy_volume_dense,
    sparse_net_dense_eval,
)
from gpnerf_tpu_torch.ops import point_stages as ps
from gpnerf_tpu_torch.ops.sparse_conv import _gather_rows, scatter_dense, scatter_dense_rows
from gpnerf_tpu_torch.registry import get as port_get
from gpnerf_tpu_torch.render.base import batch_to_device, prepare_frame
from gpnerf_tpu_torch.render.demo import GEOMETRY_SWITCHES, Renderer
from gpnerf_tpu_torch.train.checkpoint import load_eval_model
from test_torch_float_rows import _geom_inputs, _table
from test_torch_point_forms import _heads, _port_weights

CKPT = os.path.join(os.path.dirname(__file__), "..", "artifacts", "bench_ckpt.pth")


def _t(x):
    return torch.from_numpy(np.array(x))


def _bits(x):
    """numpy view of a table for a bitwise comparison (uint32 words as int32)."""
    a = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


# ---------------------------------------------------------------------------
# table builders, bitwise from shared inputs


def test_interleave_midpoints_bitwise():
    vol = np.random.RandomState(0).randint(0, 256, size=(5, 6, 7, 32)).astype(np.uint8)
    got = pgs.interleave_midpoints_3d(_t(vol))
    ref = jgs.interleave_midpoints_3d(jnp.asarray(vol))
    assert tuple(got.shape) == (9, 11, 13, 32) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_int4_coarse_table_bitwise():
    vol = (np.random.RandomState(1).randn(6, 7, 8, 64) * 3).astype(np.float32)
    vol[0, 0, 0, :3] = [0.0, 1e-12, -1e-12]
    q_p, s_p = pgs.quantize_volume_i4(_t(vol))
    q_j, s_j = jgs.quantize_volume_i4(jnp.asarray(vol))
    np.testing.assert_array_equal(q_p.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_j))
    t_p = pgs.Int4Table(pgs.build_octet_table_3d(q_p))
    t_j = jgs.Int4Table(jgs.build_octet_table_3d(q_j))
    np.testing.assert_array_equal(t_p.table.numpy(), np.asarray(t_j.table))


def test_word_packed_tables_bitwise():
    rs = np.random.RandomState(2)
    q = rs.randint(0, 256, size=(5, 6, 7, 96)).astype(np.uint8)
    got = pgs.build_octet_table_3d_u32(_t(q))
    ref = jgs.build_octet_table_3d_u32(jnp.asarray(q))
    assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape == (6, 7, 8, 192)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    # the bytes are the byte table's
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                  pgs.build_octet_table_3d(_t(q)).numpy())
    # the corner scatter in 32-bit words
    shape = (6, 7, 5)
    coords = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"), -1).reshape(-1, 3)
    coords = coords[rs.permutation(len(coords))[:80]].astype(np.int64)
    valid = rs.rand(80) > 0.2
    feats = np.where(valid[:, None], rs.randint(0, 256, size=(80, 32)), 0).astype(np.uint8)
    t_j = jgs.build_octet_table_scatter(jnp.asarray(feats), jnp.asarray(coords, jnp.int32),
                                        jnp.asarray(valid), shape, pack_words=True)
    for pack in (True, False):
        t_p = pgs.build_octet_table_scatter(_t(feats), _t(coords), _t(valid), shape, pack_words=pack)
        assert t_p.shape == t_j.shape and t_p.rows.dtype == torch.uint8
        np.testing.assert_array_equal(t_p.rows.numpy(), np.asarray(t_j.rows))


@pytest.mark.parametrize("layout", ["unfolded", "four-level", "coarse-octet", "coarse-nearest-div4",
                                    "dense-level1-bf16", "l1-nearest-rows"])
def test_geometry_tables_bitwise_from_shared_volume(layout):
    """The quantized tables and scales of each layout from the same float
    volume: the unfolded merged coarse field (u8, 96 channels), a coarse
    level volume in bf16 as the four-table layout quantizes it, the folded
    field as int8 octet and as the native-grid nearest table, the dense
    level-1 volume of dense_conv in bf16, and the level-1 nearest rows
    scattered from quantized active rows."""
    rs = np.random.RandomState(3)
    if layout == "l1-nearest-rows":
        from gpnerf_tpu_torch.ops.sparse_conv import SparseLevel

        shape = (6, 7, 5)
        coords = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"),
                          -1).reshape(-1, 3)[rs.permutation(210)[:90]]
        valid = rs.rand(90) > 0.1
        rows = np.maximum(rs.randn(90, 32), 0).astype(np.float32)
        rows0 = np.where(valid[:, None], rows, 0.0).astype(np.float32)
        q_j, s_j = jgs.quantize_volume_u8(jnp.asarray(rows0))
        q_p, s_p = pgs.quantize_volume_u8(_t(rows0))
        jl = type("L", (), {"coords": jnp.asarray(coords, jnp.int32), "valid": jnp.asarray(valid),
                            "shape": shape})
        ref = j_scatter_rows(q_j, jl)
        pl = SparseLevel(_t(coords), _t(valid), None, None, shape)
        got = scatter_dense_rows(q_p, pl)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        up_p = pgs.interleave_midpoints_3d(got.reshape(shape + (32,)))
        up_j = jgs.interleave_midpoints_3d(ref.reshape(shape + (32,)))
        np.testing.assert_array_equal(up_p.numpy(), np.asarray(up_j))
        np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_j))
        return
    C = {"unfolded": 96, "four-level": 32, "dense-level1-bf16": 32}.get(layout, 64)
    vol = (rs.randn(6, 7, 8, C) * 2).astype(np.float32)
    if layout in ("unfolded", "four-level", "dense-level1-bf16"):
        vol = np.maximum(vol, 0.0)  # post-ReLU levels
    if layout in ("four-level", "dense-level1-bf16"):
        # the level volumes are cast to the compute dtype first, and the
        # scale is computed in it
        v_p, v_j = _t(vol).to(torch.bfloat16), jnp.asarray(vol, jnp.bfloat16)
    else:
        v_p, v_j = _t(vol), jnp.asarray(vol)
    if layout in ("coarse-octet", "coarse-nearest-div4"):
        q_p, s_p = pgs.quantize_image_i8(v_p)
        q_j, s_j = jgs.quantize_image_i8(v_j)
    else:
        q_p, s_p = pgs.quantize_volume_u8(v_p)
        q_j, s_j = jgs.quantize_volume_u8(v_j)
    np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(q_p.numpy(), np.asarray(q_j))
    if layout == "coarse-nearest-div4":
        t_p = pgs.NearestTable(q_p.reshape(-1, C), tuple(vol.shape[:3]), 4)
        t_j = jgs.NearestTable(q_j.reshape(-1, C), vol.shape[:3], 4)
        np.testing.assert_array_equal(t_p.rows.numpy(), np.asarray(t_j.rows))
        assert t_p.shape == tuple(t_j.shape) and t_p.div == t_j.div
        return
    np.testing.assert_array_equal(pgs.build_octet_table_3d(q_p).numpy(),
                                  np.asarray(jgs.build_octet_table_3d(q_j)))


# ---------------------------------------------------------------------------
# samplers and queries, float32


def _positions(rs, P, shape):
    return (rs.rand(P, 3) * (np.array(shape) + 1.0) - 0.5).astype(np.float32)


@pytest.mark.parametrize("lerp_axes", [0, 1, 2, 4, 3, 7])
def test_nearest_rows_lerp_axes_and_interleave(lerp_axes):
    rs = np.random.RandomState(4 + lerp_axes)
    shape = (5, 6, 7)
    rows = rs.randint(0, 256, size=(210, 32)).astype(np.uint8)
    sc = (0.01 + rs.rand(32) * 0.02).astype(np.float32)
    pos = _positions(rs, 400, shape)
    size = np.array([5, 6, 6])
    for interleave in (1, 2):
        t_p = pgs.NearestTable(_t(rows), shape, 2, interleave, lerp_axes)
        t_j = jgs.NearestTable(jnp.asarray(rows), shape, 2, interleave, lerp_axes)
        got = pgs.nearest_rows(t_p, _t(pos), _t(size), _t(sc))
        ref = jgs.nearest_rows(t_j, jnp.asarray(pos), jnp.asarray(size), jnp.asarray(sc))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
        if not lerp_axes:
            r_p, w_p = pgs.nearest_row_and_weight(t_p, _t(pos), _t(size))
            r_j, w_j = jgs.nearest_row_and_weight(t_j, jnp.asarray(pos), jnp.asarray(size))
            np.testing.assert_array_equal(r_p.numpy(), np.asarray(r_j))
            np.testing.assert_array_equal(w_p.numpy(), np.asarray(w_j))


@pytest.mark.parametrize("kind", ["flat_u8", "dense_u8", "dense_i8", "u32", "int4", "bf16", "f32"])
def test_trilinear_octet_rows_every_table_kind(kind):
    rs = np.random.RandomState(5)
    shape = (4, 5, 6)
    size = np.array([4, 5, 5])
    pos = _positions(rs, 300, shape)
    sc = (0.01 + rs.rand(32) * 0.02).astype(np.float32)
    if kind in ("bf16", "f32"):
        vol = rs.randn(*shape, 32).astype(np.float32)
        v_j = jnp.asarray(vol, jnp.bfloat16 if kind == "bf16" else jnp.float32)
        v_p = _t(vol).to(torch.bfloat16 if kind == "bf16" else torch.float32)
        t_j, t_p, sc = jgs.build_octet_table_3d(v_j), pgs.build_octet_table_3d(v_p), None
    elif kind == "int4":
        q_j, sc = jgs.quantize_volume_i4(jnp.asarray(rs.randn(*shape, 32).astype(np.float32)))
        t_j = jgs.Int4Table(jgs.build_octet_table_3d(q_j))
        t_p = pgs.Int4Table(pgs.build_octet_table_3d(_t(q_j)))
        sc = np.asarray(sc)
    else:
        dt = np.int8 if kind == "dense_i8" else np.uint8
        lo, hi = (-127, 128) if kind == "dense_i8" else (0, 256)
        q = rs.randint(lo, hi, size=shape + (32,)).astype(dt)
        if kind == "u32":
            t_j, t_p = jgs.build_octet_table_3d_u32(jnp.asarray(q)), pgs.build_octet_table_3d_u32(_t(q))
        else:
            t_j, t_p = jgs.build_octet_table_3d(jnp.asarray(q)), pgs.build_octet_table_3d(_t(q))
        if kind == "flat_u8":
            dp = tuple(s + 1 for s in shape)
            t_j = jgs.FlatOctetTable(t_j.reshape(-1, 256), dp)
            t_p = pgs.FlatOctetTable(t_p.reshape(-1, 256), dp)
    for out_dtype in (None, torch.bfloat16):
        jdt = None if out_dtype is None else jnp.bfloat16
        got = pgs.trilinear_octet_rows(t_p, _t(pos), _t(size), None if sc is None else _t(sc),
                                       out_dtype)
        ref = jgs.trilinear_octet_rows(t_j, jnp.asarray(pos), jnp.asarray(size),
                                       None if sc is None else jnp.asarray(sc), jdt)
        # a tensor of the dtype JAX's array has
        assert str(got.dtype).split(".")[-1] == str(ref.dtype), (got.dtype, ref.dtype)
        ref = np.asarray(ref, np.float32)
        got = got.float()
        if out_dtype is None and kind != "bf16":
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
        else:
            # bf16 arithmetic: a float32 ulp before a rounding moves a value
            # by at most one bf16 step
            np.testing.assert_allclose(got.numpy(), ref, rtol=2 ** -7, atol=1e-6)
            assert np.mean(got.numpy() != ref) < 0.01
    if kind in ("dense_u8", "dense_i8", "bf16", "f32"):
        # the kernel's gather half on a dense 4-D table
        r_p, w_p = pgs.octet_rows_and_weights(t_p, _t(pos), _t(size))
        r_j, w_j = jgs.octet_rows_and_weights(t_j, jnp.asarray(pos), jnp.asarray(size))
        np.testing.assert_array_equal(r_p.float().numpy(), np.asarray(r_j, np.float32))
        np.testing.assert_array_equal(w_p.numpy(), np.asarray(w_j))


@pytest.fixture(scope="module")
def frame():
    """One 64^2 synthetic frame with the trained checkpoint, float32: the
    JAX renderer and variables, its grids' SMPL features, fused vertex codes
    at the level-0 rows, level features, dense-stack volumes and occupancy,
    and the port's renderer with its own prepared frame."""
    def cfg_of(base):
        cfg = base.clone()
        cfg.defrost()
        cfg.merge_from_file("configs/synthetic.yaml")
        cfg.dataset.H = cfg.dataset.W = 64
        cfg.head.sigma.code_dim = 32
        cfg.render.file = "demo_render"
        cfg.tpu.matmul_dtype = "float32"
        cfg.freeze()
        return cfg

    cfg = cfg_of(jax_cfg)
    np.random.seed(0)
    random.seed(0)
    batch = jax_get("dataset", cfg.dataset.test.file)(cfg, is_train=False)[0]
    jr = jax_get("render", "demo_render")(cfg)
    shapes = jax.eval_shape(lambda key: jr._init_variables_impl(key, batch), jax.random.PRNGKey(0))
    variables = jax_load(CKPT, jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes), 4)
    hv = variables["head"]

    @jax.jit
    def jax_frame(variables, b):
        featmaps = jr.encoder.apply(variables["encoder"], jax_src_norm(b["src_imgs"]))
        pre = jr.prepare_frame(b, featmaps)
        fused = jr.nerfhead.apply(hv, pre["smpl_feat"], method=lambda m, s: m.sigmahead.fuse_codes(s))
        vr = pre["vertex_rows"]
        code = jnp.where((vr >= 0)[:, None], fused[jnp.maximum(vr, 0)], 0.0)
        vols = j_dense_eval(hv["params"]["sigmahead"]["xyzc_net"],
                            hv["batch_stats"]["sigmahead"]["xyzc_net"], code, pre["grids"])
        return featmaps, code, vols, j_occ_dense(vols), j_occ_dense(vols, levels=(0,))

    featmaps, code, vols, occ, occ1 = jax.tree_util.tree_map(
        np.asarray, jax_frame(variables, {k: jnp.asarray(v) for k, v in batch.items()}))
    port = port_get("render", "demo_render")(cfg_of(port_cfg), device="cpu")
    load_eval_model(CKPT, port)
    pb = batch_to_device(batch, "cpu")
    with torch.no_grad():
        pre = prepare_frame(pb, _t(featmaps), port.max_out_sh)
    return {"jr": jr, "hv": hv, "code": code, "vols": vols, "occ": occ, "occ1": occ1,
            "port": port, "pre": pre}


def test_sparse_net_dense_eval_matches_jax_and_rows_path(frame):
    """The dense-convolution stack from the same fused codes: against the
    JAX package's, and against the port's own rows path scattered dense
    (dense 3D convolutions over the level volumes, re-masked, equal the
    submanifold convolutions up to the order of the float32 sums)."""
    port, pre = frame["port"], frame["pre"]
    net = port.nerfhead.sigmahead.xyzc_net
    with torch.no_grad():
        vols = sparse_net_dense_eval(net, _t(frame["code"]), pre["grids"])
        rows = net.features(_t(frame["code"]), pre["grids"])
    for i, (v, vj) in enumerate(zip(vols, frame["vols"])):
        assert tuple(v.shape) == vj.shape and v.dtype == torch.float32
        np.testing.assert_allclose(v.numpy(), vj, rtol=1e-5, atol=1e-5, err_msg=f"level {i + 1}")
        dense_rows = scatter_dense(rows[i], pre["grids"][i + 1])
        np.testing.assert_allclose(v.numpy(), dense_rows.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=f"level {i + 1} rows")
    assert sum(float(v.abs().sum()) for v in vols) > 0
    occ = occupancy_volume_dense(vols)
    np.testing.assert_allclose(occ.numpy(), frame["occ"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(occupancy_volume_dense(vols, levels=(0,)).numpy(), frame["occ1"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(occ.numpy(), occupancy_volume(rows, pre["grids"]).numpy(),
                               rtol=1e-5, atol=1e-5)
    # the code the renderer's dense path gathers is the shared input
    with torch.no_grad():
        fused = port.nerfhead.sigmahead.fuse_codes(pre["smpl_feat"])
        np.testing.assert_allclose(_gather_rows(fused, pre["vertex_rows"]).numpy(), frame["code"],
                                   rtol=1e-4, atol=1e-5)


def _query_tables(rs, out_sh):
    """Seeded level tables of an out_sh frame: four u8 octet levels with
    scales, the interleaved level-1 nearest table and the unfolded merged
    coarse octet table (96 channels)."""
    lv = [tuple(int(s) >> (i + 1) for s in out_sh) for i in range(4)]
    octs, scs = [], []
    for shape in lv:
        q = rs.randint(0, 256, size=shape + (32,)).astype(np.uint8)
        octs.append(q)
        scs.append((0.01 + rs.rand(32) * 0.02).astype(np.float32))
    up = jgs.interleave_midpoints_3d(jnp.asarray(octs[0]))
    near = np.asarray(up).reshape(-1, 32), tuple(up.shape[:3])
    coarse = rs.randint(0, 256, size=lv[1] + (96,)).astype(np.uint8)
    return lv, octs, scs, near, coarse, (0.01 + rs.rand(96) * 0.02).astype(np.float32)


def test_query_octet_and_interleaved_query_octet2(frame):
    rs = np.random.RandomState(6)
    out_sh = np.array([16, 24, 20])
    lv, octs, scs, (near_rows, near_shape), coarse, csc = _query_tables(rs, out_sh)
    dhw = (rs.rand(500, 3) * (out_sh + 2) - 1).astype(np.float32)
    net_j = frame["jr"].nerfhead
    hv = frame["hv"]
    # four octet tables (dense) and the word-packed ones
    for pack in (False, True):
        build_j = jgs.build_octet_table_3d_u32 if pack else jgs.build_octet_table_3d
        build_p = pgs.build_octet_table_3d_u32 if pack else pgs.build_octet_table_3d
        ref = net_j.apply(hv, [build_j(jnp.asarray(q)) for q in octs], jnp.asarray(dhw),
                          jnp.asarray(out_sh), scales=[jnp.asarray(s) for s in scs],
                          method=lambda m, *a, **k: m.sigmahead.xyzc_net.query_octet(*a, **k))
        got = frame["port"].nerfhead.sigmahead.xyzc_net.query_octet(
            [build_p(_t(q)) for q in octs], _t(dhw), _t(out_sh), scales=[_t(s) for s in scs])
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    # interleaved level-1 nearest + unfolded coarse octet
    t_j = (jgs.NearestTable(jnp.asarray(near_rows), near_shape, 2, 2),
           jgs.build_octet_table_3d(jnp.asarray(coarse)))
    t_p = (pgs.NearestTable(_t(near_rows), near_shape, 2, 2), pgs.build_octet_table_3d(_t(coarse)))
    sc = (scs[0], csc)
    ref = net_j.apply(hv, *t_j, jnp.asarray(dhw), jnp.asarray(out_sh),
                      scales=[jnp.asarray(s) for s in sc],
                      method=lambda m, *a, **k: m.sigmahead.xyzc_net.query_octet2(*a, **k))
    got = SparseConvNet.query_octet2(*t_p, _t(dhw), _t(out_sh), scales=[_t(s) for s in sc])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_query_sigma_feat_octet(frame):
    """The unfolded 128-channel sigma feature (with the level-1 occupancy)
    from two tables and from four."""
    rs = np.random.RandomState(7)
    out_sh = np.array([16, 24, 20])
    lv, octs, scs, _, coarse, csc = _query_tables(rs, out_sh)
    dhw = (rs.rand(500, 3) * (out_sh + 2) - 1).astype(np.float32)
    head_j, hv = frame["jr"].nerfhead, frame["hv"]
    sig = frame["port"].nerfhead.sigmahead
    for tabs, sc in (
        ((octs[0], coarse), (scs[0], csc)),
        (tuple(octs), tuple(scs)),
    ):
        ref_f, ref_o = head_j.apply(
            hv, [jgs.build_octet_table_3d(jnp.asarray(q)) for q in tabs], jnp.asarray(dhw),
            jnp.asarray(out_sh), scales=[jnp.asarray(s) for s in sc], with_l1_occ=True,
            method=lambda m, *a, **k: m.sigmahead.query_sigma_feat_octet(*a, **k))
        with torch.no_grad():
            got_f, got_o = sig.query_sigma_feat_octet(
                [pgs.build_octet_table_3d(_t(q)) for q in tabs], _t(dhw), _t(out_sh),
                scales=[_t(s) for s in sc], with_l1_occ=True)
        np.testing.assert_allclose(got_f.numpy(), np.asarray(ref_f), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_o.numpy(), np.asarray(ref_o), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# switch normalization


# raw values in GEOMETRY_SWITCHES order: quantize_volume, merge_coarse_octet,
# fold_coarse_fc, int4_coarse, coarse_nearest, l1_nearest, pack_octet_u32,
# dense_conv (which nothing narrows)
RAW_SWITCHES = list(itertools.product(
    (True, False), (True, False), (True, False), (False, True), (0, 1, 2), (0, 1, 2, 11),
    (False, True), (False,)))


def test_switch_normalization_matches_jax():
    """The effective geometry switches (JAX render/demo.py:181-219) over a
    grid of raw settings: the port's Renderer holds what JAX's DemoRender
    holds."""
    def cfg_of(vals):
        cfg = jax_cfg.clone()
        cfg.defrost()
        cfg.merge_from_file("configs/synthetic.yaml")
        for k, v in zip(GEOMETRY_SWITCHES, vals):
            cfg.tpu[k] = v
        cfg.freeze()
        return cfg

    for vals in RAW_SWITCHES:
        raw = dict(zip(GEOMETRY_SWITCHES, vals))
        jr = jax_get("render", "demo_render")(cfg_of(vals))
        pr = Renderer(None, None, voxel_size=(0.005,) * 3, pallas_point=False, **raw)
        for k in GEOMETRY_SWITCHES:
            want = getattr(jr, k)
            assert getattr(pr, k) == (int(want) if k in ("coarse_nearest", "l1_nearest")
                                      else bool(want)), (raw, k)


# ---------------------------------------------------------------------------
# the plain point stages on every geometry layout against Pallas interpret


LAYOUT_FORMS = ["a@coarse-octet", "a@unfolded", "a@four-level", "a@l1-nearest", "a@float",
                "a@float32", "c@coarse-octet", "c@unfolded", "c@four-level", "c@l1-nearest",
                "c@float", "a+e@l1-nearest", "a+b@128"]
KEYS = {name: key for key, name in ps.FORMS.items()}


@pytest.mark.parametrize("name", LAYOUT_FORMS)
def test_layout_plain_matches_pallas_interpret(name):
    """Every new point-stage library's function (the plain version) against
    JAX `fused_point_stages_tabs(..., interpret=True)` on the same seeded
    rows (tests/test_pallas_point.py:106's pattern): the 128-wide layouts
    with the checkpoint's own sigma-feat weight, the 96-wide ones folded."""
    rows, layout, occ = KEYS[name][:3]
    rs = np.random.RandomState(8)
    P, V, CS, CF = 300, ps.V, ps.CS, ps.CF
    widths = (ps.C,) if len(rows) == 1 else (CS, CF)
    tabs = [_table(rs, kind, Ct, V, P) for kind, Ct in zip(rows, widths)]
    feats, geom = _geom_inputs(rs, layout, P, occ)
    # bf16 tables: both sides take the bf16 values of the float rows
    geom = [(g, w, sc, kind) for (g, w, sc), (_, _, kind) in zip(geom, ps.GEOMS[layout])]
    vmask = (rs.rand(V, P) > 0.15).astype(np.float32)
    sig_ok = rs.rand(P) > 0.2
    F = sum(t[1] for t in ps.GEOMS[layout])
    fold = ps.C0 if F == ps.C0 + ps.C1 else None
    hp = _heads(V, CS + CF, 128)
    t_args = (tuple((torch.from_numpy(r).to(torch.bfloat16) if bf else torch.from_numpy(r), _t(w),
                     _t(s)) for r, w, s, bf in tabs),
              None if feats is None else _t(feats), _t(vmask), _t(sig_ok), _port_weights(hp, fold))
    j_args = (tuple((jnp.asarray(r, jnp.bfloat16) if bf else jnp.asarray(r), jnp.asarray(w),
                     jnp.asarray(s)) for r, w, s, bf in tabs),
              None if feats is None else jnp.asarray(feats), jnp.asarray(vmask),
              jnp.asarray(sig_ok), jax_pack(hp, CS + CF, fold_nch=fold))
    t_kw = {"geom_tabs": tuple((torch.from_numpy(g).to(torch.bfloat16) if k == "bf16" else _t(g),
                                _t(w), _t(s)) for g, w, s, k in geom)}
    j_kw = {"geom_tabs": tuple((jnp.asarray(g, jnp.bfloat16) if k == "bf16" else jnp.asarray(g),
                                jnp.asarray(w), jnp.asarray(s)) for g, w, s, k in geom)}
    if occ:
        t_kw["occ_geom"] = j_kw["occ_geom"] = True
    out_j = [np.asarray(o) for o in fused_point_stages_tabs(*j_args, block=256, interpret=True,
                                                           **j_kw)]
    out = [o.numpy() for o in ps.point_stages_tabs_plain(*t_args, **t_kw)]
    assert len(out) == len(out_j) == (3 if occ else 2)
    a, rgb = out[:2]
    a_j, rgb_j = out_j[:2]
    # the recorded bf16 rounding flips (ROADMAP Queue 3): a float32 ulp moves
    # a dot input across a bf16 rounding edge for about 1 point in 700,
    # up to 0.06 in alpha; the rest within 1e-6
    d = np.abs(a - a_j)
    assert (d > 1e-6).sum() <= 2 and d.max() < 0.08, np.sort(d)[-4:]
    alive, alive_j = a > 1e-14, a_j > 1e-14
    assert (alive != alive_j).sum() <= 1
    dr = np.abs(rgb - rgb_j)[alive == alive_j].max(axis=1)
    assert (dr > 1e-6).sum() <= 4 and dr.max() < 0.08, np.sort(dr)[-8:]
    assert alive.mean() > 0.2 and (rgb[alive] > 0).all()
    if occ:
        np.testing.assert_array_equal(out[2], out_j[2])
