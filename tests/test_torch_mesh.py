"""The mesh path (`head.rgb.use_rgbhead False`) against the JAX package:
the port's copies of marching cubes and the PLY writer
(gpnerf_tpu_torch/ops/marching_cubes.py, utils/mesh_io.py), the dense
queries (ops/grid_sample.py `trilinear_dense_gather`, models/heads.py
`query_sigma_feat_dense`), both renderers' `render_mesh`
(render/demo.py: the grid over the occupied voxels' AABB, culled by the
trilinear occupancy; render/base.py: the dataset's visual hull) and
train/mesh_evaluator.py.

The renders are 128^2 frames of the synthetic scene at a 0.02 m voxel, with
the trained checkpoint, float32. Held: the cube's shape (the grid) exactly,
its alpha within 1e-4 (the dense query and the density MLP in torch ops
against XLA's; 2.4e-5 seen), the vertex and triangle counts and the
triangles exactly, the vertices within 2e-3 voxel (5.4e-4 seen).

Under `tpu.matmul_dtype bfloat16` the demo renderer's encoder and heads
compute in bf16 (BaseRender's do not, in either package). The JAX
package's level volumes are float32 there (its sparse convs return float32
sums), so the dense query reads float32 volumes in both packages: on the
same encoder features the sigma feature and sigma equal JAX's bit for bit.
End to end, bf16 rounding flips in the encoder and the sparse stack (one
ulp where the two float32 sums straddle a bf16 boundary) spread through the
InstanceNorms and BatchNorms: the port's bf16 cube is held nearer JAX's
bf16 cube than JAX's own float32 cube is, in max and median."""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnerf_tpu.config import cfg as jax_cfg
from gpnerf_tpu.ops import marching_cubes as jax_mc
from gpnerf_tpu.ops.grid_sample import trilinear_dense_gather as jax_gather
from gpnerf_tpu.registry import get as jax_get
from gpnerf_tpu.train.checkpoint import load_eval_model as jax_load
from gpnerf_tpu.train.mesh_evaluator import MeshEvaluator as JaxMeshEvaluator
from gpnerf_tpu.utils import mesh_io as jax_io
from gpnerf_tpu_torch.config import cfg as port_cfg
from gpnerf_tpu_torch.ops import marching_cubes as port_mc
from gpnerf_tpu_torch.ops.grid_sample import trilinear_dense_gather
from gpnerf_tpu_torch.registry import get as port_get
from gpnerf_tpu_torch.render.base import batch_to_device, check_train_scope
from gpnerf_tpu_torch.train.checkpoint import load_eval_model
from gpnerf_tpu_torch.train.mesh_evaluator import MeshEvaluator, voxel_boxes
from gpnerf_tpu_torch.utils import mesh_io

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "artifacts", "bench_ckpt.pth")
RENDERS = ("BaseRender", "demo_render")


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Whole-frame renders under parallel test files (tests/test_torch_opbyop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(base, result_dir=".", matmul_dtype="float32"):
    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "synthetic.yaml"))
    cfg.dataset.H = 128
    cfg.dataset.W = 128
    cfg.head.sigma.code_dim = 32
    cfg.head.rgb.use_rgbhead = False
    cfg.dataset.voxel_size = [0.02, 0.02, 0.02]
    cfg.tpu.eval_ray_cap = 4096
    cfg.tpu.eval_chunk = 1024
    cfg.tpu.matmul_dtype = matmul_dtype
    cfg.result_dir = str(result_dir)
    cfg.freeze()
    return cfg


def _fields():
    """Seeded cubes: smoothed noise at two sizes and a sphere's distance."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.RandomState(11)
    n = 24
    g = np.arange(n)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    sphere = 8.0 - np.sqrt((x - 11.5) ** 2 + (y - 11.5) ** 2 + (z - 11.5) ** 2)
    return {
        "noise-9": (gaussian_filter(rng.rand(9, 9, 9), 0.8), 0.5),
        "noise-16x12x20": (gaussian_filter(rng.rand(16, 12, 20), 1.2), 0.5),
        "sphere": (sphere, 0.0),
    }


@pytest.mark.parametrize("extractor", ["marching_cubes", "marching_tetrahedra"])
@pytest.mark.parametrize("field", list(_fields()))
def test_marching_cubes_matches_jax(field, extractor):
    vol, iso = _fields()[field]
    pv, pt = getattr(port_mc, extractor)(vol, iso)
    jv, jt = getattr(jax_mc, extractor)(vol, iso)
    assert len(pt) > 10
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pt, jt)


def test_ply_round_trip_matches_jax(tmp_path):
    """The port writes the bytes the JAX package writes, and each reads the
    other's file back to the written float32 vertices and the faces."""
    v, t = port_mc.marching_cubes(*_fields()["noise-16x12x20"])
    p = mesh_io.Trimesh(v, t).export(str(tmp_path / "port.ply"))
    j = jax_io.Trimesh(v, t).export(str(tmp_path / "jax.ply"))
    assert open(p, "rb").read() == open(j, "rb").read()
    for read, path in ((mesh_io.read_ply, j), (jax_io.read_ply, p)):
        rv, rf = read(path)
        np.testing.assert_array_equal(rv, v.astype(np.float32))
        np.testing.assert_array_equal(rf, t)
    obj = mesh_io.Trimesh(v, t).export(str(tmp_path / "port.obj"))
    assert open(obj).read() == open(jax_io.Trimesh(v, t).export(
        str(tmp_path / "jax.obj"))).read()


def test_trilinear_dense_gather_matches_jax():
    """Eight corners, zeros outside the dynamic extent (and the volume):
    positions inside, on the edges and outside (4,096 points)."""
    rng = np.random.default_rng(5)
    vol = rng.random((12, 10, 14)).astype(np.float32)
    pos = (rng.random((4096, 3)) * [14, 12, 16] - 1.0).astype(np.float32)
    pos[:64] = np.floor(pos[:64])  # on grid points
    size = np.array([11, 9, 12], np.int32)
    for dyn in (None, size):
        got = trilinear_dense_gather(torch.from_numpy(vol), torch.from_numpy(pos),
                                     None if dyn is None else torch.from_numpy(dyn)).numpy()
        want = np.asarray(jax_gather(jnp.asarray(vol), jnp.asarray(pos),
                                     None if dyn is None else jnp.asarray(dyn)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert (got == 0).sum() > 100 and (got > 0).sum() > 2000


@pytest.fixture(scope="module")
def frame():
    """The 128^2 test frame with the mesh grid, and the checkpoint's JAX
    variables, loaded once into a zero tree of `init_variables`' shapes
    (the strict load writes every leaf; tracing the shapes skips the eager
    init)."""
    cfg = _cfg(jax_cfg)
    np.random.seed(0)
    random.seed(0)
    b = jax_get("dataset", cfg.dataset.test.file)(cfg, is_train=False)[0]
    assert b["inside"].any()
    base = jax_get("render", "BaseRender")(cfg)
    shapes = jax.eval_shape(lambda: base.init_variables(0, b))
    return b, jax_load(CKPT, jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes), 4)


def _port(name, matmul_dtype="float32"):
    r = port_get("render", name)(_cfg(port_cfg, matmul_dtype=matmul_dtype), device="cpu")
    load_eval_model(CKPT, r)
    return r.eval()


def _query_sigma_feat_dense(frame, matmul_dtype):
    """(the port's, the JAX package's) sigma feature of the checkpoint's
    sigma head, computing in `matmul_dtype`, on seeded dense level volumes
    (zeros at a third of the sites) at 4,096 points across the frame's
    extent."""
    b, variables = frame
    jr = jax_get("render", "demo_render")(_cfg(jax_cfg, matmul_dtype=matmul_dtype))
    head = _port("demo_render", matmul_dtype).nerfhead
    out_sh = np.asarray(b["out_sh"]).astype(np.int32)
    rng = np.random.default_rng(3)
    shapes = [tuple(s >> (i + 1) for s in (96, 320, 224)) for i in range(4)]
    vols = [(rng.random(sh + (32,)) * (rng.random(sh + (1,)) > 0.33)).astype(np.float32)
            for sh in shapes]
    dhw = (rng.random((4096, 3)) * out_sh).astype(np.float32)
    want = np.asarray(jr.nerfhead.apply(
        variables["head"], [jnp.asarray(v) for v in vols], jnp.asarray(dhw), jnp.asarray(out_sh),
        method=lambda m, *a: m.sigmahead.query_sigma_feat_dense(*a)), np.float32)
    with torch.no_grad():
        got = head.sigmahead.query_sigma_feat_dense(
            [torch.from_numpy(v) for v in vols], torch.from_numpy(dhw),
            torch.from_numpy(out_sh)).float().numpy()
    assert got.shape == (4096, 64)
    return got, want


def test_query_sigma_feat_dense_matches_jax(frame):
    """The checkpoint's sigma head on seeded dense level volumes (zeros at
    a third of the sites) at 4,096 points across the frame's extent."""
    got, want = _query_sigma_feat_dense(frame, "float32")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_query_sigma_feat_dense_bf16_matches_jax(frame):
    """The same under `tpu.matmul_dtype bfloat16`: the float32 volumes'
    trilinear query, then out_geometry_fc on bf16 tensors (JAX's output is
    a bf16 array); equal to JAX's but where the two bf16 products' float32
    sums, taken in another order, straddle a rounding edge: one bf16 step
    there (3 of 262,144 values seen)."""
    got, want = _query_sigma_feat_dense(frame, "bfloat16")
    assert (got != 0).mean() > 0.5
    exact = got == want
    assert exact.mean() >= 0.9999, exact.mean()
    np.testing.assert_allclose(got[~exact], want[~exact], rtol=2 ** -7, atol=0)


def test_mesh_sigma_bf16_matches_jax(frame):
    """The demo mesh path's per-chunk sigma under bf16 on the JAX
    package's own volume stage (its bf16 encoder features, float32 level
    volumes and occupancy field): `render/base.mesh_sigma` under the
    trilinear occupancy cull against JAX's chunk function, on 4,096 seeded
    points in the frame's mesh bounds (0 seen)."""
    from gpnerf_tpu_torch.ops.grid_sample import trilinear_dense_gather as port_gather
    from gpnerf_tpu_torch.render.base import mesh_sigma, points_to_dhw_vox

    b, variables = frame
    jr = jax_get("render", "demo_render")(_cfg(jax_cfg, matmul_dtype="bfloat16"))
    jb = {k: jnp.asarray(v) for k, v in b.items() if k not in ("pts", "inside")}
    vol_fn, chunk_fn = jr._mesh_fns_demo()
    featmaps, KE, dense_vols, out_sh, masks3d, can_bounds = vol_fn(variables, jb)
    assert featmaps.dtype == jnp.bfloat16 and dense_vols[0].dtype == jnp.float32
    cb = np.asarray(can_bounds)
    pts = (cb[0] + np.random.default_rng(4).random((4096, 3)) * (cb[1] - cb[0])).astype(np.float32)
    want = np.asarray(chunk_fn(variables, featmaps, KE, dense_vols, out_sh, masks3d, jb,
                               jnp.asarray(pts)), np.float32)
    r = _port("demo_render", "bfloat16")
    pb = batch_to_device({k: v for k, v in b.items() if k not in ("pts", "inside")}, "cpu")
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    vol = {"featmaps": t(featmaps), "dense_vols": [t(v) for v in dense_vols],
           "out_sh": torch.from_numpy(np.asarray(out_sh)), "pre": {"KE": t(KE)}}
    p = torch.from_numpy(pts)
    with torch.no_grad():
        size1 = vol["out_sh"] // 2
        pos1 = points_to_dhw_vox(p, pb, r.voxel_size) / vol["out_sh"].float() * (size1 - 1).float()
        occ = port_gather(t(masks3d), pos1, dyn_size=size1)
        got = torch.where(occ > 0, mesh_sigma(r.nerfhead, vol, pb, p, r.voxel_size), 0.0)
    got = got.float().numpy()
    assert (want > 0).sum() > 100
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def meshes(frame):
    """name -> (the port's render_mesh, the JAX package's), made once."""
    b, variables = frame
    out = {}
    for name in RENDERS:
        jr = jax_get("render", name)(_cfg(jax_cfg))
        jb = b if name == "BaseRender" else {k: v for k, v in b.items()
                                             if k not in ("pts", "inside")}
        want = jr.render_mesh(variables, jb, chunk=16384)
        r = _port(name)
        assert r.mesh_th == jr.mesh_th == 1.0 / 50
        # the demo path does not read the visual hull: it is left out
        got = r.render_mesh(batch_to_device(jb, "cpu"), chunk=16384)
        out[name] = (got, want)
    return out


@pytest.fixture(scope="module")
def meshes_bf16(frame):
    """name -> (the port's render_mesh, the JAX package's) under
    `tpu.matmul_dtype bfloat16`, made once."""
    b, variables = frame
    out = {}
    for name in RENDERS:
        jr = jax_get("render", name)(_cfg(jax_cfg, matmul_dtype="bfloat16"))
        jb = b if name == "BaseRender" else {k: v for k, v in b.items()
                                             if k not in ("pts", "inside")}
        want = jr.render_mesh(variables, jb, chunk=16384)
        got = _port(name, "bfloat16").render_mesh(batch_to_device(jb, "cpu"), chunk=16384)
        out[name] = (got, want)
    return out


@pytest.mark.parametrize("name", RENDERS)
def test_render_mesh_matches_jax(meshes, name):
    got, want = meshes[name]
    assert got["cube"].shape == want["cube"].shape
    np.testing.assert_allclose(got["cube"], want["cube"], rtol=0, atol=1e-4)
    th = 1.0 / 50
    # the thresholded alpha: a body-sized set, the same one up to voxels
    # within 1e-4 of the threshold
    inside = want["cube"] > th
    assert inside.sum() > 1000
    assert ((got["cube"] > th) != inside).sum() <= (np.abs(want["cube"] - th) < 1e-4).sum()
    gm, wm = got["mesh"], want["mesh"]
    assert len(gm.vertices) == len(wm.vertices) > 1000
    assert len(gm.faces) == len(wm.faces)
    np.testing.assert_array_equal(gm.faces, wm.faces)
    np.testing.assert_allclose(gm.vertices, wm.vertices, rtol=0, atol=2e-3)


def test_render_mesh_bf16_matches_jax(meshes, meshes_bf16):
    """Both `render_mesh`s under `tpu.matmul_dtype bfloat16`. BaseRender
    computes in float32 there in both packages (only `tpu.train_dtype`
    casts it): the float32 case's bounds. The demo renderer: the cube on
    JAX's grid, nearer JAX's bf16 cube than JAX's float32 cube is, in max
    and in median over JAX's nonzero voxels (measured: 0.081 / 4.7e-4
    against 0.093 / 9.7e-4), the vertex count within 1% of JAX's."""
    got, want = meshes_bf16["BaseRender"]
    np.testing.assert_allclose(got["cube"], want["cube"], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got["mesh"].faces, want["mesh"].faces)
    got, want = (np.asarray(m["cube"], np.float64) for m in meshes_bf16["demo_render"])
    ref32 = np.asarray(meshes["demo_render"][1]["cube"], np.float64)
    assert got.shape == want.shape == ref32.shape
    nz = want > 0
    d_port, d_f32 = np.abs(got - want), np.abs(ref32 - want)
    print(f"demo bf16 cube: port max {d_port.max():.4g} median {np.median(d_port[nz]):.4g}; "
          f"JAX float32 max {d_f32.max():.4g} median {np.median(d_f32[nz]):.4g}")
    assert d_port.max() < d_f32.max() and np.median(d_port[nz]) < np.median(d_f32[nz])
    nv_port, nv_jax = (len(m["mesh"].vertices) for m in meshes_bf16["demo_render"])
    assert abs(nv_port - nv_jax) <= 0.01 * nv_jax and nv_jax > 1000


def test_demo_mesh_interleaves_the_hull_mesh(frame, meshes):
    """The occupancy-driven grid and the visual hull's sample the same
    density field on differently aligned 2 cm grids: their thresholded
    alpha clouds interleave within 2 voxels (tests/test_mesh_path.py)."""
    from scipy.spatial import cKDTree

    b, _ = frame
    th = 1.0 / 50
    hull = meshes["BaseRender"][0]["cube"][10:-10, 10:-10, 10:-10]
    cloud_h = np.asarray(b["pts"]).reshape(hull.shape + (3,))[hull > th]
    r = _port("demo_render")
    with torch.no_grad():
        cb0 = r.mesh_frame(batch_to_device(b, "cpu"))["can_bounds"][0].numpy()
    occ = meshes["demo_render"][0]["cube"][10:-10, 10:-10, 10:-10]
    cloud_o = cb0[None] + np.argwhere(occ > th) * 0.02
    assert len(cloud_h) > 50 and len(cloud_o) > 50
    assert np.median(cKDTree(cloud_h).query(cloud_o)[0]) < 0.04
    assert np.median(cKDTree(cloud_o).query(cloud_h)[0]) < 0.04


def test_mesh_evaluator_writes_its_files(frame, meshes, tmp_path):
    """evaluate / visualize / visualize_voxel write the files the JAX
    package's MeshEvaluator writes, byte for byte, for the same output."""
    b, _ = frame
    out = meshes["demo_render"][0]
    ports = MeshEvaluator(_cfg(port_cfg, tmp_path / "port"), "mesh")
    jaxes = JaxMeshEvaluator(_cfg(jax_cfg, tmp_path / "jax"), "mesh")
    for ev in (ports, jaxes):
        ev.evaluate(out, b)
    idx = int(b["frame_index"])
    for kind, name in (("npy", f"pts_{idx}.npy"), ("visualize", None), ("visualize_voxel", None)):
        if name is None:
            got, want = getattr(ports, kind)(out, b), getattr(jaxes, kind)(out, b)
        else:
            got, want = (os.path.join(str(tmp_path / d), "mesh", name) for d in ("port", "jax"))
        assert open(got, "rb").read() == open(want, "rb").read(), kind
    v, f = mesh_io.read_ply(os.path.join(str(tmp_path / "port"), "mesh", f"mesh_{idx}.ply"))
    np.testing.assert_array_equal(f, out["mesh"].faces)
    np.testing.assert_array_equal(v, out["mesh"].vertices.astype(np.float32))
    occ = np.argwhere(out["cube"] > 1.0 / 50)
    bv, bf = voxel_boxes(occ)
    assert bv.shape == (8 * len(occ), 3) and bf.shape == (12 * len(occ), 3)


@pytest.mark.parametrize("name", RENDERS)
def test_build_render_takes_the_mesh_branch(name):
    """Neither renderer refuses `head.rgb.use_rgbhead False`; both set the
    JAX package's threshold 1 / test.mesh_th, -1 with the color head."""
    cfg = _cfg(port_cfg)
    check_train_scope(cfg)
    assert port_get("render", name)(cfg, device="cpu").mesh_th == 1.0 / 50
    cfg.defrost()
    cfg.head.rgb.use_rgbhead = True
    cfg.freeze()
    assert port_get("render", name)(cfg, device="cpu").mesh_th == -1.0
