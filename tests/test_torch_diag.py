"""The port's diagnostic tools against the JAX package, at 128^2 on the CPU
with the trained checkpoint and small caps:

  * tools/diag_ref_mode_torch.py: the port's tight-cull (K = 64) and
    reference-semantics renders of a bench frame (`mode_cfg`, the tool's
    overrides) against JAX's renders of the same host frame, band by band
    (`decompose`): every band's pixel count bitwise, its squared errors
    within the bf16 color gap; and `decompose` on JAX's own renders equal
    to the arithmetic of tools/diag_ref_mode.py:93-130, written out here
    (the JAX tool fixes 512^2);
  * tools/diag_ref_points_torch.py: the point set the port's ray pipeline
    hands its point stages (`capture_points`) against what JAX's
    `_point_stages` receives on the same frame (a spy that returns its
    inputs from the same jitted program, as the JAX tool's stub does):
    `sig_ok` and the blanket's occupied-voxel count bitwise, `pts_c` and
    `dhw_c` within float32 rounding; each timed op's body run on JAX's
    captured arrays and tables, converted, against the JAX function on
    the same arrays (every 4th captured point, to keep the file short);
  * tools/trace_demo_torch.py: `capture` and `kernel_table` over a CPU
    profile of one 64^2 render, and `report`;
  * each tool imports neither jax nor the JAX package, and its `main`
    raises without a card unless `device cpu` is given.

The JAX variables load once into a zero tree of `init_variables`' shapes
(tests/test_torch_window.py). ~60 s alone."""

import ast
import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnerf_tpu.config import cfg as jax_cfg
from gpnerf_tpu.models.heads import fused_mean_variance as jax_meanvar
from gpnerf_tpu.ops import grid_sample as jgs
from gpnerf_tpu.ops import projection as jproj
from gpnerf_tpu.registry import get as jax_get
from gpnerf_tpu.render import demo as jax_demo
from gpnerf_tpu.render.base import src_norm as jax_src_norm
from gpnerf_tpu.render.demo import pred_img_hwc as jax_pred_img_hwc
from gpnerf_tpu.train.checkpoint import load_eval_model as jax_load
from gpnerf_tpu_torch.ops.grid_sample import FlatOctetTable, NearestTable
from gpnerf_tpu_torch.registry import get as port_get
from gpnerf_tpu_torch.render.base import batch_to_device
from gpnerf_tpu_torch.train.checkpoint import load_eval_model
from gpnerf_tpu_torch.utils.bench_frames import get_bench_frames

ROOT = os.path.join(os.path.dirname(__file__), "..")
TOOLS = os.path.join(ROOT, "tools")
CKPT = os.path.join(ROOT, "artifacts", "bench_ckpt.pth")
sys.path.insert(0, TOOLS)
sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402
import diag_ref_mode_torch as drm  # noqa: E402
import diag_ref_points_torch as drp  # noqa: E402
import trace_demo_torch  # noqa: E402

H = W = 128
CPU = torch.device("cpu")
# 4,982 tight rays and 8,871 blanket rays on bench frame 0 at 128^2; the
# reference mode's caps of tests/test_torch_refmode.py
TIGHT_CAPS = dict(ray_cap=5120, sigma_cap=1048576)
REF_CAPS = dict(ray_cap=9216, sigma_cap=1048576, rgb_cap=262144)
REF_OPTS = ["dataset.H", str(H), "dataset.W", str(W), "tpu.ray_cap", "9216",
            "tpu.sigma_cap", "1048576", "tpu.rgb_cap", "262144"]
STRIDE = 4  # the ops run on every 4th captured point


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Whole-frame renders under parallel test files (tests/test_torch_opbyop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax(cfg):
    """The port's configuration `cfg` as the JAX package's (the two
    config trees are copies)."""
    j = jax_cfg.clone()
    j.defrost()
    j.merge_from_other_cfg(cfg)
    j.freeze()
    return j


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """Bench frame 0 at 128^2, built once by the port's protocol; both
    packages render this host batch."""
    return get_bench_frames(drm.mode_cfg(False, H, **TIGHT_CAPS), 1,
                            cache_root=str(tmp_path_factory.mktemp("frames")), verbose=False)


@pytest.fixture(scope="module")
def jax_variables(host):
    jr = jax_get("render", "demo_render")(_jax(drm.mode_cfg(False, H, **TIGHT_CAPS)))
    shapes = jax.eval_shape(lambda: jr.init_variables(0, host[0]))
    return jax_load(CKPT, jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes), 4)


def _jax_outs(ret):
    return jax_pred_img_hwc(ret), np.asarray(ret["mask_at_box"]).reshape(H, W)


@pytest.fixture(scope="module")
def jax_tight(host, jax_variables):
    jr = jax_get("render", "demo_render")(_jax(drm.mode_cfg(False, H, **TIGHT_CAPS)))
    ret = jr.render_demo_fn()(jax_variables, {k: jnp.asarray(v) for k, v in host[0].items()})
    return {k: np.asarray(v) for k, v in ret.items()}


@pytest.fixture(scope="module")
def jax_ref(host, jax_variables):
    """JAX's reference-semantics render of the frame, with what its
    `_point_stages` receives and the blanket's occupied voxels, all from
    one jitted program: spies on `_point_stages` and `_occupied_world_pts`
    keep their traced inputs and call the originals. Returns (render dict,
    arrays, static table fields, JAX renderer)."""
    cfg = _jax(drp.ref_cfg(REF_OPTS))
    # both tools' reference configurations at these caps are one
    assert drm.mode_cfg(True, H, **REF_CAPS) == drp.ref_cfg(REF_OPTS)
    jr = jax_get("render", "demo_render")(cfg)
    cls = jax_demo.Renderer
    orig_ps, orig_occ = cls._point_stages, cls._occupied_world_pts
    stash, static = {}, {}

    def spy_ps(self, apply, batch, pre, tables, pts_c, dhw_c, sig_ok, *a, **k):
        l1, coarse = tables["octet_vols"]
        static.update(l1_shape=tuple(l1.shape), folded=bool(tables.get("folded")),
                      coarse=(tuple(coarse.shape), coarse.div, coarse.interleave, coarse.lerp_axes))
        stash.update(pts_c=pts_c, dhw_c=dhw_c, sig_ok=sig_ok.astype(jnp.float32),
                     KE=pre["KE"], out_sh=pre["out_sh"], l1_rows=l1.rows, c_rows=coarse.rows,
                     scales=tables["octet_scales"],
                     **{k: tables[k] for k in ("src_quad", "feat_quad", "src_scale", "feat_scale")})
        return orig_ps(self, apply, batch, pre, tables, pts_c, dhw_c, sig_ok, *a, **k)

    def spy_occ(self, masks3d, batch):
        stash["blanket_voxels"] = (masks3d > self.occupancy_threshold).sum()
        return orig_occ(self, masks3d, batch)

    def run(variables, b):
        feat = jr.encoder.apply(variables["encoder"], jax_src_norm(b["src_imgs"]))
        return jr._demo_impl(variables, b, feat), dict(stash)

    cls._point_stages, cls._occupied_world_pts = spy_ps, spy_occ
    try:
        ret, arrays = jax.jit(run)(jax_variables, {k: jnp.asarray(v) for k, v in host[0].items()})
    finally:
        cls._point_stages, cls._occupied_world_pts = orig_ps, orig_occ
    return {k: np.asarray(v) for k, v in ret.items()}, arrays, static, jr


def _port_render(cfg):
    r = port_get("render", "demo_render")(cfg, device="cpu")
    load_eval_model(CKPT, r)
    return r.eval()


@pytest.fixture(scope="module")
def port_ref(host):
    """The port's reference-semantics renderer, and its captured frame."""
    r = _port_render(drp.ref_cfg(REF_OPTS))
    b = batch_to_device(host[0], CPU)
    feats = r.encode_fn()(b["src_imgs"])
    return r, b, feats, drp.capture_points(r, b, feats)


def _jax_tool_lines(host, tight_outs, ref_outs):
    """tools/diag_ref_mode.py:93-130, on (image, covered pixels) pairs."""
    agg = {k: [] for k in ("both", "ref_only", "tight_only")}
    lines = []
    for i, b in enumerate(host):
        gt = np.asarray(b["tar_img"], np.float32)
        if gt.max() > 1.5:
            gt = gt / 255.0
        mab = np.asarray(b["mask_at_box"]).reshape(H, W)
        gt = gt * mab[..., None]
        ti, tm = tight_outs[i]
        ri, rm = ref_outs[i]
        tm = tm & mab
        rm = rm & mab
        bands = {"both": tm & rm, "ref_only": rm & ~tm, "tight_only": tm & ~rm}
        err_t = ((ti - gt) ** 2).sum(-1)
        err_r = ((ri - gt) ** 2).sum(-1)
        line = {"frame": i}
        for k, m in bands.items():
            n = int(m.sum())
            line[k] = {
                "px": n,
                "mse_tight": float(err_t[m].mean()) if n else 0.0,
                "mse_ref": float(err_r[m].mean()) if n else 0.0,
                "sse_tight": float(err_t[m].sum()),
                "sse_ref": float(err_r[m].sum()),
            }
            agg[k].append((line[k]["sse_tight"], line[k]["sse_ref"], n))
        lines.append(line)
    lines.append({"total": {
        k: {"px": int(sum(n for _, _, n in v)), "sse_tight": round(sum(a for a, _, _ in v), 3),
            "sse_ref": round(sum(b for _, b, _ in v), 3)}
        for k, v in agg.items()}})
    return lines


def test_decompose_is_the_jax_tools_arithmetic(host, jax_tight, jax_ref):
    outs_t, outs_r = [_jax_outs(jax_tight)], [_jax_outs(jax_ref[0])]
    assert drm.decompose(host, outs_t, outs_r) == _jax_tool_lines(host, outs_t, outs_r)


def test_diag_ref_mode_bands_match_jax(host, jax_tight, jax_ref):
    tight = drm.render_outs(drm.mode_cfg(False, H, **TIGHT_CAPS), host, CPU)
    ref = drm.render_outs(drm.mode_cfg(True, H, **REF_CAPS), host, CPU)
    assert jax_tight["overflows"][0] == jax_ref[0]["overflows"][0] == 0
    port = drm.decompose(host, tight, ref)
    jax_lines = drm.decompose(host, [_jax_outs(jax_tight)], [_jax_outs(jax_ref[0])])
    assert port[-1].keys() == jax_lines[-1].keys() == {"total"}
    for p, j in zip(port, jax_lines):
        assert p.keys() == j.keys()
        for band in drm.BANDS:
            pb, jb = (p[band], j[band]) if "frame" in p else (p["total"][band], j["total"][band])
            assert pb["px"] == jb["px"], (band, pb, jb)
            for k in ("sse_tight", "sse_ref"):
                print(band, k, pb[k], jb[k])
                assert abs(pb[k] - jb[k]) <= 0.01 * jb[k] + 0.01, (band, k, pb[k], jb[k])
    # the blanket's fringe is where the reference mode adds error
    assert port[0]["ref_only"]["px"] > 1000 and port[0]["both"]["px"] > 4000


def test_captured_points_match_jax(jax_ref, port_ref):
    _, arrays, _, _ = jax_ref
    r, b, feats, (pre, tables, pts) = port_ref
    np.testing.assert_array_equal(pts["sig_ok"].numpy(), np.asarray(arrays["sig_ok"]) > 0)
    for k in ("pts_c", "dhw_c"):
        d = np.abs(pts[k].numpy() - np.asarray(arrays[k]))
        print(k, d.max(), np.abs(np.asarray(arrays[k])).max())
        assert d.max() <= 1e-5 * np.abs(np.asarray(arrays[k])).max(), (k, d.max())
    assert drp.blanket_voxels(r, b, feats) == int(arrays["blanket_voxels"])


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def jax_inputs(jax_ref, port_ref):
    """JAX's captured arrays and tables (every STRIDE-th point), as JAX
    arrays and as the port's tensors and tables."""
    _, arrays, static, jr = jax_ref
    jx = {k: (v[::STRIDE] if k in ("pts_c", "dhw_c", "sig_ok") else v) for k, v in arrays.items()}
    coarse_shape, div, inter, lerp = static["coarse"]

    def jtab(jx):
        """The JAX tables, their static fields from the trace."""
        return {"l1": jgs.FlatOctetTable(jx["l1_rows"], static["l1_shape"]),
                "coarse": jgs.NearestTable(jx["c_rows"], coarse_shape, div, inter, lerp)}

    pt = {k: (_t(v) if not isinstance(v, (list, tuple)) else [_t(x) for x in v])
          for k, v in jx.items()}
    tables = {
        "octet_vols": [FlatOctetTable(pt["l1_rows"], static["l1_shape"]),
                       NearestTable(pt["c_rows"], coarse_shape, div, inter, lerp)],
        "octet_scales": pt["scales"], "folded": static["folded"],
        **{k: pt[k] for k in ("src_quad", "feat_quad", "src_scale", "feat_scale")},
    }
    pt["sig_ok"] = pt["sig_ok"] > 0
    return jx, jtab, pt, tables, jr, port_ref[0]


def _head_apply(jr, variables, fn, *a, **k):
    return jr.nerfhead.apply(variables["head"], *a, method=fn, **k)


def _jax_query(jr, variables, jx, jtab):
    return _head_apply(jr, variables, lambda m, *a, **k: m.sigmahead.query_sigma_feat_octet_folded(*a, **k),
                       jtab["l1"], jtab["coarse"], jx["dhw_c"], jx["out_sh"], scales=jx["scales"])


def _jax_pos(jx, size):
    frac = jx["dhw_c"] / jx["out_sh"].astype(jnp.float32)
    return frac * (size - 1).astype(jnp.float32)


def _jax_norm(jr, jx, hw):
    pixel, _ = jproj.compute_projections(jx["pts_c"], jx["KE"], neg_ray=jr.neg_ray_val)
    return jproj.normalize_pixels(pixel, *hw)


def _jax_op(name, jx, jtab, jr, variables, hw):
    """The JAX function the op's body replaces, on the JAX arrays."""
    if name == "octet_query":
        return _jax_query(jr, variables, jx, jtab)
    if name == "octet_l1_only":
        size = jx["out_sh"] // 2
        return jgs.trilinear_octet_rows(jtab["l1"], _jax_pos(jx, size), size, scale=jx["scales"][0])
    if name == "coarse_nearest_only":
        t = jtab["coarse"]
        size = jx["out_sh"] // t.div
        if t.interleave > 1:
            size = t.interleave * (size - 1) + 1
        return jgs.nearest_rows(t, _jax_pos(jx, size), size, scale=jx["scales"][1])
    if name == "proj_quad_current":
        return jproj.project_and_gather_quad(
            jx["pts_c"], jx["KE"], jx["src_quad"], jx["feat_quad"], *hw, neg_ray=jr.neg_ray_val,
            src_scale=jx["src_scale"], feat_scale=jx["feat_scale"])
    if name == "proj_rgb_only":
        return jgs.bilinear_quad_nhwc_pv(jx["src_quad"], _jax_norm(jr, jx, hw), *hw,
                                         scale=jx["src_scale"])
    if name == "proj_feat_only":
        fq = jx["feat_quad"]
        return jgs.bilinear_quad_nhwc_pv(fq, _jax_norm(jr, jx, hw), fq.shape[1] - 1, fq.shape[2] - 1,
                                         scale=jx["feat_scale"])
    assert name == "heads_op_by_op"
    rgb_feat, mask = _jax_op("proj_quad_current", jx, jtab, jr, variables, hw)
    sigma_feat = _jax_query(jr, variables, jx, jtab)
    mean, var = jax_meanvar(rgb_feat)
    nvo = mask.astype(jnp.float32).sum(axis=-1, keepdims=True)
    sigma = _head_apply(jr, variables, lambda m, *a: m.rgbhead.density(*a),
                        sigma_feat, mean[:, 0], var[:, 0], nvo)[:, 0]
    sigma = jnp.where(jx["sig_ok"] > 0, sigma.astype(jnp.float32), 0.0)
    rgb = _head_apply(jr, variables, lambda m, *a: m.rgbhead.color(*a),
                      rgb_feat[:, None], mean[:, None], var[:, None])[:, 0]
    return sigma, rgb


def _port_op(name, pt, tables, r, hw):
    out_sh = pt["out_sh"]
    if name == "octet_query":
        return drp.octet_query(r, tables, out_sh, pt["dhw_c"])
    if name in ("octet_l1_only", "coarse_nearest_only"):
        i = name == "coarse_nearest_only"
        return getattr(drp, name)(tables["octet_vols"][i], tables["octet_scales"][i], out_sh,
                                  pt["dhw_c"])
    fn = getattr(drp, name)
    if name.startswith("proj_"):
        return fn(r, pt["pts_c"], pt["KE"], tables, hw)
    rgb_feat, mask = drp.proj_quad_current(r, pt["pts_c"], pt["KE"], tables, hw)
    return fn(r, rgb_feat, mask, tables, out_sh, pt["dhw_c"], pt["sig_ok"])


# max |port - JAX| over max |JAX| per op output against the jitted JAX
# function, measured: the coarse nearest rows bitwise; the level-1 trilerp
# 1.3e-7 (one float32 ulp on 0.6% of values, where XLA fuses a multiply-add);
# the projections 4.1e-5 (rgb), 9.3e-6 (rgb_feat), 6.1e-6 (features), where
# the port's einsum and JAX's matmul round a pixel coordinate in another
# last bit; the bf16 sigma query 3.5e-4 (one value in 10^7 differs); the
# bf16 heads 3.0e-3 (sigma) and 8.3e-3 (rgb, 0.6% of values one bf16 step
# apart; ROADMAP.md Queue 3: "heads nearly all values the same bf16 number")
OP_BOUNDS = {
    "octet_query": 2e-3, "octet_l1_only": 1e-6, "coarse_nearest_only": 0.0,
    "proj_quad_current": 1e-4, "proj_rgb_only": 1e-4, "proj_feat_only": 1e-4,
    "heads_op_by_op": 2.0 ** -6,
}


@pytest.mark.parametrize("name", sorted(OP_BOUNDS))
def test_timed_op_matches_jax(host, jax_variables, jax_inputs, name):
    jx, jtab, pt, tables, jr, r = jax_inputs
    hw = tuple(host[0]["src_imgs"].shape[1:3])
    with torch.no_grad():
        port = _port_op(name, pt, tables, r, hw)
    ref = jax.jit(lambda jx, v: _jax_op(name, jx, jtab(jx), jr, v, hw))(jx, jax_variables)
    port = port if isinstance(port, tuple) else (port,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(port) == len(ref)
    for p, j in zip(port, ref):
        p, j = p.float().numpy(), np.asarray(j, np.float32)
        assert p.shape == j.shape, (name, p.shape, j.shape)
        d = np.abs(p - j)
        print(name, d.max(), np.median(d), np.abs(j).max(), (d > 0).mean())
        assert d.max() <= OP_BOUNDS[name] * np.abs(j).max(), (name, d.max())


def test_trace_demo_kernel_table(tmp_path):
    cfg = bench_torch.bench_cfg(["dataset.H", "32", "dataset.W", "32", "tpu.ray_cap", "1024"])
    r = _port_render(cfg)
    frames = [batch_to_device(b, CPU) for b in get_bench_frames(
        cfg, 1, cache_root=str(tmp_path / "frames"), verbose=False)]
    rows = trace_demo_torch.capture(r, frames, CPU, trace_dir=str(tmp_path / "trace"))
    assert os.listdir(tmp_path / "trace")
    assert len(rows) > 10
    assert all(ms > 0 and count >= 1 for _, ms, count in rows)
    assert [ms for _, ms, _ in rows] == sorted((ms for _, ms, _ in rows), reverse=True)
    out = io.StringIO()
    trace_demo_torch.report(rows, 1, n_top=5, out=out)
    lines = out.getvalue().splitlines()
    assert len(lines) == 5 + 2 + min(20, len(rows) - 5) and "busy" in lines[5]


TOOL_FILES = ("diag_ref_mode_torch.py", "diag_ref_points_torch.py", "trace_demo_torch.py")


@pytest.mark.parametrize("tool", TOOL_FILES)
def test_tool_imports_no_jax(tool):
    with open(os.path.join(TOOLS, tool)) as f:
        tree = ast.parse(f.read())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    mods += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert mods and not [m for m in mods if m.split(".")[0] in ("jax", "gpnerf_tpu")], mods


@pytest.mark.parametrize("tool,argv", [
    (drm, ["1"]), (drp, ["1"]), (trace_demo_torch, [CKPT, "10"])])
def test_tool_needs_a_card_or_device_cpu(tool, argv):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="device cpu"):
        tool.main(argv)
