"""The progressive renderer under `tpu.matmul_dtype bfloat16` on real bf16
tensors (gpnerf_tpu_torch/render/demo.py with models/layers.py) against the
JAX package's bf16 renderer, and the render entry points the JAX package
has beside `render_demo_fn`: `encode_fn`, `render` and
`render_demo_scan_fn`.

At 128^2 with the trained checkpoint: the port's fused fast mode, its
reference mode and its op-by-op fast mode against JAX's `render_demo_fn`
(on the CPU JAX renders op by op, its Pallas kernels gated to the TPU).
Held bitwise: the ray set, the overflow counters and the ray and sigma-slot
counts. Colors within the bf16 gaps ROADMAP.md Queue 3 records, held to
the bounds of tests/test_torch_opbyop.py's bf16 cases; measured here
(median / 99.9th percentile / max over covered pixels, colored points
that differ): fused fast 1.4e-3 / 9.4e-3 / 0.025, 28 of 52,210; fused
reference 1.1e-3 / 2.3e-2 / 0.058, 154 of 106,291; op-by-op fast 1.2e-3 /
1.1e-2 / 0.025, 31 of 52,210. The colored points differ where a density
sits at the ReLU / alpha boundary and a bf16 step moves it across.

The dtypes: the encoder returns bf16 feature maps, the heads' Dense layers
take and return bf16, the op-by-op path's gathered projection rows are
bf16, the fused path hands the kernel the (P, F) geometry feature in bf16
where JAX hands its Pallas kernel bf16 (`kernel_octet False`), and the
level volumes are float32 until the gather tables cast them (JAX
render/demo.py:1181-1187).

Per stage on the same inputs, the JAX side compiled with XLA's excess
precision off so that each bf16 cast of its code rounds: one row
convolution of the sparse stack (bf16 operands, float32 sums) within 1e-6
relative; the whole sparse stack, the encoder and the heads within the
bounds below, each nearer JAX's bf16 result than JAX's own float32 result
is."""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnerf_tpu.config import cfg as jax_cfg
from gpnerf_tpu.ops.sparse_conv import subm_conv_tbl as jax_subm_conv
from gpnerf_tpu.registry import get as jax_get
from gpnerf_tpu.render.base import src_norm as jax_src_norm
from gpnerf_tpu.train.checkpoint import load_eval_model as jax_load
from gpnerf_tpu_torch.config import cfg as port_cfg
from gpnerf_tpu_torch.models.layers import MLP
from gpnerf_tpu_torch.ops import point_stages as ps
from gpnerf_tpu_torch.ops.sparse_conv import subm_conv_tbl
from gpnerf_tpu_torch.registry import get as port_get
from gpnerf_tpu_torch.render import demo as port_demo
from gpnerf_tpu_torch.render.base import batch_to_device, prepare_frame, src_norm
from gpnerf_tpu_torch.train.checkpoint import load_eval_model

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "artifacts", "bench_ckpt.pth")
H = W = 128
# the capacities of tests/test_torch_opbyop.py
MODES = {
    "fast": dict(ray_cap=16384, sigma_cap=262144, rgb_cap=131072),
    "reference": dict(tight_cull=False, samples_per_ray=64, tap_window=0,
                      merge_lowres_src=False, ray_cap=9216, sigma_cap=1048576,
                      rgb_cap=262144),
}
# the port's renders: (JAX's mode, the port's switches)
RENDERS = {
    "fused-fast": ("fast", {}),
    "fused-reference": ("reference", {}),
    "opbyop-fast": ("fast", dict(pallas_point=False)),
}
# |d pred_chw| bounds over covered pixels (median, 99.9th percentile, max)
# and the share of colored points that may differ; the measured values are
# in the module docstring
BOUNDS = {
    "fused-fast": (4e-3, 3e-2, 0.06, 1e-3),
    "fused-reference": (4e-3, 5e-2, 0.1, 3e-3),
    "opbyop-fast": (4e-3, 3e-2, 0.06, 1e-3),
}
COMPILE = {"xla_allow_excess_precision": False}


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Whole-frame renders under parallel test files (tests/test_torch_opbyop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(base, dtype="bfloat16", size=H, **tpu):
    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "synthetic.yaml"))
    cfg.dataset.H = cfg.dataset.W = size
    cfg.head.sigma.code_dim = 32
    cfg.render.file = "demo_render"
    cfg.dataset.test.sampler = "FrameSampler"
    cfg.tpu.matmul_dtype = dtype
    for k, v in tpu.items():
        cfg.tpu[k] = v
    cfg.freeze()
    return cfg


def _frames(size, n=1):
    cfg = _cfg(jax_cfg, size=size)
    np.random.seed(0)
    random.seed(0)
    ds = jax_get("dataset", cfg.dataset.test.file)(cfg, is_train=False)
    return [ds[i] for i in range(n)]


def _port(size=H, **tpu):
    r = port_get("render", "demo_render")(_cfg(port_cfg, size=size, **tpu), device="cpu")
    return load_eval_model(CKPT, r)


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=COMPILE)


@pytest.fixture(scope="module")
def batch():
    return _frames(H)[0]


@pytest.fixture(scope="module")
def jax_model(batch):
    """(bf16 JAX renderer, float32 one, the checkpoint's variables in a zero
    tree of `init_variables`' shapes)."""
    jr = jax_get("render", "demo_render")(_cfg(jax_cfg))
    shapes = jax.eval_shape(lambda: jr.init_variables(0, batch))
    variables = jax_load(CKPT, jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes), 4)
    return jr, jax_get("render", "demo_render")(_cfg(jax_cfg, "float32")), variables


@pytest.fixture(scope="module")
def jax_renders(batch, jax_model):
    """JAX mode -> its bf16 render of `batch`, made once."""
    cache = {}
    _, _, variables = jax_model

    def get(mode):
        if mode not in cache:
            jr = jax_get("render", "demo_render")(_cfg(jax_cfg, **MODES[mode]))
            ret = jr.render_demo_fn()(variables, {k: jnp.asarray(v) for k, v in batch.items()})
            cache[mode] = {k: np.asarray(v) for k, v in ret.items()}
        return cache[mode]

    return get


@pytest.mark.parametrize("name", sorted(RENDERS))
def test_native_render_matches_jax_bf16(batch, jax_renders, name):
    mode, tpu = RENDERS[name]
    r = _port(**MODES[mode], **tpu)
    assert r.compute_dtype == torch.bfloat16
    pret = {k: v.numpy() for k, v in r.render_demo_fn()(batch_to_device(batch, "cpu")).items()}
    jret = jax_renders(mode)
    for k in ("mask_at_box", "ray_pix_idx", "ray_ok", "overflows"):
        np.testing.assert_array_equal(pret[k], jret[k], err_msg=k)
    np.testing.assert_array_equal(pret["counts"][:2], jret["counts"][:2])
    if mode == "reference":
        assert (pret["overflows"] == 0).all() and pret["counts"][1] > 300000
    else:
        assert pret["overflows"][0] == 0 and pret["overflows"][1] > 0
    med, p999, mx, flips = BOUNDS[name]
    n_j = int(jret["counts"][2])
    assert abs(int(pret["counts"][2]) - n_j) <= flips * n_j, (pret["counts"], jret["counts"])
    m = pret["mask_at_box"].reshape(H, W)
    assert m.sum() > 2000 and (pret["pred_chw"][:, ~m] == 0).all()
    assert pret["pred_chw"].dtype == np.float32
    d = np.abs(pret["pred_chw"] - jret["pred_chw"])[:, m]
    got = (np.median(d), np.percentile(d, 99.9), d.max())
    assert got[0] < med and got[1] < p999 and got[2] < mx, got


@pytest.fixture(scope="module")
def small():
    """The renderer and two device batches at 64^2 (every pixel a ray)."""
    frames = [batch_to_device(f, "cpu") for f in _frames(64, 2)]
    return _port(64, ray_cap=4096), frames


def test_native_dtypes(small, monkeypatch):
    """The encoder's output, every Dense layer's output and the op-by-op
    path's gathered projection rows are bf16 tensors; the level volumes
    float32 until the gather tables cast them; with `kernel_octet` off the
    fused path hands the kernel the bf16 (P, F) feature of key
    `a+b@bf16`. (64^2 frames.)"""
    seen = {"mlp": [], "rows": [], "vols": [], "feats": []}
    r = _port(64, ray_cap=4096, pallas_point=False)
    b = small[1][0]
    enc = r.encode_fn()(b["src_imgs"])
    assert enc.dtype == torch.bfloat16 and enc.shape == (3, 16, 16, 32)
    assert torch.equal(enc, r.encoder(src_norm(b["src_imgs"])))
    hooks = [m.register_forward_hook(
        lambda m, i, o: seen["mlp"].append((i[0].dtype, o.dtype)))
        for m in r.modules() if isinstance(m, MLP)]
    gather, tables = port_demo.project_and_gather_quad_merged, r._geometry_tables

    def rows(*a, **k):
        out = gather(*a, **k)
        seen["rows"].append(out[0].dtype)
        return out

    def geometry(vols, level_feats, *a):
        seen["vols"].append(([v.dtype for v in vols if v is not None],
                             [f.dtype for f in level_feats]))
        return tables(vols, level_feats, *a)

    monkeypatch.setattr(port_demo, "project_and_gather_quad_merged", rows)
    monkeypatch.setattr(r, "_geometry_tables", geometry)
    with torch.no_grad():
        pre = prepare_frame(b, enc, r.max_out_sh)
        feats = r.nerfhead.volume(pre["smpl_feat"], pre["vertex_rows"], pre["grids"])
        r._demo_impl(b, enc)
    for h in hooks:
        h.remove()
    assert pre["smpl_feat"].dtype == torch.float32  # the attention stays float32
    assert all(f.dtype == torch.float32 for f in feats)
    assert seen["mlp"] and all(o == torch.bfloat16 for _, o in seen["mlp"])
    assert seen["rows"] == [torch.bfloat16]
    (vols, lf), = seen["vols"]
    assert vols == [torch.bfloat16] * 3 and lf == [torch.float32] * 4

    fused = _port(64, ray_cap=4096, kernel_octet=False)
    key = fused.kernel_form()
    assert key == ps.Key(("i8",), "feats96-bf16", False) and ps.FORMS[key] == "a+b@bf16"
    real = port_demo.fused_point_stages_from_tables

    def capture(*a, **k):
        seen["feats"].append(k["feats"].dtype)
        return real(*a, **k)

    monkeypatch.setattr(port_demo, "fused_point_stages_from_tables", capture)
    with torch.no_grad():
        fused._demo_impl(b, enc)
    assert seen["feats"] == [torch.bfloat16]


def test_encoder_stage_matches_jax(batch, jax_model):
    """The bf16 encoder on the frame's source images against JAX's bf16
    encoder compiled with excess precision off. Two bf16 computations whose
    float32 sums run in other orders drift apart by bf16 steps through 23
    convolutions, about as far as JAX's float32 encoder lies from its bf16
    one: measured median 2.9e-3, max 0.031 (26% of the values equal),
    JAX's float32 encoder 3.4e-3 / 0.034 and JAX's own default jit of its
    bf16 encoder 3.9e-3 / 0.042; held within 1.5x of the float32 gap."""
    jr, jr32, variables = jax_model
    imgs = jax_src_norm(jnp.asarray(batch["src_imgs"]))
    ref = np.asarray(_compiled(jr.encoder.apply, variables["encoder"], imgs)(
        variables["encoder"], imgs)).astype(np.float32)
    f32 = np.asarray(jr32.encoder.apply(variables["encoder"], imgs))
    r = _port()
    out = r.encode_fn()(torch.from_numpy(batch["src_imgs"]))
    assert out.dtype == torch.bfloat16
    d = np.abs(out.float().numpy() - ref)
    d32 = np.abs(f32 - ref)
    assert np.median(d) < 1.5 * np.median(d32) and d.max() < 1.5 * d32.max(), (
        np.median(d), d.max(), np.median(d32), d32.max())
    assert np.mean(d == 0) > 0.15  # both sides round at the same places


def test_sparse_stack_stage_matches_jax(batch, jax_model):
    """The sparse stack in bf16 (operands cast before the row gather, float32
    sums and BatchNorms) on the same fused codes: one row convolution within
    1e-6 relative of JAX's (measured 1.4e-7); the four float32 level
    matrices within 5e-3 of their largest value and nearer JAX's bf16 stack
    than JAX's float32 stack is (measured 8.0e-4 / 1.8e-3 / 2.8e-3 / 3.4e-3
    by level, 58-67% of the values equal; JAX's float32 stack 5.1e-3 /
    6.9e-3 / 8.6e-3 / 5.2e-3): a conv input that differs in the last
    float32 bit can round to the neighbouring bf16 value, and the stack
    carries that on."""
    jr, jr32, variables = jax_model
    hv = variables["head"]
    r = _port()
    b = batch_to_device(batch, "cpu")
    with torch.no_grad():
        pre = prepare_frame(b, r.encode_fn()(b["src_imgs"]), r.max_out_sh)
        code = r.nerfhead.sigmahead.volume_features
        fused = r.nerfhead.sigmahead.fuse_codes(pre["smpl_feat"])
    jpre = jr.prepare_frame({k: jnp.asarray(v) for k, v in batch.items()},
                            jnp.zeros((3, H // 4, W // 4, 32)))
    j_levels, vr = jpre["grids"], jpre["vertex_rows"]
    fused_j = jnp.asarray(fused.numpy())

    def stack(m, f):
        return m.sigmahead.volume_features(f, vr, j_levels, train=False)

    ref = _compiled(lambda h, f: jr.nerfhead.apply(h, f, method=stack), hv, fused_j)(hv, fused_j)
    ref32 = jr32.nerfhead.apply(hv, fused_j, method=stack)
    with torch.no_grad():
        got = code(fused, pre["vertex_rows"], pre["grids"])
    for i, (g, j, j32) in enumerate(zip(got, ref, ref32)):
        assert g.dtype == torch.float32 and np.asarray(j).dtype == np.float32
        valid = b[f"lvl{i + 1}_valid"].numpy()
        g, j, j32 = g.numpy()[valid], np.asarray(j)[valid], np.asarray(j32)[valid]
        scale = np.abs(j).max()
        d, d32 = np.abs(g - j).max() / scale, np.abs(j32 - j).max() / scale
        assert d < 5e-3 and d < d32 and np.mean(g == j) > 0.4, (i, d, d32, np.mean(g == j))

    # one row convolution on the same rows and weight
    rs = np.random.RandomState(5)
    lv0 = pre["grids"][0]
    x = rs.randn(lv0.nbr.shape[0], 32).astype(np.float32)
    w = (rs.randn(27, 32, 32) * 0.1).astype(np.float32)
    j_out = _compiled(lambda x, w: jax_subm_conv(x, j_levels[0], w, compute_dtype=jnp.bfloat16),
                      jnp.asarray(x), jnp.asarray(w))(jnp.asarray(x), jnp.asarray(w))
    p_out = subm_conv_tbl(torch.from_numpy(x), lv0, torch.from_numpy(w),
                          compute_dtype=torch.bfloat16)
    assert p_out.dtype == torch.float32
    j_out = np.asarray(j_out)
    np.testing.assert_allclose(p_out.numpy(), j_out, rtol=0, atol=1e-6 * np.abs(j_out).max())


def test_heads_stage_matches_jax(jax_model):
    """The sigma-feature linear, density and color heads in bf16 on the same
    bf16 inputs against JAX's, compiled with excess precision off: nearly
    every value the same bf16 number (measured 100% / 100% / 99.96%), the
    rest one bf16 step away."""
    jr, _, variables = jax_model
    hv = variables["head"]
    r = _port()
    rs = np.random.RandomState(11)
    N, V, C = 500, 3, 35

    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)

    feats = bf(np.abs(rs.randn(N, 128)) * 0.3)
    rgb_feat = bf(rs.randn(N, V, C) * 0.5)
    nvo = torch.from_numpy(rs.randint(0, 4, size=(N, 1)).astype(np.float32))
    with torch.no_grad():
        mean, var = port_demo.fused_mean_variance(rgb_feat)
        sf = r.nerfhead.sigmahead.out_geometry_fc(feats)
        sigma = r.nerfhead.rgbhead.density(sf, mean[:, 0], var[:, 0], nvo)
        rgb = r.nerfhead.rgbhead.color(rgb_feat, mean, var)
    assert sf.dtype == sigma.dtype == rgb.dtype == mean.dtype == torch.bfloat16

    def heads(h, feats, rgb_feat, mean, var, nvo):
        def body(m):
            sf = m.sigmahead.out_geometry_fc(feats)
            return sf, m.rgbhead.density(sf, mean[:, 0], var[:, 0], nvo), m.rgbhead.color(
                rgb_feat, mean, var)
        return jr.nerfhead.apply(h, method=body)

    j = lambda t: jnp.asarray(t.float().numpy(), t.dtype == torch.bfloat16 and jnp.bfloat16  # noqa: E731
                              or jnp.float32)
    args = (hv, j(feats), j(rgb_feat), j(mean), j(var), j(nvo))
    refs = _compiled(heads, *args)(*args)
    for name, got, ref, share in (("sigma_feat", sf, refs[0], 0.999), ("sigma", sigma, refs[1], 0.999),
                                  ("rgb", rgb, refs[2], 0.995)):
        got, ref = got.float().numpy(), np.asarray(ref, np.float32)
        assert np.mean(got == ref) >= share, (name, np.mean(got == ref))
        np.testing.assert_allclose(got, ref, rtol=2 ** -6, atol=2e-3, err_msg=name)


def test_render_demo_scan_fn_matches_the_frames(small):
    r, frames = small
    per = [r.render_demo(f) for f in frames]
    out = r.render_demo_scan_fn()(port_demo.stack_frames(frames), torch.tensor([0, 1, 0]))
    assert set(out) == {"overflows", "counts", "checksum"}
    assert out["overflows"].shape == (3, 4) and out["counts"].shape == (3, 3)
    assert out["checksum"].shape == (3,)
    for i, f in enumerate((0, 1, 0)):
        assert torch.equal(out["overflows"][i], per[f]["overflows"])
        assert torch.equal(out["counts"][i], per[f]["counts"])
        want = per[f]["pred_chw"].sum() + per[f]["rgb_map"].sum() + per[f]["mask_at_box"].sum()
        assert torch.equal(out["checksum"][i], want)
    assert not torch.equal(per[0]["counts"], per[1]["counts"])  # two distinct frames


def test_render_returns_etime_and_rtime(small):
    r, frames = small
    ret = r.render(frames[0])
    want = r.render_demo(frames[0])
    assert set(ret) == set(want) | {"etime", "rtime"}
    assert ret["etime"] > 0 and ret["rtime"] > 0
    for k, v in want.items():
        assert torch.equal(ret[k], v), k
