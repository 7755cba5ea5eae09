"""Kernel 1 built from the key of any call (gpnerf_tpu_torch/ops/point_stages.py
`Key`, `check_key`, `form_name`): any projection row types, geometry tables
and occ_geom, and 1-8 source views, against the JAX package.

- The plain version (the CPU path and the card's reference) against JAX
  `fused_point_stages_tabs(..., interpret=True)` on the same seeded numpy
  inputs, at V = 2 and 4 and for keys that FORMS does not name.
- The renderer's switch space: every switch set the constructor takes
  builds with `pallas_point` on, and its key validates and names a library
  of its own.
- Whole fused renders (128^2 synthetic frames, float32) against JAX
  `render_demo_fn`: the fast mode at V = 2, 3 and 4 (the checkpoint is
  V = 3, so its rgb_fc's first layer is a seeded JAX init of that V, loaded
  through `from_jax_variables` with strict=True), the paper tables with
  sigma_query_cull and coarse_nearest 0, merge_src_feat with
  sigma_query_cull; the V = 4 op-by-op render; the heads at V = 4."""

import copy
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnerf_tpu.config import cfg as jax_cfg
from gpnerf_tpu.models.heads import NeRFRGBHead as JaxRGBHead
from gpnerf_tpu.ops.pallas_point import fused_point_stages_tabs
from gpnerf_tpu.ops.pallas_point import pack_head_weights as jax_pack
from gpnerf_tpu.registry import get as jax_get
from gpnerf_tpu_torch.config import cfg as port_cfg
from gpnerf_tpu_torch.models.heads import NeRFRGBHead, build_head
from gpnerf_tpu_torch.ops import point_stages as ps
from gpnerf_tpu_torch.registry import get as port_get
from gpnerf_tpu_torch.render.base import batch_to_device
from gpnerf_tpu_torch.render.demo import Renderer
from gpnerf_tpu_torch.train.checkpoint import from_jax_variables, load_eval_model
from point_tables import cover_keys, reachable_kernel_keys
from test_torch_float_rows import _geom_inputs, _table
from test_torch_geom_layouts import (  # noqa: F401 (few_torch_threads: autouse fixture)
    CKPT,
    assert_matches_jax,
    few_torch_threads,
    jax_variables,
    make_cfg,
)
from test_torch_point_forms import _heads, _port_weights

# keys FORMS does not name -> their names: forms (a) and (c) at 2 and 4
# views, and switch sets the renderer reaches since the kernel is built
# from the key (sigma_query_cull with coarse_nearest 0 on the paper tables;
# merge_src_feat with sigma_query_cull; l1_nearest 1 with coarse_nearest 0;
# quantize_proj off with l1_nearest 1 under float32; merge_src_feat with
# quantize_volume off and the query cull under float32; float sources with
# int4_feat)
NEW_KEYS = {
    "a@V2": ps.Key(("i8",), "default", False, 2),
    "a@V4": ps.Key(("i8",), "default", False, 4),
    "c@V2": ps.Key(("u8", "i8"), "default", False, 2),
    "c@V4": ps.Key(("u8", "i8"), "default", False, 4),
    "c+e@coarse-octet": ps.Key(("u8", "i8"), "coarse-octet", True),
    "a:bf16+e": ps.Key(("bf16",), "default", True),
    "a@(1,32,u8)+(8,64,i8)": ps.Key(("i8",), ((1, 32, "u8"), (8, 64, "i8")), False),
    "c:u8/f32@l1-nearest": ps.Key(("u8", "f32"), "l1-nearest", False),
    "a:f32+e@float32": ps.Key(("f32",), "float32", True),
    "c:bf16/i4": ps.Key(("bf16", "i4"), "default", False),
}


@pytest.mark.parametrize("name", sorted(NEW_KEYS))
def test_key_plain_matches_pallas_interpret(name):
    """The plain version of a key FORMS does not name against the Pallas
    kernel, with the tolerances of tests/test_torch_point_forms.py: a
    float32 ulp can move a bf16 dot input across a rounding edge for a point
    or two."""
    key = NEW_KEYS[name]
    assert ps.check_key(key) == key and key not in ps.FORMS and ps.form_name(key) == name
    rows, layout, occ, V = key
    rs = np.random.RandomState(13)
    P, CS, CF = 300, ps.CS, ps.CF
    widths = (ps.C,) if len(rows) == 1 else (CS, CF)
    tabs = [_table(rs, kind, Ct, V, P) for kind, Ct in zip(rows, widths)]
    feats, geom = _geom_inputs(rs, layout, P, occ)
    geom = [(g, w, sc, kind) for (g, w, sc), (_, _, kind) in zip(geom, ps.geom_specs(layout))]
    vmask = (rs.rand(V, P) > 0.15).astype(np.float32)
    sig_ok = rs.rand(P) > 0.2
    F = sum(t[1] for t in ps.geom_specs(layout))
    fold = ps.C0 if F == ps.C0 + ps.C1 else None
    hp = _heads(V, CS + CF, 128)

    def t_rows(x, bf):
        return torch.from_numpy(x).to(torch.bfloat16) if bf else torch.from_numpy(x)

    def j_rows(x, bf):
        return jnp.asarray(x, jnp.bfloat16) if bf else jnp.asarray(x)

    t_args = (tuple((t_rows(r, bf), torch.from_numpy(w), torch.from_numpy(s))
                    for r, w, s, bf in tabs),
              None, torch.from_numpy(vmask), torch.from_numpy(sig_ok), _port_weights(hp, fold))
    j_args = (tuple((j_rows(r, bf), jnp.asarray(w), jnp.asarray(s)) for r, w, s, bf in tabs),
              None, jnp.asarray(vmask), jnp.asarray(sig_ok), jax_pack(hp, CS + CF, fold_nch=fold))
    kw_t = {"geom_tabs": tuple((t_rows(g, k == "bf16"), torch.from_numpy(w), torch.from_numpy(sc))
                               for g, w, sc, k in geom), "occ_geom": occ}
    kw_j = {"geom_tabs": tuple((j_rows(g, k == "bf16"), jnp.asarray(w), jnp.asarray(sc))
                               for g, w, sc, k in geom), "occ_geom": occ}
    assert feats is None
    out_j = [np.asarray(o) for o in fused_point_stages_tabs(*j_args, block=256, interpret=True,
                                                           **kw_j)]
    out = [o.numpy() for o in ps.point_stages_tabs_plain(*t_args, **kw_t)]
    assert len(out) == len(out_j) == (3 if occ else 2)
    a, rgb = out[:2]
    a_j, rgb_j = out_j[:2]
    d = np.abs(a - a_j)
    assert (d > 1e-4).sum() <= 2 and d.max() < 0.08, np.sort(d)[-4:]
    alive, alive_j = a > 1e-14, a_j > 1e-14
    assert (alive != alive_j).sum() <= 1
    dr = np.abs(rgb - rgb_j)[alive == alive_j].max(axis=1)
    assert (dr > 1e-4).sum() <= 4 and dr.max() < 0.08, np.sort(dr)[-8:]
    assert alive.mean() > 0.1 and (rgb[alive] > 0).all()
    if occ:
        np.testing.assert_array_equal(out[2], out_j[2])
        assert 0.2 < out[2].mean() < 0.9


def test_switch_space_keys_validate_and_build_apart():
    """Every Renderer switch set (tests/point_tables.py
    `reachable_kernel_keys`: 14 booleans, coarse_nearest 0-2, l1_nearest 0,
    1, 2 and 11, bfloat16 or float32) builds with pallas_point on; its keys
    for uint8 and float source images validate, and the 336 distinct keys
    (32 of them FORMS') have distinct names and one library each, whose
    geometry tables are octet (8 taps) or nearest (1 tap) rows, or the (P,
    F) feature. The cover set (`cover_keys`) with FORMS puts every row type
    in table positions A and B, every geometry spec in every table position
    where the space has it, occ_geom on every table-0 spec, and forms (a)
    and (c) at 2, 4 and 8 views. The view count joins the key and the
    library name; V = 9 is refused."""
    keys = reachable_kernel_keys()
    assert len(keys) == 336 and sum(k in ps.FORMS for k in keys) == 32
    assert all(ps.check_key(k) == k for k in keys)
    assert len({ps.form_name(k) for k in keys}) == len(keys)
    assert len({ps.build_command(k)[1] for k in keys}) == len(keys)
    assert all(t in (1, 8) for k in keys for t, _, _ in ps.geom_specs(k.geom))
    cover = list(ps.FORMS) + [ps.check_key(k) for k in cover_keys()]

    def traits(ks):
        out = set()
        for k in ks:
            specs = ps.geom_specs(k.geom)
            out |= {("row A", k.rows[0])} | {("row B", r) for r in k.rows[1:]}
            out |= {("table", i, spec) for i, spec in enumerate(specs)}
            if k.occ:
                out.add(("occ", specs[0]))
        return out

    assert traits(keys) <= traits(cover), traits(keys) - traits(cover)
    for rows in (("i8",), ("u8", "i8")):
        assert {k.views for k in cover if k.rows == rows and k.geom == "default"} >= {2, 3, 4, 8}
    libs = {ps.build_command(ps.Key(("i8",), "default", False, v))[1] for v in range(1, 9)}
    assert len(libs) == 8
    with pytest.raises(NotImplementedError, match="views"):
        Renderer(None, None, voxel_size=(0.005,) * 3, n_views=9)
    Renderer(None, None, voxel_size=(0.005,) * 3, n_views=9, pallas_point=False)


def _cfg(base, views=3, **tpu):
    """tests/test_torch_geom_layouts.py's 128^2 float32 config with `views`
    source views (all ten training cameras offered: cam_num -1)."""
    cfg = make_cfg(base, **tpu)
    cfg.defrost()
    cfg.src_view_num = views
    if views != 3:
        cfg.cam_num = -1
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module")
def frames():
    """views -> the test frame with that many source views, as the JAX
    package's data pipeline builds it."""
    out = {}
    for views in (2, 3, 4):
        cfg = _cfg(jax_cfg, views)
        np.random.seed(0)
        random.seed(0)
        out[views] = jax_get("dataset", cfg.dataset.test.file)(cfg, is_train=False)[0]
        assert out[views]["src_imgs"].shape[0] == views
    return out


def _rgb_fc_init(views):
    """A seeded JAX init of the color head at `views` views: its rgb_fc's
    first kernel (views * 32, 32)."""
    params = JaxRGBHead(in_feat_ch=32).init(
        jax.random.PRNGKey(views), jnp.zeros((2, 2, views, 35)), jnp.zeros((2, 2, 64)),
        jnp.zeros((2, 2, views, 1)))["params"]
    return params["rgb_fc"]["dense_0"]["kernel"]


@pytest.fixture(scope="module")
def variables(frames):
    """"checkpoint" -> the checkpoint's JAX variables (3 views); V -> the
    same with rgb_fc's first layer a seeded init of V views (the
    checkpoint's takes 3), for V = 2, 3 and 4."""
    base = jax_variables(frames[3])
    out = {"checkpoint": base}
    for views in (2, 3, 4):
        v = copy.deepcopy(jax.tree_util.tree_map(np.asarray, base))
        v["head"]["params"]["rgbhead"]["rgb_fc"]["dense_0"]["kernel"] = np.asarray(
            _rgb_fc_init(views))
        out[views] = v
    return out


def _views(weights):
    return 3 if weights == "checkpoint" else weights


@pytest.fixture(scope="module")
def jax_renders(frames, variables):
    cache = {}

    def get(weights, **tpu):
        key = (weights, tuple(sorted(tpu.items())))
        if key not in cache:
            jr = jax_get("render", "demo_render")(_cfg(jax_cfg, _views(weights), **tpu))
            ret = jr.render_demo_fn()(
                jax.tree_util.tree_map(jnp.asarray, variables[weights]),
                {k: jnp.asarray(v) for k, v in frames[_views(weights)].items()})
            cache[key] = {k: np.asarray(v) for k, v in ret.items()}
        return cache[key]

    return get


def _port_render(frames, variables, weights, key=None, **tpu):
    """The port's render on the CPU with the checkpoint (`weights`
    "checkpoint") or the seeded JAX variables of `weights` views, loaded
    through from_jax_variables (strict); `key`: the point-stage key its
    fused path must launch."""
    views = _views(weights)
    r = port_get("render", "demo_render")(_cfg(port_cfg, views, **tpu), device="cpu")
    if key is not None:
        assert r.kernel_form() == key, r.kernel_form()
    if weights == "checkpoint":
        load_eval_model(CKPT, r)
    else:
        r.load_state_dict(from_jax_variables(variables[weights]), strict=True)
    return {k: v.numpy() for k, v in r.render_demo_fn()(batch_to_device(frames[views], "cpu")).items()}


@pytest.mark.parametrize("views", [2, 3, 4])
def test_fused_render_matches_jax_with_seeded_heads(views, frames, variables, jax_renders):
    """The fast mode's fused path at V = 2, 3 and 4 (keys a@V2, a, a@V4)
    with a seeded first rgb_fc layer: integers bitwise. The seeded layer
    moves the colors' bf16 numerics at every V, 3 included (the trained
    head reads median 4.6e-4 against JAX's float32 op-by-op render, ROADMAP
    Queue 3), so the median is held to 1e-3 and the max to Queue 3's 0.031."""
    key = ps.Key(("i8",), "default", False, views)
    med, mx, _ = assert_matches_jax(_port_render(frames, variables, views, key),
                                    jax_renders(views), median_tol=1e-3, max_tol=0.031)
    print(f"fused V = {views}, seeded rgb_fc, vs JAX: |d| median {med:.2e} max {mx:.4f}")


def test_opbyop_render_matches_jax_at_four_views(frames, variables, jax_renders):
    """The op-by-op point stages at V = 4: float32 on both sides, the heads
    flattening 4 views (|d| median 3e-7 measured)."""
    med, mx, _ = assert_matches_jax(
        _port_render(frames, variables, 4, pallas_point=False), jax_renders(4),
        median_tol=1e-6, max_tol=0.031)
    print(f"op-by-op V = 4 vs JAX: |d| median {med:.2e} max {mx:.4f}")


NEW_SETS = {
    # the paper tables' split pair with the fast mode's query cull on the
    # coarse octet table: key c+e@coarse-octet
    "paper tables, sigma_query_cull, coarse_nearest 0": (
        dict(merge_lowres_src=False, sigma_query_cull=True, coarse_nearest=0),
        ps.Key(("u8", "i8"), "coarse-octet", True)),
    # the merged float32 source-resolution table with the query cull:
    # a:f32+e (a:bf16+e under bfloat16)
    "merge_src_feat, sigma_query_cull": (
        dict(merge_src_feat=True, sigma_query_cull=True), ps.Key(("f32",), "default", True)),
}


@pytest.mark.parametrize("case", sorted(NEW_SETS))
def test_newly_reachable_switch_sets_match_jax(case, frames, variables, jax_renders):
    """Switch sets the constructor refused before the kernel was built from
    the key, with the checkpoint: integers bitwise, colors within Queue 3's
    gaps (median <= 5e-4, every pixel but the last row within 0.031)."""
    tpu, key = NEW_SETS[case]
    med, mx, _ = assert_matches_jax(_port_render(frames, variables, "checkpoint", key, **tpu),
                                    jax_renders("checkpoint", **tpu), max_tol=0.031)
    print(f"{case} vs JAX: |d| median {med:.2e} max {mx:.4f}")


def test_heads_follow_src_view_num():
    """build_head gives rgb_fc V * 32 inputs; at V = 4 the color head equals
    JAX's on seeded inputs (float32)."""
    cfg = _cfg(port_cfg, 4)
    head = build_head(cfg)
    assert head.rgbhead.rgb_fc[0].in_features == 128
    rs = np.random.RandomState(21)
    feat = (rs.randn(2, 5, 4, 35) * 0.5).astype(np.float32)
    sigma_feat = rs.randn(2, 5, 64).astype(np.float32)
    mask = (rs.rand(2, 5, 4, 1) > 0.2).astype(np.float32)
    jh = JaxRGBHead(in_feat_ch=32)
    params = jh.init(jax.random.PRNGKey(4), jnp.asarray(feat), jnp.asarray(sigma_feat),
                     jnp.asarray(mask))
    _, rgb_j, sigma_j = jh.apply(params, jnp.asarray(feat), jnp.asarray(sigma_feat),
                                 jnp.asarray(mask))
    port = NeRFRGBHead(in_feat_ch=32, n_views=4)
    with torch.no_grad():
        for name in ("base_fc", "vis_fc", "rgb_fc", "out_geometry_fc"):
            mlp = getattr(port, name)
            lins = [m for m in mlp if isinstance(m, torch.nn.Linear)]
            for k, lin in enumerate(lins):
                tree = params["params"][name][f"dense_{k}"]
                lin.weight.copy_(torch.from_numpy(np.asarray(tree["kernel"]).T.copy()))
                lin.bias.copy_(torch.from_numpy(np.array(tree["bias"])))
        _, rgb, sigma = port(torch.from_numpy(feat), torch.from_numpy(sigma_feat),
                             torch.from_numpy(mask))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(sigma_j), rtol=0, atol=1e-6)
