"""The point-stage forms, float projection rows and bf16 quad-lerp rows that
the paper configs' table choices and the progressive switch pairs reach
(gpnerf_tpu_torch/ops/point_stages.py forms a+e, c+d+e, b+c+d and the
merged and split float-row forms; ops/quad_lerp.py bf16 rows; the float-row
gathers and samplers of ops/projection.py and ops/grid_sample.py), each
against the JAX package on the same numpy-seeded inputs. The Pallas kernels
run in interpret mode, as the JAX package's own tests run them on the CPU.
The inputs are at the widths the CUDA kernel is built for (V = 3, C = 35 or
3 + 32, a u8 level-1 octet table of 32 channels and an int8 coarse table
of 64, or a (P, 96) feature input)."""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnerf_tpu.ops import grid_sample as jgs
from gpnerf_tpu.ops import pallas_lerp as jpl
from gpnerf_tpu.ops import projection as jproj
from gpnerf_tpu.ops.pallas_point import fused_point_stages_tabs
from gpnerf_tpu.ops.pallas_point import pack_head_weights as jax_pack
from gpnerf_tpu_torch.ops import grid_sample as pgs
from gpnerf_tpu_torch.ops import point_stages as ps
from gpnerf_tpu_torch.ops import projection as pproj
from gpnerf_tpu_torch.ops import quad_lerp as pql
from test_torch_point_forms import _heads, _port_weights

NEW_FORMS = ["a+e", "c+d+e", "b+c+d", "a:bf16", "a:f32", "c:u8/bf16", "c:u8/f32",
             "c:bf16/i8", "c:f32/i8"]
KEYS = {name: key for key, name in ps.FORMS.items()}


def _bf16_values(x):
    """float32 numpy values that bf16 holds exactly."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _table(rs, kind, Ct, V, P):
    """(rows, w4, scale, bf) of one projection table as numpy; bf: the rows
    are bf16 values, handed to torch and JAX as bfloat16."""
    w4 = (rs.rand(V, 4, P) * (rs.rand(V, 4, P) > 0.1)).astype(np.float32)
    if kind == "i8":
        return rs.randint(-127, 128, size=(V * P, 4 * Ct)).astype(np.int8), w4, (
            0.02 + rs.rand(Ct) * 0.05).astype(np.float32), False
    if kind == "i4":
        return rs.randint(0, 256, size=(V * P, 2 * Ct)).astype(np.uint8), w4, (
            0.02 + rs.rand(Ct) * 0.05).astype(np.float32), False
    if kind == "u8":
        return (rs.randint(0, 256, size=(V * P, 4 * Ct)).astype(np.uint8), w4,
                np.full((Ct,), 1.0 / 255.0, np.float32), False)
    vals = (rs.randn(V * P, 4 * Ct) * 0.5).astype(np.float32)
    if kind == "bf16":
        return _bf16_values(vals), w4, np.ones((Ct,), np.float32), True
    return vals, w4, np.ones((Ct,), np.float32), False


def _geom_inputs(rs, layout, P, occ):
    """Seeded geometry tables of one layout (a ps.GEOMS name or the specs)
    as numpy: (feats, geom_tabs); occ empties table 0's rows of 40% of the
    points, so the occupancy cull bites."""
    tables = ps.geom_specs(layout)
    if tables[0][2] in ("feat", "feat-bf16"):  # bf16 features are cast by the caller
        return (rs.randn(P, tables[0][1]) * 0.5).astype(np.float32), ()
    geom = []
    for i, (taps, ch, kind) in enumerate(tables):
        if kind in ("u8", "i8"):
            lo, hi = (0, 256) if kind == "u8" else (-127, 128)
            g = rs.randint(lo, hi, size=(P, taps * ch)).astype(np.uint8 if kind == "u8" else np.int8)
            sc = (0.01 + rs.rand(ch) * 0.03).astype(np.float32)
        else:  # float rows (bf16 ones are cast by the caller), unit scale
            g = (rs.rand(P, taps * ch) * 0.5).astype(np.float32)
            sc = np.ones((ch,), np.float32)
        if occ and i == 0:
            g[rs.rand(P) > 0.6] = 0
        if taps > 1:
            w = rs.rand(taps, P).astype(np.float32)
            w /= w.sum(0)
        else:
            w = (rs.rand(1, P) > 0.05).astype(np.float32)
        geom.append((g, w, sc))
    return None, tuple(geom)


def _form_inputs(name, P=300, seed=0):
    """Seeded inputs of one FORMS entry, as (port args, port kwargs, JAX
    args, JAX kwargs)."""
    rows, layout, occ = KEYS[name][:3]
    use_feats = layout == "feats96"
    rs = np.random.RandomState(seed)
    V, CS, CF, C0, C1 = ps.V, ps.CS, ps.CF, ps.C0, ps.C1
    widths = (ps.C,) if len(rows) == 1 else (CS, CF)
    tabs = [_table(rs, kind, Ct, V, P) for kind, Ct in zip(rows, widths)]
    t_tabs = tuple((torch.from_numpy(r).to(torch.bfloat16) if bf else torch.from_numpy(r),
                    torch.from_numpy(w), torch.from_numpy(s)) for r, w, s, bf in tabs)
    j_tabs = tuple((jnp.asarray(r, jnp.bfloat16) if bf else jnp.asarray(r), jnp.asarray(w),
                    jnp.asarray(s)) for r, w, s, bf in tabs)
    vmask = (rs.rand(V, P) > 0.15).astype(np.float32)
    sig_ok = rs.rand(P) > 0.2
    feats, geom = None, ()
    if use_feats:
        feats = (rs.randn(P, C0 + C1) * 0.5).astype(np.float32)
    else:
        g0 = rs.randint(0, 256, size=(P, 8 * C0)).astype(np.uint8)
        if occ:  # empty level-1 cells, so the occupancy cull bites
            g0 *= (rs.rand(P, 1) > 0.4).astype(np.uint8)
        gw0 = rs.rand(8, P).astype(np.float32)
        geom = ((g0, gw0 / gw0.sum(0), (0.01 + rs.rand(C0) * 0.03).astype(np.float32)),
                (rs.randint(-127, 128, size=(P, C1)).astype(np.int8),
                 (rs.rand(1, P) > 0.05).astype(np.float32),
                 (0.01 + rs.rand(C1) * 0.03).astype(np.float32)))
    hp = _heads(V, CS + CF, C0 + C1)
    t_args = (t_tabs, None if feats is None else torch.from_numpy(feats),
              torch.from_numpy(vmask), torch.from_numpy(sig_ok), _port_weights(hp, C0))
    j_args = (j_tabs, None if feats is None else jnp.asarray(feats), jnp.asarray(vmask),
              jnp.asarray(sig_ok), jax_pack(hp, CS + CF, fold_nch=C0))
    t_kw = {"geom_tabs": tuple(tuple(torch.from_numpy(x) for x in g) for g in geom)}
    j_kw = {"geom_tabs": tuple(tuple(jnp.asarray(x) for x in g) for g in geom)}
    if occ:
        t_kw["occ_geom"] = j_kw["occ_geom"] = True
    return t_args, t_kw, j_args, j_kw


@pytest.mark.parametrize("name", NEW_FORMS)
def test_new_form_plain_matches_pallas_interpret(name):
    t_args, t_kw, j_args, j_kw = _form_inputs(name)
    out_j = [np.asarray(o) for o in fused_point_stages_tabs(*j_args, block=256, interpret=True,
                                                           **j_kw)]
    out = [o.numpy() for o in ps.point_stages_tabs_plain(*t_args, **t_kw)]
    occ = KEYS[name][2]
    assert len(out) == len(out_j) == (3 if occ else 2)
    a, rgb = out[:2]
    a_j, rgb_j = out_j[:2]
    # the bounds of tests/test_torch_point_forms.py: the same bf16-input /
    # f32-accumulate numerics with sums in another order, so a float32 ulp
    # can move a dot input across a bf16 rounding edge for a point or two
    d = np.abs(a - a_j)
    assert (d > 1e-4).sum() <= 2, np.sort(d)[-4:]
    assert d.max() < 0.08
    alive, alive_j = a > 1e-14, a_j > 1e-14
    assert (alive != alive_j).sum() <= 1
    dr = np.abs(rgb - rgb_j)[alive == alive_j].max(axis=1)
    assert (dr > 1e-4).sum() <= 4 and dr.max() < 0.08, np.sort(dr)[-8:]
    assert alive.mean() > 0.2 and (rgb[alive] > 0).all()
    if occ:
        # a sum of non-negative terms compared with 0 on both sides
        np.testing.assert_array_equal(out[2], out_j[2])
        assert 0.2 < out[2].mean() < 0.9
    # the plain version on the CPU launches nothing and repeats itself
    before = sum(ps.LAUNCHES.values())
    again = ps.point_stages_tabs_plain(*t_args, **t_kw)
    assert sum(ps.LAUNCHES.values()) == before
    for o, o_p in zip(again, out):
        np.testing.assert_array_equal(o.numpy(), o_p)


def test_float32_rows_round_to_bf16():
    """f32 rows are rounded to bf16 before the tap sum (the TPU kernel's
    cast): unrounded f32 rows, their bf16 values held in f32 and the bf16
    rows themselves give bitwise the same outputs."""
    t_args, t_kw, _, _ = _form_inputs("a:f32", seed=3)
    (rows, w4, sc), = t_args[0]
    bf = ps.point_stages_tabs_plain(((rows.to(torch.bfloat16), w4, sc),), *t_args[1:], **t_kw)
    held = ps.point_stages_tabs_plain(((rows.to(torch.bfloat16).float(), w4, sc),),
                                      *t_args[1:], **t_kw)
    raw = ps.point_stages_tabs_plain(t_args[0], *t_args[1:], **t_kw)
    assert not torch.equal(rows, rows.to(torch.bfloat16).float())
    for x, y, z in zip(bf, held, raw):
        assert torch.equal(x, y) and torch.equal(x, z)


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [6, 35])
def test_vcp_bf16_rows_match_pallas_interpret(C, out):
    """Kernel 2 with bf16 rows: the TPU kernel sums them unchanged
    (`rows_ref[:].astype(jnp.bfloat16)`), in float32, one rounding."""
    rs = np.random.RandomState(5)
    V, P = 3, 300
    rows = _bf16_values(rs.randn(V * P, 4 * C).astype(np.float32))
    w4 = (rs.rand(V, 4, P) * (rs.rand(V, 4, P) > 0.1)).astype(np.float32)
    scale = (0.5 + rs.rand(C)).astype(np.float32)
    jdt, pdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[out]
    ref = jpl.quad_lerp_rows_vcp(jnp.asarray(rows, jnp.bfloat16), jnp.asarray(w4),
                                 jnp.asarray(scale), out_dtype=jdt, interpret=True, block=128)
    t_rows = torch.from_numpy(rows).to(torch.bfloat16)
    got = pql.quad_lerp_rows_vcp(t_rows, torch.from_numpy(w4), torch.from_numpy(scale),
                                 out_dtype=pdt)
    assert got.dtype == pdt and tuple(got.shape) == (V, C, P)
    ref = np.asarray(ref, np.float32)
    # XLA's CPU backend contracts the float32 multiply-add into an FMA, the
    # plain version rounds the product first (tests/test_torch_lerp.py)
    if out == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2.5e-7 * np.abs(ref).max())
    else:
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -7, atol=0)
        assert np.mean(got.float().numpy() != ref) < 1e-3
    # bitwise: float32 rows holding the same values (exact in bf16)
    same = pql.quad_lerp_rows_vcp_plain(torch.from_numpy(rows), torch.from_numpy(w4),
                                        torch.from_numpy(scale), out_dtype=pdt)
    assert torch.equal(same, got)


def _projection_case(Ht, C, V=3, P=500):
    rs = np.random.RandomState(4)
    h = w = 40
    img = _bf16_values(rs.randn(V, Ht, Ht, C).astype(np.float32))
    K = np.array([[30.0, 0, 20, 0], [0, 30.0, 20, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    KE = np.stack([K @ np.array(
        [[np.cos(t), 0, np.sin(t), 0.1 * i], [0, 1, 0, 0.05], [-np.sin(t), 0, np.cos(t), 3.0],
         [0, 0, 0, 1]], np.float32) for i, t in enumerate((0.0, 0.4, -0.5))]).astype(np.float32)
    xyz = (rs.rand(P, 3) * 3.0 - 1.5).astype(np.float32)
    return img, KE, xyz, h, w


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("Ht,C", [(40, 35), (10, 32)])
def test_project_gather_float_rows_match_jax(dtype, Ht, C):
    """The fused path's gather of a float table (the merged table, or the
    split pair's `batched` feature half): rows bitwise, flat and batched."""
    img, KE, xyz, h, w = _projection_case(Ht, C)
    pdt, jdt = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
                "float32": (torch.float32, jnp.float32)}[dtype]
    tab_p = pgs.build_quad_table_2d(torch.from_numpy(img).to(pdt))
    tab_j = jgs.build_quad_table_2d(jnp.asarray(img, jdt))
    for batched in (False, True):
        rows, w4, vm = pproj.project_gather_rows_merged(
            torch.from_numpy(xyz), torch.from_numpy(KE), tab_p, h, w, batched=batched)
        rows_j, w4_j, vm_j = jproj.project_gather_rows_merged(
            jnp.asarray(xyz), jnp.asarray(KE), tab_j, h, w, batched=batched)
        assert rows.dtype == pdt and tuple(rows.shape) == (3 * 500, 4 * C)
        np.testing.assert_array_equal(rows.float().numpy(), np.asarray(rows_j, np.float32))
        # float32 fractions of pixel coordinates up to 40 (the bound of
        # tests/test_torch_point_forms.py)
        np.testing.assert_allclose(w4.numpy(), np.asarray(w4_j), rtol=0, atol=4e-5)
        np.testing.assert_array_equal(vm.numpy(), np.asarray(vm_j))


def _interp(*a, **kw):
    kw.update(interpret=True, block=128)
    return _interp.orig(*a, **kw)


_interp.orig = jpl.quad_lerp_rows_vcp


@pytest.mark.parametrize("route", ["pv", "vp", "kernel"])
def test_merged_sampler_of_bf16_table_matches_jax(route):
    """The op-by-op merged sampler as the renderer calls it for a float
    table (scale None, out_dtype None, JAX render/demo.py:892-903): a bf16
    table is sampled in bf16 arithmetic (the torch-op routes) or summed in
    float32 and rounded once to bf16 (the kernel route)."""
    img, KE, xyz, h, w = _projection_case(40, 35)
    tab_p = pgs.build_quad_table_2d(torch.from_numpy(img).to(torch.bfloat16))
    tab_j = jgs.build_quad_table_2d(jnp.asarray(img, jnp.bfloat16))
    with mock.patch.object(jpl, "quad_lerp_rows_vcp", _interp):
        ref, vm_j = jproj.project_and_gather_quad_merged(
            jnp.asarray(xyz), jnp.asarray(KE), tab_j, h, w, vp_order=route == "vp",
            pallas=route == "kernel")
    assert ref.dtype == jnp.bfloat16
    got, vm = pproj.project_and_gather_quad_merged(
        torch.from_numpy(xyz), torch.from_numpy(KE), tab_p, h, w, vp_order=route == "vp",
        kernel=route == "kernel")
    ref = np.asarray(ref, np.float32)
    np.testing.assert_array_equal(vm.numpy(), np.asarray(vm_j))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape == (500, 3, 35)
    got = got.float()
    # the values are bf16 on both sides; a weight or a partial sum that the
    # two projections round apart moves a value by one bf16 step (2^-8
    # relative) on a few values, and where a sum cancels to near zero, by
    # one step of the larger partial sum
    assert np.array_equal(got.numpy(), _bf16_values(got.numpy()))
    close = np.isclose(got.numpy(), ref, rtol=2 ** -7, atol=2e-2)
    assert close.all(), np.abs(got.numpy() - ref).max()
    assert np.mean(got.numpy() == ref) > 0.97


def test_split_sampler_with_bf16_features_matches_jax():
    """`project_and_gather_quad` with the raw u8 pixels and a bf16 feature
    table (quantize_proj off): the rgb is rounded to the features' bf16, as
    the JAX package casts it."""
    rs = np.random.RandomState(6)
    img, KE, xyz, h, w = _projection_case(10, 32)
    src = rs.randint(0, 256, size=(3, 40, 40, 3)).astype(np.uint8)
    sc = np.full((3,), 1 / 255.0, np.float32)
    src_p, src_j = pgs.build_quad_table_2d(torch.from_numpy(src)), jgs.build_quad_table_2d(
        jnp.asarray(src))
    ft_p = pgs.build_quad_table_2d(torch.from_numpy(img).to(torch.bfloat16))
    ft_j = jgs.build_quad_table_2d(jnp.asarray(img, jnp.bfloat16))
    ref, vm_j = jproj.project_and_gather_quad(
        jnp.asarray(xyz), jnp.asarray(KE), src_j, ft_j, h, w, src_scale=jnp.asarray(sc))
    got, vm = pproj.project_and_gather_quad(
        torch.from_numpy(xyz), torch.from_numpy(KE), src_p, ft_p, h, w,
        src_scale=torch.from_numpy(sc))
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref, np.float32)
    np.testing.assert_array_equal(vm.numpy(), np.asarray(vm_j))
    assert got.shape == ref.shape == (500, 3, 35) and got.dtype == torch.bfloat16
    got = got.float()
    assert np.array_equal(got.numpy(), _bf16_values(got.numpy()))
    # as the merged sampler: one bf16 step where the projections round apart
    assert np.isclose(got.numpy(), ref, rtol=2 ** -7, atol=2e-2).all()
    assert np.mean(got.numpy() == ref) > 0.97
