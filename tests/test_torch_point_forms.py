"""The forms of the port's point-stage module beyond the fast mode's
(gpnerf_tpu_torch/ops/point_stages.py: (b) feature input, (c) split
projection tables, (d) int4 split-packed rows, (e) occ_geom) against the JAX
package's Pallas megakernel `fused_point_stages_tabs` run in interpret mode
on the CPU, on the seeded inputs of tests/test_pallas_point.py; and the two
table functions those forms rest on, `quantize_image_i4` and
`project_gather_rows_merged`, against their JAX counterparts. Both kernels
round every dot input to bf16 and accumulate in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnerf_tpu.models.heads import NeRFRGBHead
from gpnerf_tpu.models.layers import MLP as JaxMLP
from gpnerf_tpu.ops import grid_sample as jgs
from gpnerf_tpu.ops import projection as jproj
from gpnerf_tpu.ops.pallas_point import fused_point_stages_tabs
from gpnerf_tpu.ops.pallas_point import pack_head_weights as jax_pack
from gpnerf_tpu_torch.ops import grid_sample as pgs
from gpnerf_tpu_torch.ops import point_stages as ps
from gpnerf_tpu_torch.ops import projection as pproj
from point_tables import seeded_tables


def _heads(V, C, F):
    """Seeded flax head params as tests/test_pallas_point.py makes them."""
    rgbhead = NeRFRGBHead(in_feat_ch=C - 3)
    rgb_vars = rgbhead.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 2, V, C)), jnp.zeros((2, 2, 64)),
        jnp.zeros((2, 2, V, 1)),
    )
    sf_vars = JaxMLP((64,), ("elu",)).init(jax.random.PRNGKey(1), jnp.zeros((2, F)))
    return {
        "sigmahead": {"out_geometry_fc": sf_vars["params"]},
        "rgbhead": rgb_vars["params"],
    }


def _port_weights(head_params, fold_nch=None):
    """PointWeights straight from the flax params (Dense kernels are (in,
    out)), in the kernel's layer order."""
    def wb(tree):
        return (torch.from_numpy(np.array(tree["kernel"]).T.copy()),
                torch.from_numpy(np.array(tree["bias"])))

    sf = wb(head_params["sigmahead"]["out_geometry_fc"]["dense_0"])
    if fold_nch is not None:
        sf = (torch.cat([sf[0][:, :fold_nch], torch.eye(sf[0].shape[0])], dim=1), sf[1])
    rh = head_params["rgbhead"]
    layers = [sf]
    for name, n in (("out_geometry_fc", 4), ("base_fc", 2), ("vis_fc", 2), ("rgb_fc", 3)):
        layers += [wb(rh[name][f"dense_{k}"]) for k in range(n)]
    return ps.PointWeights(layers, ps._kernel_layout(layers))


def _t(x):
    if isinstance(x, (tuple, list)):
        return tuple(_t(y) for y in x)
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    if isinstance(x, (tuple, list)):
        return tuple(_j(y) for y in x)
    return None if x is None else jnp.asarray(x)


def _geometry(rs, P, C1, Cc, empty=0.0):
    """u8 level-1 octet table + int8 nearest coarse table sampled at P
    positions that include out-of-extent points."""
    D = Hh = W = 7
    vol1 = rs.randint(0, 255, size=(D, Hh, W, C1)).astype(np.uint8)
    if empty:
        vol1[rs.rand(D, Hh, W) > empty] = 0
    oct1 = jgs.build_octet_table_3d(jnp.asarray(vol1))
    sc1 = (0.01 + rs.rand(C1) * 0.03).astype(np.float32)
    volc = rs.randint(-127, 127, size=(D, Hh, W, Cc)).astype(np.int8)
    ntab = jgs.NearestTable(jnp.asarray(volc.reshape(-1, Cc)), (D, Hh, W), 2)
    scc = (0.01 + rs.rand(Cc) * 0.03).astype(np.float32)
    size = jnp.asarray([D, Hh, W])
    pos = jnp.asarray((rs.rand(P, 3) * (np.array([D, Hh, W]) + 0.5) - 0.5).astype(np.float32))
    g0, gw0 = jgs.octet_rows_and_weights(oct1, pos, size)
    g1, gw1 = jgs.nearest_row_and_weight(ntab, pos, size)
    return ((np.asarray(g0), np.asarray(gw0).T.copy(), sc1),
            (np.asarray(g1), np.asarray(gw1).T.copy(), scc))


def _form_b():
    """tests/test_pallas_point.py:18: one int8 table, (P, 128) features."""
    rs = np.random.RandomState(0)
    P, V, C, F = 700, 3, 35, 128
    hp = _heads(V, C, F)
    rows = rs.randint(-127, 127, size=(V * P, 4 * C)).astype(np.int8)
    w4 = np.abs(rs.rand(V, 4, P)).astype(np.float32)
    w4 *= rs.rand(V, 4, P) > 0.1
    scale = (0.02 + rs.rand(C) * 0.05).astype(np.float32)
    feats = (rs.randn(P, F) * 0.5).astype(np.float32)
    vmask = (rs.rand(V, P) > 0.15).astype(np.float32)
    sig_ok = rs.rand(P) > 0.2
    return hp, C, None, (((rows, w4, scale),), feats, vmask, sig_ok), {}


def _form_c():
    """tests/test_pallas_point.py:106: u8 source quad rows + a pre-lerped
    1-tap float feature tab, geometry tables lerped in the kernel."""
    rs = np.random.RandomState(1)
    P, V, C1, Cc, C = 700, 3, 32, 64, 35
    hp = _heads(V, C, C1 + Cc)
    geom = _geometry(rs, P, C1, Cc)
    rows_s = rs.randint(0, 255, size=(V * P, 4 * 3)).astype(np.uint8)
    w4_s = np.abs(rs.rand(V, 4, P)).astype(np.float32)
    w4_s *= rs.rand(V, 4, P) > 0.1
    s_scale = np.full((3,), 1.0 / 255.0, np.float32)
    feat_pv = (rs.randn(V, P, 32) * 0.3).astype(np.float32)
    vmask = (rs.rand(V, P) > 0.15).astype(np.float32)
    sig_ok = rs.rand(P) > 0.2
    tabs = ((rows_s, w4_s, s_scale),
            (feat_pv.reshape(V * P, 32), np.ones((V, 1, P), np.float32),
             np.ones((32,), np.float32)))
    return hp, C, C1, (tabs, None, vmask, sig_ok), {"geom_tabs": geom}


def _form_d():
    """tests/test_pallas_point.py:235: one int4 split-packed table of C =
    32 channels, V = 2 views, (P, 96) features."""
    rs = np.random.RandomState(7)
    P, V, C, F = 600, 2, 32, 96
    hp = _heads(V, C, F)
    img = (rs.randn(4, P, C) * 0.4).astype(np.float32)
    packed, scale = jgs.quantize_image_i4(jnp.asarray(img.transpose(1, 0, 2)))
    packed = np.asarray(packed)
    rows_pk = np.broadcast_to(
        packed.reshape(P, 4 * (C // 2)), (V, P, 4 * (C // 2))).reshape(V * P, -1).copy()
    w4 = np.abs(rs.rand(V, 4, P)).astype(np.float32)
    feats = (rs.randn(P, F) * 0.2).astype(np.float32)
    vmask = np.ones((V, P), np.float32)
    sig_ok = np.ones((P,), bool)
    return hp, C, None, (((rows_pk, w4, np.asarray(scale)),), feats, vmask, sig_ok), {}


def _form_e():
    """tests/test_pallas_point.py:299: occ_geom on a level-1 volume with
    large empty regions, one u8 table of 35 channels, V = 2."""
    rs = np.random.RandomState(11)
    P, V, C1, Cc, C = 640, 2, 32, 64, 35
    hp = _heads(V, C, C1 + Cc)
    geom = _geometry(rs, P, C1, Cc, empty=0.45)
    rows_s = rs.randint(0, 255, size=(V * P, 4 * C)).astype(np.uint8)
    w4_s = np.abs(rs.rand(V, 4, P)).astype(np.float32)
    s_scale = np.full((C,), 1.0 / 255.0, np.float32)
    vmask = np.ones((V, P), np.float32)
    sig_ok = rs.rand(P) > 0.2
    return hp, C, C1, (((rows_s, w4_s, s_scale),), None, vmask, sig_ok), {
        "geom_tabs": geom, "occ_geom": True}


FORMS = {"b": _form_b, "c": _form_c, "d": _form_d, "e": _form_e}


@pytest.fixture(scope="module", params=sorted(FORMS))
def form(request):
    hp, C, fold, args, kw = FORMS[request.param]()
    out_j = fused_point_stages_tabs(
        *_j(args), jax_pack(hp, C, fold_nch=fold), block=256, interpret=True,
        **{k: (_j(v) if k == "geom_tabs" else v) for k, v in kw.items()})
    tkw = {k: (_t(v) if k == "geom_tabs" else v) for k, v in kw.items()}
    return request.param, _t(args) + (_port_weights(hp, fold),), tkw, [np.asarray(o) for o in out_j]


def test_plain_matches_pallas_kernel_interpret(form):
    name, args, kw, out_j = form
    out = [t.numpy() for t in ps.point_stages_tabs_plain(*args, **kw)]
    assert len(out) == len(out_j) == (3 if name == "e" else 2)
    a, rgb = out[:2]
    a_j, rgb_j = out_j[:2]
    # same bf16-input / f32-accumulate numerics, sums in another order: a
    # float32 ulp can move a dot input across a bf16 rounding edge for a
    # point or two (the bound tests/test_torch_point_stages.py states for
    # the fast mode's form)
    d = np.abs(a - a_j)
    assert (d > 1e-4).sum() <= 2, np.sort(d)[-4:]
    assert d.max() < 0.08
    alive, alive_j = a > 1e-14, a_j > 1e-14
    assert (alive != alive_j).sum() <= 1
    agree = alive == alive_j
    dr = np.abs(rgb - rgb_j)[agree].max(axis=1)
    # (form (e): raw u8 rows of 35 channels reach variances of ~0.1 with
    # views that differ more, and 4 of 640 points move by up to 1.3e-3)
    assert (dr > 1e-4).sum() <= 4 and dr.max() < 0.08, np.sort(dr)[-8:]
    assert alive.mean() > 0.3 and (rgb[alive] > 0).all()
    if name == "e":
        # the occupancy verdict compares a sum of non-negative terms with 0
        np.testing.assert_array_equal(out[2], out_j[2])
        occm = out[2] > 0.5
        assert 0.05 < occm.mean() < 0.95
        assert (a[~occm] == 0).all() and (rgb[~occm] == 0).all()


# the forms above -> a key of the kernel's entry in the same form: (b) one
# int8 table and the (P, 128) feature, (c) split tables, (d) int4 feature
# rows beside the (P, 96) feature at 2 views, (e) occ_geom on one uint8
# table at 2 views
ENTRY_KEYS = {"b": ps.Key(("i8",), "feats128", False), "c": ps.Key(("u8", "i8"), "default", False),
              "d": ps.Key(("u8", "i4"), "feats96", False, 2),
              "e": ps.Key(("u8",), "default", True, 2)}


@pytest.mark.parametrize("name", sorted(FORMS))
def test_wrapper_runs_plain_on_cpu_without_launching(name):
    """The entry on CPU tensors (the seeded tables of tests/point_tables.py)
    runs its plain version and launches nothing."""
    args, kw = seeded_tables(ENTRY_KEYS[name], seed=3)
    before = sum(ps.LAUNCHES.values())
    out = ps.fused_point_stages_from_tables(*args, **kw)
    assert sum(ps.LAUNCHES.values()) == before
    want = ps.point_stages_from_tables_plain(*args, **kw)
    assert len(out) == len(want) == (3 if name == "e" else 2)
    for o, o_p in zip(out, want):
        np.testing.assert_array_equal(o.numpy(), o_p.numpy())


def test_occ_geom_keeps_survivors_bitwise():
    """With occ_geom the surviving points equal the occ_geom-off outputs
    (tests/test_pallas_point.py:380-387)."""
    hp, C, fold, args, kw = _form_e()
    args = _t(args) + (_port_weights(hp, fold),)
    geom = _t(kw["geom_tabs"])
    a0, rgb0 = ps.point_stages_tabs_plain(*args, geom_tabs=geom)
    a1, rgb1, occm = ps.point_stages_tabs_plain(*args, geom_tabs=geom, occ_geom=True)
    keep = occm > 0.5
    np.testing.assert_array_equal(a1[keep].numpy(), a0[keep].numpy())
    np.testing.assert_array_equal(rgb1[keep].numpy(), rgb0[keep].numpy())
    with pytest.raises(ValueError, match="occ_geom"):
        ps.point_stages_tabs_plain(*args[:1], torch.zeros(640, 96), *args[2:], occ_geom=True)


def _render_shape_inputs(P, *, int4=False, feats=False):
    """Inputs at the widths the CUDA kernel is written for."""
    rs = np.random.RandomState(5)
    V, CS, CF, C0, C1 = ps.V, ps.CS, ps.CF, ps.C0, ps.C1
    wf = 2 * CF if int4 else 4 * CF
    tabs = (
        (rs.randint(0, 256, size=(V * P, 4 * CS)).astype(np.uint8),
         rs.rand(V, 4, P).astype(np.float32), np.full((CS,), 1 / 255.0, np.float32)),
        (rs.randint(0, 256, size=(V * P, wf)).astype(np.uint8 if int4 else np.int8),
         rs.rand(V, 4, P).astype(np.float32), (0.02 + rs.rand(CF) * 0.05).astype(np.float32)),
    )
    geom = (
        (rs.randint(0, 256, size=(P, 8 * C0)).astype(np.uint8),
         rs.rand(8, P).astype(np.float32), (0.01 + rs.rand(C0) * 0.03).astype(np.float32)),
        (rs.randint(-127, 128, size=(P, C1)).astype(np.int8),
         np.ones((1, P), np.float32), (0.01 + rs.rand(C1) * 0.03).astype(np.float32)),
    )
    f = rs.randn(P, C0 + C1).astype(np.float32) if feats else None
    vmask = np.ones((V, P), np.float32)
    sig_ok = (rs.rand(P) > 0.2).astype(np.uint8)
    hp = _heads(V, CS + CF, C0 + C1)
    return _t(tabs), _t(f), _t(vmask), _t(sig_ok), _port_weights(hp, C0), () if feats else _t(geom)


def test_int4_render_layout_matches_dequantized_int8():
    """Form (d) at the render's widths: byte j of a tap holds channel j
    (low nibble) and j + 16 (high); the packed rows give bitwise what the
    same codes give as int8 rows."""
    P = 300
    rs = np.random.RandomState(9)
    img = torch.from_numpy((rs.randn(3, 12, 13, ps.CF) * 0.4).astype(np.float32))
    q4, sc = pgs.quantize_image_i4(img)
    codes = torch.cat([((q4.int() & 0xF) ^ 8) - 8, ((q4.int() >> 4) ^ 8) - 8], dim=-1).to(torch.int8)
    assert int(codes.min()) == -7 and int(codes.max()) == 7
    idx = torch.from_numpy(rs.randint(0, 13 * 14, size=(3, P)))
    gather = lambda tab: torch.cat([tab[v].reshape(13 * 14, -1)[idx[v]] for v in range(3)])
    rows4 = gather(pgs.build_quad_table_2d(q4))
    rows8 = gather(pgs.build_quad_table_2d(codes))
    assert rows4.shape == (3 * P, 2 * ps.CF) and rows8.shape == (3 * P, 4 * ps.CF)
    tabs, _, vmask, sig_ok, weights, geom = _render_shape_inputs(P)
    out8 = ps.point_stages_tabs_plain(
        (tabs[0], (rows8, tabs[1][1], sc)), None, vmask, sig_ok, weights, geom_tabs=geom)
    out4 = ps.point_stages_tabs_plain(
        (tabs[0], (rows4, tabs[1][1], sc)), None, vmask, sig_ok, weights, geom_tabs=geom)
    for o8, o4 in zip(out8, out4):
        np.testing.assert_array_equal(o8.numpy(), o4.numpy())


def test_launch_refuses_forms_and_widths_without_instantiation():
    """The CUDA launch path reads the key from the tables and checks it and
    the widths before it touches the device, so its refusals show on CPU
    tensors too. Keys beyond FORMS (bf16 feature rows with occ_geom, a
    merged bf16 table with a feature input) are valid keys: their libraries
    are built at first use. Refused: occ_geom without geometry tables, more
    views than a dataset chooses, widths the kernel is not written for."""
    before = sum(ps.LAUNCHES.values())
    args, kw = seeded_tables(ps.Key(("u8", "i8"), "default", False), P=64)
    quads, pts, KE, src_hw, sig_ok, weights = args
    geom = kw["geom"]
    feats = seeded_tables(ps.Key(("u8", "i8"), "feats96", False), P=64)[1]["feats"]

    def launch(quads=quads, KE=KE, geom=geom, feats=None):
        return ps._launch_from_tables(quads, pts, KE, src_hw, sig_ok.to(torch.uint8), weights,
                                      geom, kw["dhw_c"], kw["out_sh"], feats, False, False)

    assert ps.check_key((("u8", "bf16"), ps.GEOMS["default"], True, 3)) == (
        ("u8", "bf16"), "default", True, 3)
    assert ps.form_name(ps.check_key((("bf16",), "feats96", False))) == "a:bf16@feats96"
    with pytest.raises(NotImplementedError, match="occ_geom needs geometry tables"):
        ps.check_key((("i8",), "feats96", True))
    with pytest.raises(NotImplementedError, match="9 views"):
        launch(tuple((t.repeat(3, 1, 1, 1), sc) for t, sc in quads), KE.repeat(3, 1, 1))
    with pytest.raises(NotImplementedError, match="geometry tables"):
        launch(geom=geom[:1] * 5)
    g0, sc0 = geom[0]
    assert isinstance(g0, pgs.FlatOctetTable)
    with pytest.raises(NotImplementedError, match="geometry tables"):
        launch(geom=((pgs.FlatOctetTable(g0.rows[:, :8 * 16].contiguous(), g0.shape),
                      sc0[:16].contiguous()),))
    with pytest.raises(NotImplementedError, match="1 or 2 projection tables"):
        launch(quads + quads[:1])
    with pytest.raises(NotImplementedError, match="feature table"):
        launch((quads[0], (quads[1][0][..., :64].contiguous(), quads[1][1])))
    with pytest.raises(NotImplementedError, match="source rgb table"):
        launch(KE=KE[:2].contiguous())
    with pytest.raises(ValueError, match="excludes"):
        launch(feats=feats)
    assert sum(ps.LAUNCHES.values()) == before


@pytest.mark.parametrize("key", sorted(ps.FORMS, key=str))
def test_build_command_per_form(key):
    cmd, lib = ps.build_command(key)
    rows, layout, occ, views = key
    assert f"-DPS_ROW_A={ps.ROW_CODES[rows[0]]}" in cmd
    assert f"-DPS_ROW_B={ps.ROW_CODES[rows[1]] if len(rows) == 2 else 0}" in cmd
    assert f"-DPS_OCC={int(occ)}" in cmd and f"-DPS_V={views}" in cmd and views == ps.V
    # each geometry table as row type * 10000 + taps * 1000 + channels
    tables = ps.GEOMS[layout]
    for i in range(4):
        code = (ps.ROW_CODES[tables[i][2]] * 10000 + tables[i][0] * 1000 + tables[i][1]
                if i < len(tables) else 0)
        assert f"-DPS_G{i}={code}" in cmd
    assert "arch=compute_90a,code=sm_90a" in cmd and cmd[-1] == ps.SOURCE
    others = {ps.build_command(k)[1] for k in ps.FORMS if k != key}
    assert lib not in others and lib.startswith(ps.BUILD_DIR)
    # the same key at another view count is another library
    assert ps.build_command(key._replace(views=4))[1] != lib


def test_quantize_image_i4_matches_jax():
    rs = np.random.RandomState(3)
    img = (rs.randn(3, 17, 19, 32) * 2).astype(np.float32)
    img[0, 0, 0, :4] = [0.0, 1e-12, -1e-12, 0.5]
    q_p, s_p = pgs.quantize_image_i4(torch.from_numpy(img))
    q_j, s_j = jgs.quantize_image_i4(jnp.asarray(img))
    assert q_p.dtype == torch.uint8 and tuple(q_p.shape) == (3, 17, 19, 16)
    np.testing.assert_array_equal(q_p.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(
        pgs.build_quad_table_2d(q_p).numpy(), np.asarray(jgs.build_quad_table_2d(q_j)))
    with pytest.raises(ValueError, match="even"):
        pgs.quantize_image_i4(torch.zeros(2, 2, 3))


@pytest.mark.parametrize("dtype,Ht,C", [(np.uint8, 40, 3), (np.int8, 10, 32)])
def test_project_gather_rows_matches_jax(dtype, Ht, C):
    """Rows bitwise and weights within 4e-5 of JAX, on a u8 full-resolution
    table and an int8 quarter-resolution one; batched and flat gathers give
    equal rows."""
    rs = np.random.RandomState(4)
    V, P, h, w = 3, 500, 40, 40
    info = np.iinfo(dtype)
    img = rs.randint(info.min, info.max + 1, size=(V, Ht, Ht, C)).astype(dtype)
    K = np.array([[30.0, 0, 20, 0], [0, 30.0, 20, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    KE = np.stack([K @ np.array(
        [[np.cos(t), 0, np.sin(t), 0.1 * i], [0, 1, 0, 0.05], [-np.sin(t), 0, np.cos(t), 3.0],
         [0, 0, 0, 1]], np.float32) for i, t in enumerate((0.0, 0.4, -0.5))]).astype(np.float32)
    xyz = (rs.rand(P, 3) * 3.0 - 1.5).astype(np.float32)  # some outside every view
    tab_p = pgs.build_quad_table_2d(torch.from_numpy(img))
    tab_j = jgs.build_quad_table_2d(jnp.asarray(img))
    np.testing.assert_array_equal(tab_p.numpy(), np.asarray(tab_j))
    outs = {}
    for batched in (False, True):
        rows, w4, vm = pproj.project_gather_rows_merged(
            torch.from_numpy(xyz), torch.from_numpy(KE), tab_p, h, w, batched=batched)
        rows_j, w4_j, vm_j = jproj.project_gather_rows_merged(
            jnp.asarray(xyz), jnp.asarray(KE), tab_j, h, w, batched=batched)
        assert rows.dtype == tab_p.dtype and tuple(rows.shape) == (V * P, 4 * C)
        np.testing.assert_array_equal(rows.numpy(), np.asarray(rows_j))
        # the weights are fractions of pixel coordinates up to 40, whose
        # float32 ulp is 3.8e-6, products of two such fractions; the two
        # projection matmuls round apart by a few ulp (1.3e-5 measured)
        np.testing.assert_allclose(w4.numpy(), np.asarray(w4_j), rtol=0, atol=4e-5)
        np.testing.assert_array_equal(vm.numpy(), np.asarray(vm_j))
        outs[batched] = (rows, w4, vm)
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert 0.2 < float(outs[False][2].mean()) < 0.98
