"""The point-stage kernel's entry (ops/point_stages.py
`fused_point_stages_from_tables`) on the CPU: on the seeded tables of
tests/point_tables.py, its plain version against `point_stages_tabs_plain`
fed by the gathers the renderer ran before the kernel fetched its own rows
(`project_gather_rows_merged` and the geometry-row gathers, written out
here apart from `gather_from_tables`), bit for bit, for form (a) (one
merged int8 quad table) and form (c) (split uint8 / int8 tables) at 3 and 2
views, in both ray conventions, with and without the in-kernel occupancy
cull, and for a form (b) key (the (P, F) feature input); the seeded points
reach every edge case tests/point_tables.py names. The generator's tables
of every key of FORMS and of the cover set are read by the launch path as
that key."""

import pytest
import torch

from gpnerf_tpu_torch.ops import point_stages as ps
from gpnerf_tpu_torch.ops.grid_sample import (
    FlatOctetTable,
    Int4Table,
    NearestTable,
    build_octet_table_3d,
    build_octet_table_3d_u32,
    nearest_row_and_weight,
    octet_rows_and_weights,
)
from gpnerf_tpu_torch.ops.projection import project_gather_rows_merged
from gpnerf_tpu_torch.utils.roofline import counting
from point_tables import cover_keys, seeded_tables

# the forms these tests name -> (projection row types, geometry layout)
FORMS = {"a": (("i8",), "default"), "c": (("u8", "i8"), "default"), "b": (("i8",), "feats96")}


def form_key(form, V=3, occ=False):
    """The Key of form "a", "c" or "b" at V views."""
    rows, layout = FORMS[form]
    return ps.Key(rows, layout, occ, V)


def gathered_inputs(quads, pts_c, KE, src_hw, sig_ok, weights, *, geom=(), dhw_c=None,
                    out_sh=None, feats=None, neg_ray=False, occ_geom=False):
    """The arguments of `point_stages_tabs_plain` as the renderer gathered
    them before the kernel fetched its rows (render/demo.py's `geom_tab`
    and projection gathers)."""
    Hs, Ws = src_hw
    rows, w4, vmask = project_gather_rows_merged(pts_c, KE, quads[0][0], Hs, Ws, neg_ray=neg_ray)
    tabs = [(rows, w4, quads[0][1])]
    if len(quads) == 2:
        rows_f, w4_f, _ = project_gather_rows_merged(pts_c, KE, quads[1][0], Hs, Ws,
                                                     neg_ray=neg_ray, batched=True)
        tabs.append((rows_f, w4_f, quads[1][1]))
    out_sh = torch.tensor(out_sh, device=pts_c.device)
    frac = dhw_c / out_sh.float()
    geom_tabs = []
    for i, (tab, sc) in enumerate(geom):
        if isinstance(tab, NearestTable):
            size = out_sh // tab.div
            if tab.interleave > 1:
                size = tab.interleave * (size - 1) + 1
            r, w = nearest_row_and_weight(tab, frac * (size - 1).float(), size)
        else:
            size = out_sh // (2 ** (i + 1))
            r, w = octet_rows_and_weights(tab, frac * (size - 1).float(), size)
        sc = torch.ones(r.shape[-1] // w.shape[-1], device=r.device) if sc is None else sc
        geom_tabs.append((r, w.T.contiguous(), sc))
    return (tuple(tabs), feats, vmask, sig_ok, weights), dict(geom_tabs=tuple(geom_tabs),
                                                              occ_geom=occ_geom)


def _assert_same(out, want):
    assert len(out) == len(want)
    for o, w in zip(out, want):
        assert o.dtype == w.dtype and torch.equal(o, w)


@pytest.mark.parametrize("neg_ray", [False, True], ids=["pos-ray", "neg-ray"])
@pytest.mark.parametrize("V", [3, 2])
@pytest.mark.parametrize("form", ["a", "c"])
def test_tables_entry_plain_equals_plain_on_the_written_out_gathers(form, V, neg_ray):
    args, kw = seeded_tables(form_key(form, V), seed=V + 10 * neg_ray, neg_ray=neg_ray)
    out = ps.fused_point_stages_from_tables(*args, **kw)
    g_args, g_kw = gathered_inputs(*args, **kw)
    _assert_same(out, ps.point_stages_tabs_plain(*g_args, **g_kw))
    _assert_same(out, ps.point_stages_from_tables_plain(*args, **kw))
    # the seeded points reach the edge cases tests/point_tables.py names
    vmask = g_args[2]
    assert 0 < float(vmask.mean()) < 1 and not bool(vmask[:, 7].any())  # off every image
    assert float(vmask[0, 2]) == 1.0 and float(vmask[0, 3]) == 0.0      # last column, past it
    assert float(vmask[0, 5]) == 0.0                                     # behind view 0
    wg = g_kw["geom_tabs"][0][1]
    assert bool((wg == 0).all(0).any()) and bool((wg.max(0).values == 1).any())
    a, rgb = out
    assert bool(torch.isfinite(a).all()) and 0 < int((a > 1e-14).sum()) < a.numel()


@pytest.mark.parametrize("form", ["a", "c"])
def test_tables_entry_plain_with_the_occupancy_cull(form):
    args, kw = seeded_tables(form_key(form, occ=True), seed=5)
    out = ps.fused_point_stages_from_tables(*args, **kw)
    assert len(out) == 3 and 0.2 < float(out[2].mean()) < 0.95
    g_args, g_kw = gathered_inputs(*args, **kw)
    _assert_same(out, ps.point_stages_tabs_plain(*g_args, **g_kw))


@pytest.mark.parametrize("V", [3, 2])
def test_tables_entry_plain_with_the_feature_input(V):
    """A form (b) key: the renderer queries an int4 table outside the kernel
    and hands the (P, F) feature; only the projection rows are fetched."""
    args, kw = seeded_tables(form_key("b", V), seed=7)
    out = ps.fused_point_stages_from_tables(*args, **kw)
    g_args, g_kw = gathered_inputs(*args, **kw)
    assert g_args[1] is kw["feats"] and g_kw["geom_tabs"] == ()
    _assert_same(out, ps.point_stages_tabs_plain(*g_args, **g_kw))


@pytest.mark.parametrize("key", [*ps.FORMS, *cover_keys()], ids=ps.form_name)
def test_seeded_tables_are_read_as_their_key(key, monkeypatch):
    """The generator's tables of a key are what the launch path reads as
    that key (on CPU tensors, up to the launch), with head weights of its
    feature width and view count; the plain version runs on them."""
    key = ps.check_key(key)
    args, kw = seeded_tables(key, P=48, seed=1)
    seen = []
    monkeypatch.setattr(ps, "_run", lambda k, *a, **_: seen.append(k))
    ps._launch_from_tables(*args[:4], args[4].to(torch.uint8), args[5], kw.get("geom", ()),
                           kw.get("dhw_c"), kw.get("out_sh"), kw.get("feats"), kw["neg_ray"],
                           kw["occ_geom"])
    assert seen == [key]
    layers = args[5].layers
    assert layers[0][0].shape[1] == sum(c for _, c, _ in ps.geom_specs(key.geom))
    assert layers[9][0].shape[1] == 32 * key.views
    out = ps.fused_point_stages_from_tables(*args, **kw)
    assert len(out) == 2 + key.occ and all(bool(torch.isfinite(o).all()) for o in out)


def test_fetchable_tables():
    """The kernel fetches rows of flat and dense octet tables and of plain
    nearest tables; int4, word-packed and linear-axis tables are queried
    outside it."""
    q = torch.randint(0, 256, (3, 4, 5, 32), dtype=torch.uint8)
    dense = build_octet_table_3d(q)
    assert ps.fetchable(dense) and ps.table_channels(dense) == 32
    assert ps.fetchable(FlatOctetTable(dense.reshape(-1, 256), (4, 5, 6)))
    assert ps.fetchable(build_octet_table_3d(q.float()))
    near = NearestTable(q.reshape(-1, 32), (3, 4, 5), 2)
    assert ps.fetchable(near) and ps.table_channels(near) == 32
    assert not ps.fetchable(near._replace(lerp_axes=1))
    assert not ps.fetchable(Int4Table(dense[..., :128]))
    assert not ps.fetchable(build_octet_table_3d_u32(q))


def test_tables_entry_counts_its_declared_cost():
    """A count (utils/roofline.py) takes the call at `cost_from_tables`:
    the fetched rows, the points, cameras, scales, sig_ok and weights read
    once, the outputs written once; the twelve layers' multiply-adds x 2
    (the four per-view layers once per view) and the lerps."""
    args, kw = seeded_tables(form_key("c"), P=203)
    with torch.no_grad(), counting("cpu") as c:
        ps.fused_point_stages_from_tables(*args, **kw)
    nb, fl = ps.cost_from_tables(*args, **kw)
    assert dict(c.kernels) == {"point_stages": 1} and c.bytes == nb and c.flops == fl
    P, V = 203, 3
    layers = args[5].layers
    macs = (sum(w.numel() for w, _ in layers)
            + (V - 1) * sum(w.numel() for w, _ in layers[5:9]))
    lerps = V * (3 + 32) * (2 * 4 + 4) + (8 * 32 * 2 + 32) + (64 * 2 + 64)
    assert fl == P * (2 * macs + lerps)
    rows = V * (12 + 128) + 256 + 64  # quad rows of both tables, the octet and nearest rows
    fixed = 3 * 16 * 4 + (3 + 32 + 32 + 64) * 4 + args[5].flat.numel()
    assert nb == P * (rows + 24 + 1 + 16) + fixed
