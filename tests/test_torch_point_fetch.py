"""The point-stage kernel's tables entry (ops/point_stages.py
`fused_point_stages_from_tables`) on the CPU: its plain version on seeded
tables against the rows entry `fused_point_stages_tabs` fed by the gathers
the renderer ran before the kernel fetched its own rows
(`project_gather_rows_merged` and the geometry-row gathers, written out
here), bit for bit, for form (a) (one merged int8 quad table) and form (c)
(split uint8 / int8 tables) at 3 and 2 views, in both ray conventions, with
and without the in-kernel occupancy cull, and for a form (b) key (int4
geometry: the (P, F) feature input). The seeded points include points off
every source image, behind a camera, exactly on a pixel and on an image's
last pixel, exactly on voxel corners and half-way between them, on the
extent's last corner and outside `out_sh`. `seeded_inputs` also feeds the
card's test of the kernel (tests/test_torch_gpu.py)."""

import numpy as np
import pytest
import torch

from gpnerf_tpu_torch.models.heads import NeRFHead
from gpnerf_tpu_torch.ops import point_stages as ps
from gpnerf_tpu_torch.ops.grid_sample import (
    FlatOctetTable,
    Int4Table,
    NearestTable,
    build_octet_table_3d,
    build_octet_table_3d_u32,
    build_quad_table_2d,
    nearest_row_and_weight,
    octet_rows_and_weights,
)
from gpnerf_tpu_torch.ops.projection import project_gather_rows_merged
from gpnerf_tpu_torch.utils.roofline import counting

HS, WS = 48, 64       # source images: the pixel frame of the cameras
HF, WF = 12, 16       # the feature grid
F_CAM, DEPTH = 32.0, 3.0
OUT_SH = (32, 64, 32)  # level-0 extent: level 1 (16, 32, 16), coarse nearest on it
GRID1 = (18, 34, 17)   # the level-1 grid the tables are built on (>= the extent)


def _cameras(V, neg_ray):
    """(V, 4, 4) K [R | t]: view v turned by 0.4 v about the y axis, the
    volume 3 units in front; view 0 is axis-aligned, so whole-number points
    project exactly. Under neg_ray the depth row and both pixel rows are
    negated: the same pixels, in front where the depth is < 0."""
    K = np.array([[F_CAM, 0, WS / 2, 0], [0, F_CAM, HS / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                 np.float32)
    kes = []
    for v in range(V):
        a = 0.4 * v
        E = np.eye(4, dtype=np.float32)
        E[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        E[2, 3] = DEPTH
        ke = (K @ E).astype(np.float32)
        if neg_ray:
            ke[:3] *= -1
        kes.append(ke)
    return np.stack(kes)


def _points(rs, P):
    """(pts (P, 3), dhw (P, 3)) float32: the special points first (as many
    as P holds), then random ones in and around the volume."""
    n = P
    P = max(P, 32)
    pts = rs.uniform(-1.2, 1.2, size=(P, 3)).astype(np.float32)
    special = [
        (0.0, 0.0, 0.0),            # view 0's principal point: exactly on a pixel
        (0.875, 0.0, 1.0),          # view 0: x = 32 * 0.875 / 4 + 32 = 39 exactly
        (3.875, 0.0, 1.0),          # view 0: x = 63, the image's last column
        (4.0, 0.0, 1.0),            # just past it
        (0.0, -3.0, 1.0),           # view 0: y = -24 + 24 = 0, the first row
        (0.0, 0.0, -4.0),           # view 0: depth -1, behind the camera
        (0.3, 0.2, -3.5),           # behind view 0, in front of none or some others
        (9.0, 9.0, 0.0),            # off every image
        (-9.0, 0.0, 0.5),
        (0.5, 0.5, -3.0),           # on view 0's camera plane: depth 0
    ]
    pts[:len(special)] = special
    o = np.array(OUT_SH, np.float32)
    dhw = (rs.uniform(-0.1, 1.1, size=(P, 3)) * o).astype(np.float32)
    s = 1.0 / 15.0
    edges = [
        (0.0, 0.0, 0.0), o, o - 1, o / 2, o * np.float32(0.25),  # corners, mid-cells
        (16.0, 32.0, 16.0),      # pos exactly (7.5, 15.5, 7.5): nearest rounds half to even
        (-0.5, -0.5, -0.5), (-3.0, 5.0, 70.0), o + 3,            # outside out_sh
        (32 * s, 64 * s, 32 * s),
    ]
    dhw[len(special):len(special) + len(edges)] = edges
    return pts[:n].copy(), dhw[:n].copy()


def _head_weights(V, seed):
    torch.manual_seed(seed)
    head = NeRFHead(in_feat_ch=ps.CF, n_smpl=8, code_dim=8, n_views=V)
    return ps.pack_head_weights(head, fold_nch=ps.C0)


def seeded_inputs(form, V, neg_ray, P=640, seed=0, device="cpu", occ_geom=False):
    """Seeded arguments of `fused_point_stages_from_tables` for `form` "a"
    (a merged int8 quad table on the feature grid), "c" (uint8 source
    pixels at full resolution and an int8 feature table) or "b" (form (a)'s
    table with an int4 level-1 table: no table the kernel fetches from, so
    the (P, 96) feature); geometry: the u8 level-1 flat octet table and the
    int8 coarse nearest table on the level-1 grid. Returns (args, kwargs)."""
    rs = np.random.RandomState(seed)
    pts, dhw = _points(rs, P)
    ke = _cameras(V, neg_ray)
    g = torch.Generator().manual_seed(seed)
    if form in ("a", "b"):
        q = torch.randint(-127, 128, (V, HF, WF, ps.C), generator=g, dtype=torch.int8)
        quads = ((build_quad_table_2d(q), 0.02 + torch.rand(ps.C, generator=g) * 0.05),)
    else:
        src = torch.randint(0, 256, (V, HS, WS, ps.CS), generator=g, dtype=torch.uint8)
        feat = torch.randint(-127, 128, (V, HF, WF, ps.CF), generator=g, dtype=torch.int8)
        quads = ((build_quad_table_2d(src), torch.full((ps.CS,), 1 / 255.0)),
                 (build_quad_table_2d(feat), 0.02 + torch.rand(ps.CF, generator=g) * 0.05))
    D, H, W = GRID1
    n_rows = (D + 1) * (H + 1) * (W + 1)
    l1 = torch.randint(0, 256, (n_rows + 1, 8 * ps.C0), generator=g, dtype=torch.uint8)
    if occ_geom:  # empty cells, so the occupancy cull bites
        l1[torch.rand(n_rows + 1, generator=g) > 0.6] = 0
    coarse = torch.randint(-127, 128, (D * H * W, ps.C1), generator=g, dtype=torch.int8)
    geom = ((FlatOctetTable(l1, (D + 1, H + 1, W + 1)),
             0.01 + torch.rand(ps.C0, generator=g) * 0.03),
            (NearestTable(coarse, GRID1, 2), 0.01 + torch.rand(ps.C1, generator=g) * 0.03))
    kw = dict(dhw_c=torch.from_numpy(dhw), out_sh=OUT_SH, neg_ray=neg_ray, occ_geom=occ_geom)
    if form == "b":
        kw["feats"] = torch.randn(P, 96, generator=g) * 0.5
    else:
        kw["geom"] = geom
    sig_ok = torch.rand(P, generator=g) > 0.2
    args = (quads, torch.from_numpy(pts), torch.from_numpy(ke), (HS, WS), sig_ok,
            _head_weights(V, seed))

    def to(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        if isinstance(x, (FlatOctetTable, NearestTable)):
            return type(x)(to(x[0]), *x[1:])
        if isinstance(x, tuple) and not isinstance(x, ps.PointWeights):
            return tuple(to(y) for y in x)
        if isinstance(x, ps.PointWeights):
            return ps.PointWeights([(w.to(device), b.to(device)) for w, b in x.layers],
                                   x.flat.to(device))
        return x

    return to(args), {k: to(v) for k, v in kw.items()}


def gathered_inputs(quads, pts_c, KE, src_hw, sig_ok, weights, *, geom=(), dhw_c=None,
                    out_sh=None, feats=None, neg_ray=False, occ_geom=False):
    """The rows entry's arguments as the renderer gathered them before the
    kernel fetched its rows (render/demo.py's `geom_tab` and projection
    gathers)."""
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
def test_tables_entry_plain_equals_the_gathered_rows_entry(form, V, neg_ray):
    args, kw = seeded_inputs(form, V, neg_ray, seed=V + 10 * neg_ray)
    out = ps.fused_point_stages_from_tables(*args, **kw)
    g_args, g_kw = gathered_inputs(*args, **kw)
    _assert_same(out, ps.fused_point_stages_tabs(*g_args, **g_kw))
    _assert_same(out, ps.point_stages_from_tables_plain(*args, **kw))
    # the seeded points reach the edge cases the docstring names
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
    args, kw = seeded_inputs(form, 3, False, seed=5, occ_geom=True)
    out = ps.fused_point_stages_from_tables(*args, **kw)
    assert len(out) == 3 and 0.2 < float(out[2].mean()) < 0.95
    g_args, g_kw = gathered_inputs(*args, **kw)
    _assert_same(out, ps.fused_point_stages_tabs(*g_args, **g_kw))


@pytest.mark.parametrize("V", [3, 2])
def test_tables_entry_plain_with_the_feature_input(V):
    """A form (b) key: the renderer queries an int4 table outside the kernel
    and hands the (P, F) feature; only the projection rows are fetched."""
    args, kw = seeded_inputs("b", V, False, seed=7)
    out = ps.fused_point_stages_from_tables(*args, **kw)
    g_args, g_kw = gathered_inputs(*args, **kw)
    assert g_args[1] is kw["feats"] and g_kw["geom_tabs"] == ()
    _assert_same(out, ps.fused_point_stages_tabs(*g_args, **g_kw))


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
    once, the outputs written once; the rows entry's FLOPs."""
    args, kw = seeded_inputs("c", 3, False, P=203)
    with torch.no_grad(), counting("cpu") as c:
        ps.fused_point_stages_from_tables(*args, **kw)
    nb, fl = ps.cost_from_tables(*args, **kw)
    assert dict(c.kernels) == {"point_stages": 1} and c.bytes == nb and c.flops == fl
    g_args, g_kw = gathered_inputs(*args, **kw)
    assert fl == sum(ps.op_counts(g_args[0], g_args[2], g_args[4], g_kw["geom_tabs"]))
    P, V = 203, 3
    rows = V * (12 + 128) + 256 + 64  # quad rows of both tables, the octet and nearest rows
    fixed = 3 * 16 * 4 + (3 + 32 + 32 + 64) * 4 + args[5].flat.numel()
    assert nb == P * (rows + 24 + 1 + 16) + fixed
