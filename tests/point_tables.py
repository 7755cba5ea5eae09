"""Seeded inputs of the point-stage kernel's entry,
gpnerf_tpu_torch/ops/point_stages.py `fused_point_stages_from_tables`, for
any key (`seeded_tables`), and the keys they are made for: the cover set
(`cover_keys`) and every key the renderer's switches reach
(`reachable_kernel_keys`). The CPU tests, the card's tests
(tests/test_torch_gpu.py) and chip_smoke.py import them.

The tables are made with the renderer's own builders (ops/grid_sample.py):
each projection quad table with `build_quad_table_2d` (int4 feature rows
through `quantize_image_i4`), octet geometry tables with
`build_octet_table_3d`, flat (`FlatOctetTable`, with the dump row) or
dense, and nearest tables as `NearestTable`s, midpoint-doubled
(`interleave_midpoints_3d`) or not. The points include points off every
source image, behind a camera, exactly on a pixel and on an image's last
pixel, exactly on voxel corners and half-way between them, on the extent's
last corner and outside `out_sh`."""

import itertools

import numpy as np
import torch

from gpnerf_tpu_torch.models.heads import NeRFHead
from gpnerf_tpu_torch.ops import point_stages as ps
from gpnerf_tpu_torch.ops.grid_sample import (
    FlatOctetTable,
    NearestTable,
    build_octet_table_3d,
    build_quad_table_2d,
    interleave_midpoints_3d,
    quantize_image_i4,
)

HS, WS = 48, 64       # source images: the pixel frame of the cameras
HF, WF = 12, 16       # the feature grid
F_CAM, DEPTH = 32.0, 3.0
OUT_SH = (32, 64, 32)  # level-0 extent: level 1 (16, 32, 16), level 2 (8, 16, 8), ...
MARGIN = (2, 2, 1)     # each geometry table's grid exceeds its valid extent by this


def cameras(V, neg_ray):
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


def points(rs, P):
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
        (16.0, 32.0, 16.0),      # level 1: pos exactly (7.5, 15.5, 7.5), rounded half to even
        (-0.5, -0.5, -0.5), (-3.0, 5.0, 70.0), o + 3,            # outside out_sh
        (32 * s, 64 * s, 32 * s),
    ]
    dhw[len(special):len(special) + len(edges)] = edges
    return pts[:n].copy(), dhw[:n].copy()


def head_weights(V, F, seed):
    """Seeded PointWeights of V views for a geometry feature of F channels:
    the folded sigma-feat weight [W[:, :32] | I_64] at F = 96, the head's
    own 128-input weight otherwise."""
    torch.manual_seed(seed)
    head = NeRFHead(in_feat_ch=ps.CF, n_smpl=8, code_dim=8, n_views=V)
    return ps.pack_head_weights(head, fold_nch=ps.C0 if F == ps.C0 + ps.C1 else None)


def _values(g, kind, shape):
    """Seeded values of one row type: int8 and uint8 codes, float rows
    (bf16 or float32)."""
    if kind == "i8":
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
    if kind == "u8":
        return torch.randint(0, 256, shape, generator=g, dtype=torch.uint8)
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[kind]
    return (torch.rand(shape, generator=g) * 0.5).to(dt)


def _quad_table(g, kind, V, H, W, Ct):
    """(quad table (V, H+1, W+1, 4Ct) or int4 (V, H+1, W+1, 2Ct), scale
    (Ct,)) of one projection table of `kind` rows: int8 codes with a
    dequant scale, raw uint8 pixels (1/255), int4 split-packed codes of a
    feature image, or float values with a unit scale."""
    if kind == "i4":
        q, sc = quantize_image_i4(torch.randn(V, H, W, Ct, generator=g) * 0.4)
    elif kind in ("bf16", "f32"):
        q = (torch.randn(V, H, W, Ct, generator=g) * 0.5).to(
            torch.bfloat16 if kind == "bf16" else torch.float32)
        sc = torch.ones(Ct)
    else:
        q = _values(g, kind, (V, H, W, Ct))
        sc = (torch.full((Ct,), 1 / 255.0) if kind == "u8"
              else 0.02 + torch.rand(Ct, generator=g) * 0.05)
    return build_quad_table_2d(q), sc


def _geometry_table(g, i, spec, occ, seed):
    """(table, scale or None) of geometry table i of `spec` (taps,
    channels, row type). Octet tables are built on level i + 1's grid,
    flat where seed + i is even, else dense; nearest tables on level 1's
    grid (div 2), table 0 of uint8 rows midpoint-doubled where the seed is
    odd. Integer rows carry a dequant scale, float rows a unit one (None).
    `occ`: a share of the cells' rows zeroed, so the occupancy cull bites."""
    taps, ch, kind = spec
    scale = 0.01 + torch.rand(ch, generator=g) * 0.03 if kind in ("u8", "i8") else None
    if taps == 8:
        grid = tuple(o // 2 ** (i + 1) + m for o, m in zip(OUT_SH, MARGIN))
        table = build_octet_table_3d(_values(g, kind, grid + (ch,)))
        if occ:
            table[torch.rand(table.shape[:3], generator=g) > 0.6] = 0
        if (seed + i) % 2 == 0:
            rows = table.reshape(-1, table.shape[-1])
            table = FlatOctetTable(torch.cat([rows, torch.zeros_like(rows[:1])]),
                                   tuple(table.shape[:3]))
        return table, scale
    assert taps == 1, f"the kernel fetches octet and nearest rows, not {taps}-tap ones"
    grid = tuple(o // 2 + m for o, m in zip(OUT_SH, MARGIN))
    vol = _values(g, kind, grid + (ch,))
    interleave = 2 if i == 0 and kind == "u8" and seed % 2 else 1
    if interleave > 1:
        vol = interleave_midpoints_3d(vol)
    rows = vol.reshape(-1, ch)
    if occ:
        rows[torch.rand(rows.shape[0], generator=g) > 0.6] = 0
    return NearestTable(rows, tuple(vol.shape[:3]), 2, interleave), scale


def seeded_tables(key, P=640, seed=0, device="cpu", neg_ray=False):
    """Seeded arguments of `fused_point_stages_from_tables` for `key` (a
    ps.Key, or a tuple of its fields) at P points: (args, kwargs). One
    projection table is the merged [rgb|feat] table on the feature grid;
    two are the source table at the source images' resolution and the
    feature table on the feature grid. The geometry tables of the key's
    specs (`_geometry_table`), or its (P, F) feature input (float32 or
    bf16). The head weights are seeded (`head_weights`)."""
    rows, layout, occ, V = ps.make_key(*key)
    rs = np.random.RandomState(seed)
    pts, dhw = points(rs, P)
    g = torch.Generator().manual_seed(seed)
    if len(rows) == 1:
        quads = (_quad_table(g, rows[0], V, HF, WF, ps.C),)
    else:
        quads = (_quad_table(g, rows[0], V, HS, WS, ps.CS),
                 _quad_table(g, rows[1], V, HF, WF, ps.CF))
    specs = ps.geom_specs(layout)
    F = sum(c for _, c, _ in specs)
    # as the renderer calls it: the dhw points and the extent beside a
    # feature input too
    kw = dict(dhw_c=torch.from_numpy(dhw), out_sh=OUT_SH, neg_ray=neg_ray, occ_geom=occ)
    if specs[0][2] in ps.FEAT_ROWS.values():
        kw["feats"] = (torch.randn(P, F, generator=g) * 0.5).to(
            torch.bfloat16 if specs[0][2] == "feat-bf16" else torch.float32)
    else:
        kw["geom"] = tuple(_geometry_table(g, i, spec, occ and i == 0, seed)
                           for i, spec in enumerate(specs))
    sig_ok = torch.rand(P, generator=g) > 0.2
    args = (quads, torch.from_numpy(pts), torch.from_numpy(cameras(V, neg_ray)), (HS, WS), sig_ok,
            head_weights(V, F, seed))
    return to_device(args, device), {k: to_device(v, device) for k, v in kw.items()}


def to_device(x, device):
    """Tensors, tables, weights and tuples of them on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, (FlatOctetTable, NearestTable)):
        return type(x)(to_device(x[0], device), *x[1:])
    if isinstance(x, ps.PointWeights):
        return ps.PointWeights([(w.to(device), b.to(device)) for w, b in x.layers],
                               x.flat.to(device))
    if isinstance(x, tuple):
        return tuple(to_device(y, device) for y in x)
    return x


def cover_keys():
    """Point-stage keys beyond FORMS that chip_smoke.py's phase 1 builds and
    phase 2a holds against plain, so that with FORMS every projection row
    type stands in table position A and B, every geometry table spec the
    renderer's switch space reaches (`reachable_kernel_keys`) stands in
    every table position where it occurs there, occ_geom meets every
    table-0 spec, and forms (a) and (c) run at 2, 4 and 8 views
    (tests/test_torch_point_keys.py checks the cover). chip_smoke.py's
    phase 3k renders five of them."""
    Key = ps.Key
    bf4, f4 = ((8, 32, "bf16"),) * 4, ((8, 32, "f32"),) * 4
    return [
        *(Key(("i8",), "default", False, v) for v in (2, 4, 8)),
        *(Key(("u8", "i8"), "default", False, v) for v in (2, 4, 8)),
        Key(("i8",), "feats128", False, 8),  # F = 128 at 8 views: 7 warps fit
        Key(("u8", "i8"), "coarse-octet", True),
        Key(("bf16",), "default", True),
        Key(("i8",), ((1, 32, "u8"), (8, 64, "i8")), False),
        Key(("bf16",), "coarse-octet", False),
        Key(("u8", "f32"), "l1-nearest", False),
        Key(("f32",), "float32", True),
        Key(("bf16", "i4"), "default", False),
        Key(("i8",), "float", True),
        Key(("i8",), bf4, False),
        Key(("f32", "f32"), f4, False),
        Key(("i8",), ((8, 32, "bf16"), (8, 96, "f32")), False),
        Key(("u8", "u8"), "default", False),  # u8 feature rows: no switch forms them
    ]


SWITCHES = ("tight_cull", "frame_mode", "sigma_query_cull", "int4_feat", "kernel_octet",
            "merge_src_feat", "merge_lowres_src", "quantize_proj", "quantize_volume",
            "merge_coarse_octet", "fold_coarse_fc", "int4_coarse", "pack_octet_u32", "dense_conv")


def reachable_kernel_keys():
    """Every point-stage key (3 views) the Renderer constructor's switches
    select: the boolean SWITCHES, coarse_nearest 0-2, l1_nearest 0, 1, 2
    and 11, bfloat16 or float32, uint8 or float source images (336 keys,
    ~50 s of host time)."""
    from gpnerf_tpu_torch.render.demo import Renderer

    keys = set()
    for bits in itertools.product((False, True), repeat=len(SWITCHES)):
        sw = dict(zip(SWITCHES, bits))
        for cn, l1, dt in itertools.product((0, 1, 2), (0, 1, 2, 11), (torch.bfloat16, None)):
            r = Renderer(None, None, voxel_size=(0.005,) * 3, n_samples=64,
                         samples_per_ray=13 if sw["tight_cull"] else 64, compute_dtype=dt,
                         coarse_nearest=cn, l1_nearest=l1, **sw)
            keys.update((r.kernel_form(True), r.kernel_form(False)))
    return sorted(keys, key=str)
