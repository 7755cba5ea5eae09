"""Per-point stages of the progressive renderer in one kernel
(gpnerf_tpu/ops/pallas_point.py, the TPU megakernel `_point_kernel`).

`fused_point_stages_from_tables` takes the points (world and dhw voxel
coordinates), the source cameras, each projection quad table as it stands,
the geometry feature — as the geometry tables themselves (octet tables,
flat or dense, and nearest tables: `fetchable`; `GEOMS` lists the layouts
the renderer's switches select) or as a (P, F) tensor queried outside — the
sample-cull mask and the head weights, and returns the sigma-masked alpha
(P,) and the alpha-culled rgb (P, 3), the only tensors the composite needs.
Each thread projects its point, computes every quad row, octet or nearest
row and tap weight itself and reads the rows straight from the tables, so
no gathered row, tap weight or view mask is written or read back. Between
them: quad lerp + dequant, mean/var over views, geometry lerp, sigma-feat
linear, density MLP, color MLP (see csrc/point_stages.cu). Its forms:

  (a) one merged int8 [rgb|feat] table, two geometry tables (fast mode);
      or merged bf16 / float32 rows with a unit scale (`a:bf16`, `a:f32`);
  (b) the geometry feature passed as a (P, F) tensor, F = 96 (`a+b`) or
      128 (`a+b@128`), float32, or bf16 as the renderer queries it under
      `tpu.matmul_dtype bfloat16` (`a+b@bf16`, `a+b@128-bf16`);
  (c) split projection tables: u8 full-resolution source rgb rows (dequant
      1/255) + int8 feature-grid rows, lerped and concatenated; or bf16 /
      float32 feature rows (`c:u8/bf16`, `c:u8/f32`), or bf16 / float32
      source rows (`c:bf16/i8`, `c:f32/i8`);
  (d) int4 split-packed feature rows (ops/grid_sample.quantize_image_i4),
      recognised by rows twice as narrow as taps x channels;
  (e) `occ_geom`: sigma also zeroed where the lerped level-1 block's channel
      sum (the trilinear occupancy) is <= 0, with that 0/1 verdict returned
      as a third output.
Float rows are rounded to bf16 before the tap sum, as the TPU kernel casts
them; bf16 rows are used as they are. A form named `<form>@<layout>` takes
the geometry tables of layout `<layout>` (`GEOMS`); the others the default
layout, the u8 level-1 octet table and the int8 folded-coarse nearest
table.

Its plain version `point_stages_from_tables_plain` is the composition the
kernel replaces: the torch gathers (`gather_from_tables`), then
`point_stages_tabs_plain`, the kernel's function on the gathered rows in
torch ops, general in views, channels, tables and F (`point_stages_plain`
its one-table form). On CPU tensors the entry runs the plain version; on
CUDA tensors it launches the kernel or raises, and adds P to the
profiler-time counter `kernel_fetched_slots` (utils/profiling.py).

Numerics: every dot input is rounded to bf16 and accumulates in float32;
activations, lerps and masks are float32. The CUDA kernel runs the twelve
layers on tensor cores (16 x 16 x 16 bf16 WMMA tiles, float32 accumulators),
so it differs from the plain version only in the order of the float32 sums.

A call's key (`Key`: the projection tables' row types, the geometry tables'
specs, occ_geom, the view count V) is read from its tensors, checked by
`check_key` against what csrc/point_stages.cu compiles, and its library
built from that source at the key's first use (ops/cuda_build.py); a failed
build or launch raises. `FORMS` names the keys of the shipped switch sets,
`form_name` every other key; `LAUNCHES` counts kernel launches per name.
"""

from __future__ import annotations

import collections
import ctypes
import os
from typing import List, NamedTuple, Tuple

import torch

from gpnerf_tpu_torch.models.layers import rounded
from gpnerf_tpu_torch.ops import cuda_build
from gpnerf_tpu_torch.ops.cuda_build import BUILD_DIR  # noqa: F401 (kept under this name)
from gpnerf_tpu_torch.ops.grid_sample import (
    FlatOctetTable,
    NearestTable,
    lerp_rows,
    nearest_row_and_weight,
    octet_rows_and_weights,
)
from gpnerf_tpu_torch.ops.projection import project_gather_rows_merged
from gpnerf_tpu_torch.utils import roofline
from gpnerf_tpu_torch.utils.profiling import count

SOURCE = os.path.join(cuda_build.CSRC_DIR, "point_stages.cu")

# the widths the CUDA kernel is written for (csrc/point_stages.cu constants):
# [rgb | feat] channels, their split, and the default layout's level-1 and
# folded-coarse geometry channels; V is the configs' view count
# (`src_view_num`), the one FORMS' keys carry, and MAX_V the most views a
# dataset chooses (data/base.py `select_views`: at most 8 candidates)
C, CS, CF, C0, C1 = 35, 3, 32, 32, 64
V, MAX_V = 3, 8

# Geometry layouts: name -> the geometry tables ((taps, channels, row type),
# ...) whose lerped blocks join, in order, into the geometry feature; taps 8
# are octet rows, 1 nearest rows; "feat" is a (P, F) float32 input queried
# outside the kernel, "feat-bf16" the same in bf16. Which switches select
# each: render/demo.py
# `geometry_layout`. A key holds its tables by these names where one fits,
# else as the specs themselves.
GEOMS = {
    "default": ((8, 32, "u8"), (1, 64, "i8")),       # coarse_nearest 1 or 2
    "coarse-octet": ((8, 32, "u8"), (8, 64, "i8")),  # coarse_nearest 0
    "unfolded": ((8, 32, "u8"), (8, 96, "u8")),      # fold_coarse_fc off
    "four-level": ((8, 32, "u8"),) * 4,              # merge_coarse_octet off
    "l1-nearest": ((1, 32, "u8"), (1, 64, "i8")),    # l1_nearest 1 or 2
    "float": ((8, 32, "bf16"), (8, 64, "f32")),      # quantize_volume off
    "float32": ((8, 32, "f32"), (8, 64, "f32")),     # the same under float32
    "feats96": ((1, 96, "feat"),),
    "feats128": ((1, 128, "feat"),),
    "feats96-bf16": ((1, 96, "feat-bf16"),),
    "feats128-bf16": ((1, 128, "feat-bf16"),),
}

# Row types: "i8", "u8", "i4" (split-packed int8 pairs), "bf16", "f32"; one
# type is the merged table, two are the (source, feature) pair. The macros
# of csrc/point_stages.cu follow (ROW_CODES, `_key_values`).
ROW_CODES = {"i8": 1, "u8": 2, "i4": 3, "bf16": 4, "f32": 5, "feat": 6, "feat-bf16": 7}
FEAT_ROWS = {torch.float32: "feat", torch.bfloat16: "feat-bf16"}


class Key(NamedTuple):
    """One instantiation of the CUDA kernel: the projection tables' row
    types, the geometry tables (a GEOMS name, or their ((taps, channels, row
    type), ...) specs), occ_geom and the view count. Equal to the plain
    tuple of its fields."""

    rows: tuple
    geom: object
    occ: bool
    views: int = V


# the keys of the shipped switch sets at V = 3 (render/demo.py
# `kernel_form`) -> their names
FORMS = {
    Key(("i8",), "default", False): "a",
    Key(("i8",), "feats96", False): "a+b",
    Key(("i8",), "default", True): "a+e",
    Key(("bf16",), "default", False): "a:bf16",
    Key(("f32",), "default", False): "a:f32",
    Key(("u8", "i8"), "default", False): "c",
    Key(("u8", "i8"), "default", True): "c+e",
    Key(("u8", "i8"), "feats96", False): "b+c",
    Key(("u8", "i4"), "default", False): "c+d",
    Key(("u8", "i4"), "default", True): "c+d+e",
    Key(("u8", "i4"), "feats96", False): "b+c+d",
    Key(("u8", "bf16"), "default", False): "c:u8/bf16",
    Key(("u8", "f32"), "default", False): "c:u8/f32",
    Key(("bf16", "i8"), "default", False): "c:bf16/i8",
    Key(("f32", "i8"), "default", False): "c:f32/i8",
    # the geometry-table switches (render/demo.py geometry_layout)
    **{Key(("i8",), layout, False): f"a@{layout}"
       for layout in ("coarse-octet", "unfolded", "four-level", "l1-nearest", "float",
                      "float32")},
    **{Key(("u8", "i8"), layout, False): f"c@{layout}"
       for layout in ("coarse-octet", "unfolded", "four-level", "l1-nearest", "float")},
    Key(("i8",), "l1-nearest", True): "a+e@l1-nearest",
    Key(("i8",), "feats128", False): "a+b@128",
    # the (P, F) feature queried in bf16 (tpu.matmul_dtype bfloat16)
    Key(("i8",), "feats96-bf16", False): "a+b@bf16",
    Key(("u8", "i8"), "feats96-bf16", False): "b+c@bf16",
    Key(("u8", "i4"), "feats96-bf16", False): "b+c+d@bf16",
    Key(("i8",), "feats128-bf16", False): "a+b@128-bf16",
}


def make_key(rows, geom, occ, views=V):
    """The Key of a call: `geom` a GEOMS name or a sequence of (taps,
    channels, row type) specs, held by its GEOMS name where one fits."""
    if not isinstance(geom, str):
        geom = tuple((int(t), int(c), str(r)) for t, c, r in geom)
        geom = next((k for k, v in GEOMS.items() if v == geom), geom)
    return Key(tuple(rows), geom, bool(occ), int(views))


def geom_specs(geom):
    """The ((taps, channels, row type), ...) geometry tables of a key's
    `geom` field (a GEOMS name or the specs)."""
    return GEOMS[geom] if isinstance(geom, str) else tuple(geom)


def check_key(key):
    """`key` as a Key if csrc/point_stages.cu compiles it (its static_asserts
    and block size, mirrored), else NotImplementedError naming what it
    lacks: one merged table of C channels (not int4: C is odd) or a source
    table of CS channels (not int4) beside a feature table of CF; 1 to 4
    geometry tables of 1 to 8 taps and a multiple of 32 channels of int8,
    uint8, bf16 or float32 rows, or one (P, F) float32 or bf16 input, F <=
    192; occ_geom
    only on geometry tables whose table 0 has 32 channels (JAX asserts the
    first half too, pallas_point.py:364); 1 to MAX_V views."""
    key = make_key(*key)
    rows, geom, occ, views = key
    specs = geom_specs(geom)
    why = []
    if not (len(rows) in (1, 2) and all(r in ROW_CODES and r not in FEAT_ROWS.values()
                                        for r in rows)
            and rows[0] != "i4"):
        why.append(f"projection row types {rows}: one merged table, or a source and a "
                   "feature table, of i8 / u8 / bf16 / f32 rows (int4 feature rows only)")
    feat = len(specs) == 1 and specs[0][2] in FEAT_ROWS.values() and specs[0][0] == 1
    tables_ok = 1 <= len(specs) <= 4 and all(
        1 <= t <= 8 and c > 0 and c % 32 == 0 and r in ("i8", "u8", "bf16", "f32")
        for t, c, r in specs)
    if not (feat or tables_ok) or not 32 <= sum(c for _, c, _ in specs) <= 192:
        why.append(f"geometry tables {specs}: 1-4 tables of 1-8 taps and 32k channels of "
                   "i8 / u8 / bf16 / f32 rows, or one (P, F) f32 / bf16 feature input, "
                   "F <= 192")
    if occ and (feat or specs[0][1] != 32):
        why.append("occ_geom needs geometry tables whose table 0 holds the 32 level-1 "
                   "channels")
    if not 1 <= views <= MAX_V:
        why.append(f"{views} views: the kernel takes 1 to {MAX_V}")
    if why:
        raise NotImplementedError(f"point-stage kernel: no instantiation for {tuple(key)}: "
                                  + "; ".join(why))
    return key


def form_name(key):
    """The name of a key: FORMS' for its own keys (with "@V<n>" where only
    the view count differs), else the row types ("a" merged int8, "a:<t>"
    merged, "c" u8 + int8, "c+d" u8 + int4, "c:<s>/<f>" split), "+e" for
    occ_geom, "@" and the geometry layout's name or its specs, "@V<n>"."""
    key = make_key(*key)
    rows, geom, occ, views = key
    base = key._replace(views=V)
    if base in FORMS:
        name = FORMS[base]
    else:
        if len(rows) == 1:
            name = "a" if rows == ("i8",) else f"a:{rows[0]}"
        else:
            name = {("u8", "i8"): "c", ("u8", "i4"): "c+d"}.get(rows, f"c:{rows[0]}/{rows[1]}")
        name += "+e" if occ else ""
        if geom != "default":
            name += "@" + (geom if isinstance(geom, str)
                           else "+".join(f"({t},{c},{r})" for t, c, r in geom))
    return name if views == V else f"{name}@V{views}"


_DTYPE_ROWS = {torch.int8: "i8", torch.uint8: "u8", torch.bfloat16: "bf16", torch.float32: "f32"}
LAUNCHES = collections.Counter()


class PointWeights(NamedTuple):
    """Head weights for the point stages: `layers` = 12 (W (Cout, Cin),
    b (Cout,)) float32 pairs in order [sigma-feat, density d0..d3, base b0
    b1, vis v0 v1, rgb r0..r2]; `flat` = the same as one uint8 byte buffer
    for the kernel's shared memory (`_kernel_layout`): every layer's
    bf16-rounded weight, zero-padded to (pad16(Cout), pad16(Cin)), row-major,
    layer after layer, then all float32 biases."""

    layers: List[Tuple[torch.Tensor, torch.Tensor]]
    flat: torch.Tensor


def pack_head_weights(nerfhead, fold_nch=None) -> PointWeights:
    """Flatten a NeRFHead's MLPs into PointWeights.

    `fold_nch`: the merged coarse table was built with out_geometry_fc's
    coarse block pre-applied (render/demo.py fold_coarse_fc), so the
    geometry input is [raw level-1 (fold_nch) | pre-multiplied coarse (64)]
    and the sigma-feat weight becomes [W[:, :fold_nch] | I_64]."""
    sf = nerfhead.sigmahead.out_geometry_fc[0]
    w_sf = sf.weight
    if fold_nch is not None:
        n_out = w_sf.shape[0]
        eye = torch.eye(n_out, dtype=w_sf.dtype, device=w_sf.device)
        w_sf = torch.cat([w_sf[:, :fold_nch], eye], dim=1)
    rh = nerfhead.rgbhead
    lins = [m for m in (*rh.out_geometry_fc, *rh.base_fc, *rh.vis_fc, *rh.rgb_fc)
            if isinstance(m, torch.nn.Linear)]
    layers = [(w_sf, sf.bias)] + [(m.weight, m.bias) for m in lins]
    layers = [(w.detach().float(), b.detach().float()) for w, b in layers]
    return PointWeights(layers, _kernel_layout(layers))


def pad16(n):
    """`n` rounded up to the 16 of a tensor-core tile."""
    return -(-n // 16) * 16


def _kernel_layout(layers):
    """The byte buffer of PointWeights.flat. A layer's (pad16(Cout),
    pad16(Cin)) bf16 block, row-major, is the kernel's `matrix_b` operand
    (W^T) in column-major order with a leading dimension of pad16(Cin); every
    block is a whole number of 16 x 16 tiles, so all stay 32-byte aligned."""
    ws, bs = [], []
    for w, b in layers:
        cout, cin = w.shape
        wp = torch.zeros(pad16(cout), pad16(cin), dtype=torch.bfloat16, device=w.device)
        wp[:cout, :cin] = w.to(torch.bfloat16)
        ws.append(wp.reshape(-1))
        bs.append(b.float())
    return torch.cat([torch.cat(ws).view(torch.uint8),
                      torch.cat(bs).view(torch.uint8)]).contiguous()


def _elu(x):
    return torch.where(x > 0, x, torch.exp(torch.clamp(x, max=0.0)) - 1.0)


def _dense(layer, x):
    w, b = layer
    return rounded(x, torch.bfloat16) @ rounded(w, torch.bfloat16).T + b


def _lerp_tab(rows, w, scale):
    """One projection table's quad lerp + dequant: rows (V*P, Tt*Ct), or
    (V*P, Tt*Ct/2) int4 split-packed; w (V, Tt, P); scale (Ct,). Returns
    (V, P, Ct) float32, taps summed in order."""
    nv, Tt, P = w.shape
    Ct = scale.shape[-1]
    if rows.shape[-1] * 2 == Tt * Ct:
        b = rows.reshape(nv, P, Tt, Ct // 2).to(torch.int32)
        r = torch.cat([((b & 0xF) ^ 8) - 8, (((b >> 4) & 0xF) ^ 8) - 8], dim=-1)
    else:
        r = rows.reshape(nv, P, Tt, Ct)
        if r.is_floating_point():
            r = rounded(r, torch.bfloat16)  # the TPU kernel lerps bf16 rows
    acc = r[:, :, 0].float() * w[:, 0, :, None]
    for k in range(1, Tt):
        acc = acc + r[:, :, k].float() * w[:, k, :, None]
    return acc * scale


def point_stages_tabs_plain(tabs, feats, vmask, sig_ok, weights: PointWeights, *,
                            geom_tabs=(), occ_geom=False):
    """The kernel's function in torch ops.

    tabs = ((rows (V*P, Tt*Ct) view-major, w (V, Tt, P) tap weights, scale
    (Ct,) dequant factors), ...) projection tables whose channel blocks
    concatenate; feats (P, F) or None; geom_tabs = ((rows (P, Tg*Cg), w (Tg,
    P), scale (Cg,)), ...) concatenated in order when feats is None; vmask
    (V, P) float; sig_ok (P,) bool. Returns alpha (P,), rgb (P, 3) float32
    [, occm (P,) float32 0/1 iff occ_geom]."""
    if occ_geom and not geom_tabs:
        raise ValueError("occ_geom needs geometry tables")
    nv_ = vmask.shape[0]
    rf = torch.cat([_lerp_tab(*t) for t in tabs], dim=-1)  # (V, P, C)
    mean = rf[0]
    for v in range(1, nv_):
        mean = mean + rf[v]
    mean = mean / float(nv_)
    var = (rf[0] - mean) ** 2
    for v in range(1, nv_):
        var = var + (rf[v] - mean) ** 2
    var = var / float(nv_)
    ok = sig_ok.bool()
    if feats is None:
        # float rows are rounded to bf16 first, as the TPU kernel casts them
        gparts = [lerp_rows(rounded(g, torch.bfloat16) if g.is_floating_point() else g, w.T, s)
                  for g, w, s in geom_tabs]
        f = torch.cat(gparts, dim=-1)
        if occ_geom:
            occ = gparts[0].sum(dim=-1) > 0
            ok = ok & occ
    else:
        f = feats.float()
    L = weights.layers
    sf = _elu(_dense(L[0], f))
    h = _elu(_dense(L[1], torch.cat([sf, mean, var], dim=-1)))
    h = _elu(_dense(L[2], h))
    h = _elu(_dense(L[3], h))
    sigma = torch.relu(_dense(L[4], h))[:, 0]
    nv = vmask[0]
    for v in range(1, nv_):
        nv = nv + vmask[v]
    sigma = torch.where((nv < 1.0) | ~ok, 0.0, sigma)
    alpha = 1.0 - torch.exp(-sigma)
    hs = []
    for v in range(nv_):
        hv = _elu(_dense(L[5], torch.cat([mean, var, rf[v]], dim=-1)))
        hv = _elu(_dense(L[6], hv))
        h2 = _elu(_dense(L[7], hv / float(nv_)))
        h2 = _elu(_dense(L[8], h2))
        hs.append(hv + h2)
    x = _elu(_dense(L[9], torch.cat(hs, dim=-1)))
    x = _elu(_dense(L[10], x))
    rgb = torch.sigmoid(_dense(L[11], x))
    alive = (alpha > 1e-14) & ok
    out = (alpha, torch.where(alive[:, None], rgb, 0.0))
    return out + (occ.float(),) if occ_geom else out


def point_stages_plain(rows, w4, pscale, geom_tabs, vmask, sig_ok,
                       weights: PointWeights):
    """The one-table form of `point_stages_tabs_plain`."""
    return point_stages_tabs_plain(((rows, w4, pscale),), None, vmask, sig_ok,
                                   weights, geom_tabs=geom_tabs)


# ---------------------------------------------------------------------------
# CUDA build + launch
# ---------------------------------------------------------------------------

_libs = {}
BUILD_LOG = {}


def _key_values(key):
    """The macro values of one instantiation, in csrc/point_stages.cu's
    `point_stages_key` order: PS_ROW_A, PS_ROW_B (0: one table), PS_OCC,
    PS_G0 .. PS_G3 (row type * 10000 + taps * 1000 + channels per geometry
    table, 0 past its tables), PS_V."""
    key = check_key(key)
    rows = key.rows
    geom = [ROW_CODES[kind] * 10000 + taps * 1000 + ch for taps, ch, kind in geom_specs(key.geom)]
    return (ROW_CODES[rows[0]], ROW_CODES[rows[1]] if len(rows) > 1 else 0, int(key.occ),
            *geom, *[0] * (4 - len(geom)), key.views)


def _build_args(key):
    vals = _key_values(key)
    names = ("PS_ROW_A", "PS_ROW_B", "PS_OCC", "PS_G0", "PS_G1", "PS_G2", "PS_G3", "PS_V")
    defines = tuple(f"{n}={v}" for n, v in zip(names, vals))
    code = "_".join(str(v) for v in vals)
    return "point_stages.cu", f"point_stages_{code}", defines


def build_command(key):
    """(nvcc argv, library path) of one instantiation (a Key, or a tuple of
    its fields) for the current source (ops/cuda_build.py)."""
    return cuda_build.build_command(*_build_args(key))


def start_build(key):
    """Start nvcc for `key` unless its library exists; returns the Popen
    (or None) to hand to load_library. Lets a caller build keys together."""
    return cuda_build.start_build(*_build_args(key))


def bind_library(lib):
    """Declare the C entry points of a loaded point_stages.cu library."""
    vp, arr = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
    lib.point_stages_launch.argtypes = [vp] * 4 + [arr] * 2 + [vp] * 5 + [ctypes.c_int, vp, vp]
    lib.point_stages_launch.restype = ctypes.c_int
    for fn in (lib.point_stages_wbuf_bytes, lib.point_stages_smem_bytes,
               lib.point_stages_blocks_per_sm, lib.point_stages_block,
               lib.point_stages_fetch_bytes):
        fn.argtypes, fn.restype = [], ctypes.c_int
    lib.point_stages_key.argtypes, lib.point_stages_key.restype = [], ctypes.c_char_p
    return lib


def load_library(key, proc=None):
    """Build (unless the hashed library exists) and load the instantiation
    of `key`, NotImplementedError for a key the source does not compile
    (`check_key`). `proc`: an already started `start_build(key)` to wait
    on."""
    key = check_key(key)
    if key in _libs:
        return _libs[key]
    lib = bind_library(cuda_build.load(*_build_args(key), proc=proc, build_log=BUILD_LOG,
                                       log_key=key))
    if tuple(int(v) for v in lib.point_stages_key().split()) != _key_values(key):
        raise RuntimeError(f"{build_command(key)[1]} holds another instantiation than {key}")
    if lib.point_stages_fetch_bytes() != ctypes.sizeof(_Fetch):
        raise RuntimeError("point_stages.cu's Fetch and the wrapper's _Fetch differ in size")
    _libs[key] = lib
    return lib


def occupancy(key):
    """(blocks resident per SM on the current device, dynamic shared-memory
    bytes per block, threads per block) of one instantiation; blocks < 0 is
    the negated CUDA error of a refused shared-memory request."""
    lib = load_library(key)
    return lib.point_stages_blocks_per_sm(), lib.point_stages_smem_bytes(), lib.point_stages_block()


def _check(t, dtype, shape, name):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise NotImplementedError(
            f"point-stage kernel: {name} must be {dtype} {tuple(shape)}, got "
            f"{t.dtype} {tuple(t.shape)}"
        )
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"point-stage kernel: {name} must be contiguous and "
                         "16-byte aligned")


def _row_type(rows, nv, P, width, name, packed_width=None):
    """Row type of one projection table's (nv*P, width) rows, checked; int4
    split-packed uint8 rows are `packed_width` wide."""
    kind = _DTYPE_ROWS.get(rows.dtype)
    if kind == "u8" and packed_width is not None and rows.shape[-1] == packed_width:
        kind, width = "i4", packed_width
    if kind is None or rows.shape[-1] != width:
        raise NotImplementedError(
            f"point-stage kernel: {name} must be int8, uint8, bfloat16 or float32 rows "
            f"{width} wide, got {rows.dtype} {tuple(rows.shape)}")
    _check(rows, rows.dtype, (nv * P, width), name)
    return kind


class _Fetch(ctypes.Structure):
    """csrc/point_stages.cu's `Fetch`, field for field."""

    _fields_ = [("pts", ctypes.c_void_p), ("dhw", ctypes.c_void_p), ("ke", ctypes.c_void_p),
                ("neg", ctypes.c_int), ("src_h", ctypes.c_int), ("src_w", ctypes.c_int),
                ("quad_h", ctypes.c_int * 2), ("quad_w", ctypes.c_int * 2),
                ("out_sh", ctypes.c_int * 3), ("geo_dims", (ctypes.c_int * 3) * 4),
                ("geo_size", (ctypes.c_int * 3) * 4)]


def fetchable(table):
    """Whether the kernel reads rows of geometry table `table` itself: a
    FlatOctetTable or a dense (Dp, Hp, Wp, 8C) octet table of int8, uint8,
    bf16 or float32 rows, or a NearestTable sampled nearest on every axis.
    Int4 and word-packed octet tables and nearest tables with linear axes
    are queried outside (the (P, F) feature input)."""
    if isinstance(table, NearestTable):
        return not table.lerp_axes and table.rows.dtype in _DTYPE_ROWS
    if isinstance(table, FlatOctetTable):
        return table.rows.dtype in _DTYPE_ROWS
    return isinstance(table, torch.Tensor) and table.dim() == 4 and table.dtype in _DTYPE_ROWS


def _geom_layout(table):
    """(flat rows, row strides (3,), taps) of a fetchable geometry table."""
    if isinstance(table, NearestTable):
        return table.rows, tuple(table.shape), 1
    if isinstance(table, FlatOctetTable):
        return table.rows, tuple(table.shape), 8
    return table.reshape(-1, table.shape[-1]), tuple(table.shape[:3]), 8


def table_channels(table):
    """Channels of a fetchable geometry table (per tap of its rows)."""
    g, _, taps = _geom_layout(table)
    return g.shape[-1] // taps


def _geom_size(i, table, out_sh):
    """Valid extent (3 ints) of geometry table i of a frame of level-0 extent
    `out_sh`: a nearest table's grid (`div`, midpoint-doubled by
    `interleave`), else level i + 1's octet grid."""
    if isinstance(table, NearestTable):
        size = [o // table.div for o in out_sh]
        if table.interleave > 1:
            size = [table.interleave * (s - 1) + 1 for s in size]
        return size
    return [o // 2 ** (i + 1) for o in out_sh]


def geometry_rows(i, table, scale, frac, out_sh):
    """Geometry table i's rows at the points, the tap weights (Tg, P) and
    the scale (unit for float tables), for points at `frac` = dhw / out_sh
    (out_sh a (3,) int tensor): what the kernel fetches, gathered in torch
    ops."""
    if isinstance(table, NearestTable):
        size = out_sh // table.div
        if table.interleave > 1:
            size = table.interleave * (size - 1) + 1
        rows, w = nearest_row_and_weight(table, frac * (size - 1).float(), size)
    else:
        size = out_sh // (2 ** (i + 1))
        rows, w = octet_rows_and_weights(table, frac * (size - 1).float(), size)
    sc = torch.ones(rows.shape[-1] // w.shape[-1], device=rows.device) if scale is None else scale
    return rows, w.T.contiguous(), sc


def gather_from_tables(quads, pts_c, KE, src_hw, sig_ok, *, geom=(), dhw_c=None, out_sh=None,
                       feats=None, neg_ray=False, occ_geom=False):
    """The inputs of `point_stages_tabs_plain` for one call of the entry,
    gathered in torch ops: ((tabs, feats, vmask, sig_ok), {"geom_tabs",
    "occ_geom"}). The projection rows in view-major order with their tap
    weights and the view mask (ops/projection.py project_gather_rows_merged;
    the feature table of a split pair view by view), each geometry table's
    rows and weights (`geometry_rows`)."""
    Hs, Ws = src_hw
    rows, w4, vmask = project_gather_rows_merged(pts_c, KE, quads[0][0], Hs, Ws, neg_ray=neg_ray)
    tabs = [(rows, w4, quads[0][1])]
    if len(quads) == 2:
        # the view mask is projection-only and the same for both tables
        rows_f, w4_f, _ = project_gather_rows_merged(pts_c, KE, quads[1][0], Hs, Ws,
                                                     neg_ray=neg_ray, batched=True)
        tabs.append((rows_f, w4_f, quads[1][1]))
    geom_tabs = ()
    if geom:
        out_sh_t = torch.tensor(out_sh, device=dhw_c.device)
        frac = dhw_c / out_sh_t.float()
        geom_tabs = tuple(geometry_rows(i, t, sc, frac, out_sh_t) for i, (t, sc) in enumerate(geom))
    return (tuple(tabs), feats, vmask, sig_ok), {"geom_tabs": geom_tabs, "occ_geom": occ_geom}


def point_stages_from_tables_plain(quads, pts_c, KE, src_hw, sig_ok, weights: PointWeights,
                                   **kw):
    """The kernel's function in torch ops: `gather_from_tables`, then
    `point_stages_tabs_plain`."""
    args, kw_t = gather_from_tables(quads, pts_c, KE, src_hw, sig_ok, **kw)
    return point_stages_tabs_plain(*args[:3], args[3], weights, **kw_t)


def _quad_type(table, nv, width, name, packed_width=None):
    """Row type of a (V, Ht+1, Wt+1, width) projection quad table, checked
    (int4 split-packed uint8 tables are `packed_width` wide)."""
    if table.dim() != 4 or table.shape[0] != nv:
        raise NotImplementedError(f"point-stage kernel: {name} must be a ({nv}, Ht+1, Wt+1, 4C) "
                                  f"quad table, got {tuple(table.shape)}")
    return _row_type(table.reshape(-1, table.shape[-1]), nv, table.shape[1] * table.shape[2],
                     width, name, packed_width)


def _launch_from_tables(quads, pts_c, KE, src_hw, sig_ok, weights, geom, dhw_c, out_sh, feats,
                        neg_ray, occ_geom):
    f32, u8 = torch.float32, torch.uint8
    nv, P = KE.shape[0], pts_c.shape[0]
    if len(quads) == 1:
        rows = (_quad_type(quads[0][0], nv, 4 * C, "merged [rgb|feat] table"),)
        _check(quads[0][1], f32, (C,), "merged scale")
        quads = (quads[0], (None, None))
    elif len(quads) == 2:
        rows = (_quad_type(quads[0][0], nv, 4 * CS, "source rgb table"),
                _quad_type(quads[1][0], nv, 4 * CF, "feature table", packed_width=2 * CF))
        _check(quads[0][1], f32, (CS,), "source rgb scale")
        _check(quads[1][1], f32, (CF,), "feature scale")
    else:
        raise NotImplementedError("point-stage kernel takes 1 or 2 projection tables")
    if feats is not None and (geom or occ_geom):
        raise ValueError("point-stage kernel: a feature input excludes "
                         "geometry tables and occ_geom")
    _check(KE, f32, (nv, 4, 4), "cameras KE")
    _check(pts_c, f32, (P, 3), "points")
    specs, gptrs, dims, sizes = [], [], [], []
    if feats is not None:
        if feats.dtype not in FEAT_ROWS:
            raise NotImplementedError(f"point-stage kernel: geometry features must be float32 "
                                      f"or bfloat16, got {feats.dtype}")
        _check(feats, feats.dtype, (P, feats.shape[-1]), "geometry features")
        specs.append((1, feats.shape[-1], FEAT_ROWS[feats.dtype]))
        gptrs.append((feats, None))
    else:
        _check(dhw_c, f32, (P, 3), "dhw points")
        for i, (table, sc) in enumerate(geom):
            if not fetchable(table):
                raise NotImplementedError(f"point-stage kernel: geometry table {i} is no table "
                                          "it fetches rows of (ops/point_stages.py fetchable)")
            g, dim, taps = _geom_layout(table)
            kind = _DTYPE_ROWS[g.dtype]
            if g.shape[-1] % taps:
                raise NotImplementedError(f"point-stage kernel: geometry table {i} rows "
                                          f"{tuple(g.shape)} are no {taps}-tap rows")
            ch = g.shape[-1] // taps
            _check(g, g.dtype, tuple(g.shape), f"geometry table {i} rows")
            if sc is not None:
                _check(sc, f32, (ch,), f"geometry table {i} scale")
            specs.append((taps, ch, kind))
            gptrs.append((g, sc))
            dims.append(dim)
            sizes.append(_geom_size(i, table, out_sh))
    _check(sig_ok, u8, (P,), "sig_ok")
    key = check_key((rows, tuple(specs), occ_geom, nv))
    fetch = _Fetch(pts=pts_c.data_ptr(), dhw=None if dhw_c is None else dhw_c.data_ptr(),
                   ke=KE.data_ptr(), neg=int(bool(neg_ray)), src_h=int(src_hw[0]),
                   src_w=int(src_hw[1]))
    for t, (table, _) in enumerate(quads):
        if table is not None:
            fetch.quad_h[t], fetch.quad_w[t] = table.shape[1] - 1, table.shape[2] - 1
    if out_sh is not None:
        fetch.out_sh[:] = [int(v) for v in out_sh]
    for g, (dim, size) in enumerate(zip(dims, sizes)):
        fetch.geo_dims[g][:] = [int(v) for v in dim]
        fetch.geo_size[g][:] = [int(v) for v in size]
    outs = _run(key, quads, gptrs, sig_ok, weights, P, pts_c.device, occ_geom, fetch,
                inputs=(KE, pts_c, dhw_c))
    count("kernel_fetched_slots", P)
    return outs


def _run(key, quads, geom, sig_ok, weights, P, dev, occ_geom, fetch, inputs):
    """Launch the library of `key` on P points: quads = the two projection
    quad tables' (table, scale), geom = the geometry tables' (rows, scale)
    or the feature input's (feats, None), sig_ok, the packed weights and
    the launch's `_Fetch`, whose point and camera tensors `inputs` are.
    Returns the outputs."""
    lib = load_library(key)
    f32 = torch.float32
    flat = weights.flat
    _check(flat, torch.uint8, (lib.point_stages_wbuf_bytes(),), "packed weights")
    alpha = torch.empty(P, dtype=f32, device=dev)
    rgb = torch.empty(P, 3, dtype=f32, device=dev)
    occm = torch.empty(P, dtype=f32, device=dev) if occ_geom else None
    geom = list(geom) + [(None, None)] * (4 - len(geom))
    tensors = (*quads[0], *quads[1], *(t for g in geom for t in g), sig_ok, flat, alpha, rgb,
               occm, *inputs)
    if any(t is not None and t.device != dev for t in tensors):
        raise ValueError("point-stage kernel: inputs on different devices")

    def ptr(t):
        return None if t is None else t.data_ptr()

    table_ptrs = [(ctypes.c_void_p * 4)(*(ptr(g[j]) for g in geom)) for j in range(2)]
    err = lib.point_stages_launch(
        *(ptr(t) for t in (*quads[0], *quads[1])), *table_ptrs,
        *(ptr(t) for t in (sig_ok, flat, alpha, rgb, occm)), P,
        torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(fetch),
    )
    if err != 0:
        raise RuntimeError(f"point-stage kernel launch failed: CUDA error {err}")
    LAUNCHES[form_name(key)] += 1
    return (alpha, rgb, occm) if occ_geom else (alpha, rgb)


def _op_counts(V, P, proj_ch, geom_tc, weights: PointWeights):
    """(tensor-core FLOPs, float32 operations) of one call of V views and P
    points, projection tables of `proj_ch` channels (4 taps each) and
    geometry tables of `geom_tc` (taps, channels): the twelve layers'
    multiply-adds x 2 (the four per-view layers once per view), and the
    lerps (two per tap and channel of each table, plus 4 per view and
    channel for dequant, mean and variance)."""
    macs = sum(w.shape[0] * w.shape[1] for w, _ in weights.layers)
    macs += (V - 1) * sum(w.shape[0] * w.shape[1] for w, _ in weights.layers[5:9])
    lerp = sum(V * ch * 2 * 4 for ch in proj_ch) + 4 * V * sum(proj_ch)
    lerp += sum(taps * ch * 2 + ch for taps, ch in geom_tc)
    return 2 * macs * P, lerp * P


def cost_from_tables(quads, pts_c, KE, src_hw, sig_ok, weights: PointWeights, *, geom=(),
                     dhw_c=None, out_sh=None, feats=None, neg_ray=False, occ_geom=False):
    """(bytes, FLOPs) of one call (utils/roofline.py): each point's quad
    row of every view and table and its geometry rows (or feature row) read
    once, the points (world and dhw), the cameras, the scales, sig_ok
    (uint8) and the packed weights read once, the outputs written once;
    `_op_counts` summed."""
    nv, P = KE.shape[0], pts_c.shape[0]
    proj_row = sum(q[0].shape[-1] * q[0].element_size() for q in quads)
    ins = P * nv * proj_row + roofline.nbytes(pts_c, KE, weights.flat, feats,
                                              *(q[1] for q in quads)) + P
    geom_tc = []
    if feats is None:
        ins += roofline.nbytes(dhw_c)
        for table, sc in geom:
            g, _, taps = _geom_layout(table)
            ins += P * g.shape[-1] * g.element_size() + roofline.nbytes(sc)
            geom_tc.append((taps, g.shape[-1] // taps))
    outs = 4 * P * (4 + int(occ_geom))
    return ins + outs, sum(_op_counts(nv, P, [q[1].shape[0] for q in quads], geom_tc, weights))


def fused_point_stages_from_tables(quads, pts_c, KE, src_hw, sig_ok, weights: PointWeights, *,
                                   geom=(), dhw_c=None, out_sh=None, feats=None, neg_ray=False,
                                   occ_geom=False):
    """Point stages fed by the tables: the CUDA kernel fetching its own rows
    for CUDA tensors, `point_stages_from_tables_plain` for CPU tensors.

    quads = ((table (V, Ht+1, Wt+1, 4Ct), scale (Ct,)), ...): the merged
    [rgb|feat] quad table, or the (source, feature) pair, as
    ops/grid_sample.build_quad_table_2d builds them; pts_c (P, 3) world
    points; KE (V, 4, 4) the source cameras; src_hw the source images' (H,
    W), the pixel frame of KE; neg_ray THuman's convention. geom = ((table,
    scale or None for a unit one), ...) geometry tables of the frame
    (each `fetchable`; table i an octet table of level i + 1, or a
    NearestTable) with dhw_c (P, 3) the points in level-0 voxel units and
    out_sh the frame's level-0 extent (3 ints); or feats (P, F), the feature
    queried outside. sig_ok (P,) bool or uint8. Returns as
    `point_stages_tabs_plain`. A count (utils/roofline.py) takes the call at
    its declared `cost_from_tables`."""
    dev = pts_c.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"point stages: unsupported device {dev}")
    kw = dict(geom=tuple(geom), dhw_c=dhw_c, out_sh=out_sh, feats=feats, neg_ray=neg_ray,
              occ_geom=occ_geom)
    with roofline.note_kernel("point_stages", *cost_from_tables(quads, pts_c, KE, src_hw, sig_ok,
                                                                weights, **kw)):
        if dev.type == "cpu":
            return point_stages_from_tables_plain(quads, pts_c, KE, src_hw, sig_ok, weights, **kw)
        return _launch_from_tables(quads, pts_c.contiguous(), KE.contiguous(), src_hw,
                                   sig_ok.to(torch.uint8), weights, kw["geom"],
                                   None if dhw_c is None else dhw_c.contiguous(), out_sh, feats,
                                   neg_ray, occ_geom)
