"""Per-point stages of the progressive renderer in one kernel
(gpnerf_tpu/ops/pallas_point.py, the TPU megakernel `_point_kernel`).

`fused_point_stages_tabs` takes the raw gathered rows of the projection quad
tables with their tap weights, the geometry feature — as the raw rows of the
geometry tables (octet rows with their 8 corner weights, nearest rows with
their in-bounds weight; `GEOMS` lists the layouts the renderer's switches
select) or as a (P, F) tensor already queried — the view mask, the
sample-cull mask and the head weights, and returns the sigma-masked alpha
(P,) and the alpha-culled rgb (P, 3), the only tensors the composite
needs. Between them: quad lerp +
dequant, mean/var over views, geometry lerp, sigma-feat linear, density MLP,
color MLP (see csrc/point_stages.cu). Its forms:

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

`fused_point_stages` is the one-table wrapper.

Numerics: every dot input is rounded to bf16 and accumulates in float32;
activations, lerps and masks are float32. The CUDA kernel runs the twelve
layers on tensor cores (16 x 16 x 16 bf16 WMMA tiles, float32 accumulators),
so it differs from the plain version only in the order of the float32 sums.

On a CPU tensor the wrapper runs `point_stages_tabs_plain`, the same function in
torch ops and general in views, channels, tables and F; on a CUDA tensor it
launches the CUDA kernel or raises. A call's key (`Key`: the projection
tables' row types, the geometry tables' specs, occ_geom, the view count V)
is read from its tensors, checked by `check_key` against what
csrc/point_stages.cu compiles, and its library built from that source at the
key's first use (ops/cuda_build.py); a failed build or launch raises.
`FORMS` names the keys of the shipped switch sets, `form_name` every other
key; `LAUNCHES` counts kernel launches per name.
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
from gpnerf_tpu_torch.ops.grid_sample import lerp_rows
from gpnerf_tpu_torch.utils import roofline

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
    lib.point_stages_launch.argtypes = [vp] * 6 + [arr] * 3 + [vp] * 6 + [ctypes.c_int, vp]
    lib.point_stages_launch.restype = ctypes.c_int
    for fn in (lib.point_stages_wbuf_bytes, lib.point_stages_smem_bytes,
               lib.point_stages_blocks_per_sm, lib.point_stages_block):
        fn.argtypes, fn.restype = [], ctypes.c_int
    lib.point_stages_key.argtypes, lib.point_stages_key.restype = [], ctypes.c_char_p
    return lib


def load_library(key, proc=None):
    """Build (unless the hashed library exists) and load one instantiation,
    NotImplementedError for a key the source does not compile (`check_key`).
    `proc`: an already started `start_build(key)` to wait on."""
    key = check_key(key)
    if key in _libs:
        return _libs[key]
    lib = bind_library(cuda_build.load(*_build_args(key), proc=proc, build_log=BUILD_LOG,
                                       log_key=key))
    if tuple(int(v) for v in lib.point_stages_key().split()) != _key_values(key):
        raise RuntimeError(f"{build_command(key)[1]} holds another instantiation than {key}")
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


def _read_geometry(geom_tabs, feats, P):
    """The geometry specs of a call, read from its tensors and checked:
    (((taps, channels, row type), ...), [(rows, weights, scale) per table]);
    the feature input is one table whose weights and scale are None."""
    if feats is not None:
        F = feats.shape[-1]
        if feats.dtype not in FEAT_ROWS:
            raise NotImplementedError(f"point-stage kernel: geometry features must be float32 "
                                      f"or bfloat16, got {feats.dtype}")
        _check(feats, feats.dtype, (P, F), "geometry features")
        return ((1, F, FEAT_ROWS[feats.dtype]),), [(feats, None, None)]
    specs = []
    for i, (g, w, sc) in enumerate(geom_tabs):
        taps = w.shape[0] if w.dim() == 2 else 0
        kind = _DTYPE_ROWS.get(g.dtype)
        if kind is None or taps < 1 or g.dim() != 2 or g.shape[-1] % taps:
            raise NotImplementedError(
                f"point-stage kernel: geometry table {i} must be int8, uint8, bfloat16 or "
                f"float32 rows (P, taps * channels) with (taps, P) weights, got "
                f"{g.dtype} {tuple(g.shape)} and {tuple(w.shape)}")
        ch = g.shape[-1] // taps
        _check(g, g.dtype, (P, taps * ch), f"geometry table {i} rows")
        _check(w, torch.float32, (taps, P), f"geometry table {i} weights")
        _check(sc, torch.float32, (ch,), f"geometry table {i} scale")
        specs.append((taps, ch, kind))
    return tuple(specs), list(geom_tabs)


def _launch(tabs, feats, vmask, sig_ok, weights, geom_tabs, occ_geom):
    nv, P = vmask.shape
    f32, u8 = torch.float32, torch.uint8
    if len(tabs) == 1:
        rows = (_row_type(tabs[0][0], nv, P, 4 * C, "merged [rgb|feat] rows"),)
        _check(tabs[0][2], f32, (C,), "merged scale")
        tabs = (tabs[0], (None, None, None))
    elif len(tabs) == 2:
        rows = (_row_type(tabs[0][0], nv, P, 4 * CS, "source rgb rows"),
                _row_type(tabs[1][0], nv, P, 4 * CF, "feature rows", packed_width=2 * CF))
        _check(tabs[0][2], f32, (CS,), "source rgb scale")
        _check(tabs[1][2], f32, (CF,), "feature scale")
    else:
        raise NotImplementedError("point-stage kernel takes 1 or 2 projection tables")
    for _, w4, _ in tabs:
        if w4 is not None:
            _check(w4, f32, (nv, 4, P), "tap weights")
    if feats is not None and (geom_tabs or occ_geom):
        raise ValueError("point-stage kernel: a feature input excludes "
                         "geometry tables and occ_geom")
    specs, geom = _read_geometry(geom_tabs, feats, P)
    _check(vmask, f32, (nv, P), "vmask")
    _check(sig_ok, u8, (P,), "sig_ok")
    key = check_key((rows, specs, occ_geom, nv))
    lib = load_library(key)
    flat = weights.flat
    _check(flat, u8, (lib.point_stages_wbuf_bytes(),), "packed weights")
    dev = tabs[0][0].device
    alpha = torch.empty(P, dtype=f32, device=dev)
    rgb = torch.empty(P, 3, dtype=f32, device=dev)
    occm = torch.empty(P, dtype=f32, device=dev) if occ_geom else None
    geom += [(None, None, None)] * (4 - len(geom))
    tensors = (*tabs[0], *tabs[1], *(t for g in geom for t in g), vmask, sig_ok, flat,
               alpha, rgb, occm)
    if any(t is not None and t.device != dev for t in tensors):
        raise ValueError("point-stage kernel: inputs on different devices")

    def ptr(t):
        return None if t is None else t.data_ptr()

    table_ptrs = [(ctypes.c_void_p * 4)(*(ptr(g[j]) for g in geom)) for j in range(3)]
    err = lib.point_stages_launch(
        *(ptr(t) for t in (*tabs[0], *tabs[1])), *table_ptrs,
        *(ptr(t) for t in (vmask, sig_ok, flat, alpha, rgb, occm)), P,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"point-stage kernel launch failed: CUDA error {err}")
    LAUNCHES[form_name(key)] += 1
    return (alpha, rgb, occm) if occ_geom else (alpha, rgb)


def op_counts(tabs, vmask, weights: PointWeights, geom_tabs=()):
    """(tensor-core FLOPs, float32 operations) of one call: the twelve
    layers' multiply-adds x 2 (the four per-view layers once per view), and
    the lerps (two per tap and channel of each table, plus 4 per view and
    channel for dequant, mean and variance)."""
    V, P = vmask.shape
    Cp = sum(t[2].shape[0] for t in tabs)
    macs = sum(w.shape[0] * w.shape[1] for w, _ in weights.layers)
    macs += (V - 1) * sum(w.shape[0] * w.shape[1] for w, _ in weights.layers[5:9])
    lerp = sum(V * t[2].shape[0] * 2 * t[1].shape[1] for t in tabs) + 4 * V * Cp
    lerp += sum(g[0].shape[1] * 2 + g[2].shape[0] for g in geom_tabs)
    return 2 * macs * P, lerp * P


def cost(tabs, feats, vmask, sig_ok, weights: PointWeights, *, geom_tabs=(), occ_geom=False):
    """(bytes, FLOPs) of one call (utils/roofline.py): every input read
    once (sig_ok as uint8, the packed weights), the outputs alpha, rgb
    [and occm] written once; `op_counts` summed."""
    P = vmask.shape[1]
    ins = roofline.nbytes(vmask, weights.flat, feats,
                          *(t for tab in (*tabs, *geom_tabs) for t in tab)) + P  # + sig_ok
    outs = 4 * P * (4 + int(occ_geom))  # alpha, rgb [, occm], float32
    return ins + outs, sum(op_counts(tabs, vmask, weights, geom_tabs))


def fused_point_stages_tabs(tabs, feats, vmask, sig_ok, weights: PointWeights, *,
                            geom_tabs=(), occ_geom=False):
    """Point stages on the device the inputs live on: the plain torch
    version for CPU tensors, the CUDA kernel for CUDA tensors. Same
    arguments and returns as `point_stages_tabs_plain` (sig_ok as uint8/bool).
    A count (utils/roofline.py) takes the call at its declared `cost`."""
    dev = tabs[0][0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"point stages: unsupported device {dev}")
    with roofline.note_kernel("point_stages", *cost(tabs, feats, vmask, sig_ok, weights,
                                                     geom_tabs=geom_tabs, occ_geom=occ_geom)):
        if dev.type == "cpu":
            return point_stages_tabs_plain(tabs, feats, vmask, sig_ok, weights,
                                           geom_tabs=geom_tabs, occ_geom=occ_geom)
        return _launch(tabs, feats, vmask, sig_ok.to(torch.uint8), weights,
                       tuple(geom_tabs), occ_geom)


def fused_point_stages(rows, w4, pscale, geom_tabs, vmask, sig_ok,
                       weights: PointWeights):
    """The one-table form: merged [rgb|feat] rows and geometry tables."""
    return fused_point_stages_tabs(((rows, w4, pscale),), None, vmask, sig_ok,
                                   weights, geom_tabs=geom_tabs)
