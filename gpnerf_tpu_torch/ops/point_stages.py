"""Per-point stages of the progressive renderer in one kernel
(gpnerf_tpu/ops/pallas_point.py, the TPU megakernel `_point_kernel`).

`fused_point_stages_tabs` takes the raw gathered rows of the projection quad
tables with their tap weights, the geometry feature — as the raw rows of the
geometry tables (u8 level-1 octet rows with 8 corner weights, int8
folded-coarse nearest rows with their in-bounds weight) or as a (P, F)
tensor already queried — the view mask, the sample-cull mask and the head
weights, and returns the sigma-masked alpha (P,) and the alpha-culled rgb
(P, 3), the only tensors the composite needs. Between them: quad lerp +
dequant, mean/var over views, geometry lerp, sigma-feat linear, density MLP,
color MLP (see csrc/point_stages.cu). Its forms:

  (a) one merged int8 [rgb|feat] table, two geometry tables (fast mode);
      or merged bf16 / float32 rows with a unit scale (`a:bf16`, `a:f32`);
  (b) the geometry feature passed as a (P, F) tensor;
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
them; bf16 rows are used as they are.

`fused_point_stages` is the one-table wrapper.

Numerics: every dot input is rounded to bf16 and accumulates in float32;
activations, lerps and masks are float32. The CUDA kernel runs the twelve
layers on tensor cores (16 x 16 x 16 bf16 WMMA tiles, float32 accumulators),
so it differs from the plain version only in the order of the float32 sums.

On a CPU tensor the wrapper runs `point_stages_tabs_plain`, the same function in
torch ops and general in views, channels, tables and F; on a CUDA tensor it
launches the CUDA kernel — one library per form in `FORMS`, built from
csrc/point_stages.cu at first use (ops/cuda_build.py) — or raises:
a form or width with no instantiation is NotImplementedError. `LAUNCHES`
counts kernel launches per form.
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

SOURCE = os.path.join(cuda_build.CSRC_DIR, "point_stages.cu")

# the widths the CUDA kernel is written for (csrc/point_stages.cu constants)
V, C, CS, CF, C0, C1 = 3, 35, 3, 32, 32, 64

# instantiations of the CUDA kernel: (the projection tables' row types, (P,
# F) feature input, occ_geom) -> form name. Row types: "i8", "u8", "i4"
# (split-packed int8 pairs), "bf16", "f32"; one type is the merged table,
# two are the (source, feature) pair. The macros of csrc/point_stages.cu
# follow (ROW_CODES).
ROW_CODES = {"i8": 1, "u8": 2, "i4": 3, "bf16": 4, "f32": 5}
FORMS = {
    (("i8",), False, False): "a",
    (("i8",), True, False): "a+b",
    (("i8",), False, True): "a+e",
    (("bf16",), False, False): "a:bf16",
    (("f32",), False, False): "a:f32",
    (("u8", "i8"), False, False): "c",
    (("u8", "i8"), False, True): "c+e",
    (("u8", "i8"), True, False): "b+c",
    (("u8", "i4"), False, False): "c+d",
    (("u8", "i4"), False, True): "c+d+e",
    (("u8", "i4"), True, False): "b+c+d",
    (("u8", "bf16"), False, False): "c:u8/bf16",
    (("u8", "f32"), False, False): "c:u8/f32",
    (("bf16", "i8"), False, False): "c:bf16/i8",
    (("f32", "i8"), False, False): "c:f32/i8",
}
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
        gparts = [lerp_rows(g, w.T, s) for g, w, s in geom_tabs]
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


def _row_codes(rows):
    """(PS_ROW_A, PS_ROW_B) of a form's row types."""
    return ROW_CODES[rows[0]], ROW_CODES[rows[1]] if len(rows) > 1 else 0


def _build_args(form):
    rows, use_feats, occ = form
    ra, rb = _row_codes(rows)
    code = f"{ra}{rb}{int(use_feats)}{int(occ)}"
    defines = (f"PS_ROW_A={ra}", f"PS_ROW_B={rb}", f"PS_FEATS={int(use_feats)}",
               f"PS_OCC={int(occ)}")
    return "point_stages.cu", f"point_stages_{code}", defines


def build_command(form):
    """(nvcc argv, library path) of one instantiation (a key of FORMS) for
    the current source (ops/cuda_build.py)."""
    return cuda_build.build_command(*_build_args(form))


def start_build(form):
    """Start nvcc for `form` unless its library exists; returns the Popen
    (or None) to hand to load_library. Lets a caller build forms together."""
    return cuda_build.start_build(*_build_args(form))


def load_library(form, proc=None):
    """Build (unless the hashed library exists) and load one instantiation.
    `proc`: an already started `start_build(form)` to wait on."""
    if form in _libs:
        return _libs[form]
    if form not in FORMS:
        raise NotImplementedError(f"point-stage kernel: no instantiation for {form}")
    lib = cuda_build.load(*_build_args(form), proc=proc, build_log=BUILD_LOG,
                          log_key=form)
    vp = ctypes.c_void_p
    lib.point_stages_launch.argtypes = [vp] * 19 + [ctypes.c_int, vp]
    lib.point_stages_launch.restype = ctypes.c_int
    for fn in (lib.point_stages_wbuf_bytes, lib.point_stages_form,
               lib.point_stages_smem_bytes, lib.point_stages_blocks_per_sm):
        fn.argtypes, fn.restype = [], ctypes.c_int
    rows, use_feats, occ = form
    ra, rb = _row_codes(rows)
    if lib.point_stages_form() != ra | rb << 3 | int(use_feats) << 6 | int(occ) << 7:
        raise RuntimeError(f"{build_command(form)[1]} holds another instantiation than {form}")
    _libs[form] = lib
    return lib


def occupancy(form):
    """(blocks resident per SM on the current device, dynamic shared-memory
    bytes per block) of one instantiation; blocks < 0 is the negated CUDA
    error of a refused shared-memory request."""
    lib = load_library(form)
    return lib.point_stages_blocks_per_sm(), lib.point_stages_smem_bytes()


def _check(t, dtype, shape, name):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise NotImplementedError(
            f"point-stage kernel: {name} must be {dtype} {tuple(shape)}, got "
            f"{t.dtype} {tuple(t.shape)}"
        )
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"point-stage kernel: {name} must be contiguous and "
                         "16-byte aligned")


def _row_type(rows, P, width, name, packed_width=None):
    """Row type of one projection table's (V*P, width) rows, checked; int4
    split-packed uint8 rows are `packed_width` wide."""
    kind = _DTYPE_ROWS.get(rows.dtype)
    if kind == "u8" and packed_width is not None and rows.shape[-1] == packed_width:
        kind, width = "i4", packed_width
    if kind is None or rows.shape[-1] != width:
        raise NotImplementedError(
            f"point-stage kernel: {name} must be int8, uint8, bfloat16 or float32 rows "
            f"{width} wide, got {rows.dtype} {tuple(rows.shape)}")
    _check(rows, rows.dtype, (V * P, width), name)
    return kind


def _launch(tabs, feats, vmask, sig_ok, weights, geom_tabs, occ_geom):
    P = vmask.shape[-1]
    f32, u8, i8 = torch.float32, torch.uint8, torch.int8
    if len(tabs) == 1:
        rows = (_row_type(tabs[0][0], P, 4 * C, "merged [rgb|feat] rows"),)
        _check(tabs[0][2], f32, (C,), "merged scale")
        tabs = (tabs[0], (None, None, None))
    elif len(tabs) == 2:
        rows = (_row_type(tabs[0][0], P, 4 * CS, "source rgb rows"),
                _row_type(tabs[1][0], P, 4 * CF, "feature rows", packed_width=2 * CF))
        _check(tabs[0][2], f32, (CS,), "source rgb scale")
        _check(tabs[1][2], f32, (CF,), "feature scale")
    else:
        raise NotImplementedError("point-stage kernel takes 1 or 2 projection tables")
    for _, w4, _ in tabs:
        if w4 is not None:
            _check(w4, f32, (V, 4, P), "tap weights")
    if feats is None:
        if len(geom_tabs) != 2:
            raise NotImplementedError(
                "point-stage kernel takes 2 geometry tables or a (P, F) feature input")
        (g0, gw0, gs0), (g1, gw1, gs1) = geom_tabs
        _check(g0, u8, (P, 8 * C0), "level-1 octet rows")
        _check(gw0, f32, (8, P), "level-1 octet weights")
        _check(gs0, f32, (C0,), "level-1 scale")
        _check(g1, i8, (P, C1), "coarse nearest rows")
        _check(gw1, f32, (1, P), "coarse nearest weight")
        _check(gs1, f32, (C1,), "coarse scale")
        geom = (g0, gw0, gs0, g1, gw1, gs1, None)
    else:
        if geom_tabs or occ_geom:
            raise ValueError("point-stage kernel: a feature input excludes "
                             "geometry tables and occ_geom")
        _check(feats, f32, (P, C0 + C1), "geometry features")
        geom = (None,) * 6 + (feats,)
    _check(vmask, f32, (V, P), "vmask")
    _check(sig_ok, u8, (P,), "sig_ok")
    form = (rows, feats is not None, bool(occ_geom))
    lib = load_library(form)
    flat = weights.flat
    _check(flat, u8, (lib.point_stages_wbuf_bytes(),), "packed weights")
    dev = tabs[0][0].device
    alpha = torch.empty(P, dtype=f32, device=dev)
    rgb = torch.empty(P, 3, dtype=f32, device=dev)
    occm = torch.empty(P, dtype=f32, device=dev) if occ_geom else None
    tensors = (*tabs[0], *tabs[1], *geom, vmask, sig_ok, flat, alpha, rgb, occm)
    if any(t is not None and t.device != dev for t in tensors):
        raise ValueError("point-stage kernel: inputs on different devices")
    err = lib.point_stages_launch(
        *(None if t is None else t.data_ptr() for t in tensors), P,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"point-stage kernel launch failed: CUDA error {err}")
    LAUNCHES[FORMS[form]] += 1
    return (alpha, rgb, occm) if occ_geom else (alpha, rgb)


def fused_point_stages_tabs(tabs, feats, vmask, sig_ok, weights: PointWeights, *,
                            geom_tabs=(), occ_geom=False):
    """Point stages on the device the inputs live on: the plain torch
    version for CPU tensors, the CUDA kernel for CUDA tensors. Same
    arguments and returns as `point_stages_tabs_plain` (sig_ok as uint8/bool)."""
    dev = tabs[0][0].device
    if dev.type == "cpu":
        return point_stages_tabs_plain(tabs, feats, vmask, sig_ok, weights,
                                       geom_tabs=geom_tabs, occ_geom=occ_geom)
    if dev.type != "cuda":
        raise ValueError(f"point stages: unsupported device {dev}")
    return _launch(tabs, feats, vmask, sig_ok.to(torch.uint8), weights,
                   tuple(geom_tabs), occ_geom)


def fused_point_stages(rows, w4, pscale, geom_tabs, vmask, sig_ok,
                       weights: PointWeights):
    """The one-table form: merged [rgb|feat] rows and geometry tables."""
    return fused_point_stages_tabs(((rows, w4, pscale),), None, vmask, sig_ok,
                                   weights, geom_tabs=geom_tabs)
