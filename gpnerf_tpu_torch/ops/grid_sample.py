"""Gather tables and samplers of the progressive renderer, and the dense
trilinear query of the training renderer's dense context (the subset of
gpnerf_tpu/ops/grid_sample.py the port runs).

Semantics are torch `F.grid_sample(align_corners=True, padding_mode=
'zeros')`, reached through packed tables: a quad table row holds the 4 taps
of a bilinear footprint, an octet row the 8 corners of a trilinear cell, so
one row gather serves one sample. Quantized tables store per-channel
symmetric int8/uint8 codes; dequantization is applied after the weighted
sum (interpolation is linear, the per-channel factor commutes out).

Index arithmetic runs in the same float32 expressions as the JAX package,
so given the same float input the tables and gathered rows agree bitwise.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gpnerf_tpu_torch.models.layers import cast, rounded


def _unnormalize(coord, size):
    """align_corners=True: [-1, 1] -> [0, size-1]."""
    return (coord + 1.0) * 0.5 * (size - 1)


def grid_sample_2d_nhwc(img, grid):
    """Bilinear sample of img (N, H, W, C) at normalized grid (N, P, 2)
    (x indexes W, y indexes H); zeros outside. Returns (N, P, C)."""
    N, H, W, C = img.shape
    x = _unnormalize(grid[..., 0], W)
    y = _unnormalize(grid[..., 1], H)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1 = x0 + 1.0
    y1 = y0 + 1.0
    wx1 = x - x0
    wy1 = y - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    img_flat = img.reshape(N, H * W, C)

    def tap(xi, yi, wxi, wyi):
        inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        xc = xi.clamp(0, W - 1).long()
        yc = yi.clamp(0, H - 1).long()
        vals = torch.gather(
            img_flat, 1, (yc * W + xc)[..., None].expand(-1, -1, C)
        )
        return vals.float() * ((wxi * wyi) * inb.float())[..., None]

    return (
        tap(x0, y0, wx0, wy0)
        + tap(x1, y0, wx1, wy0)
        + tap(x0, y1, wx0, wy1)
        + tap(x1, y1, wx1, wy1)
    )


def build_quad_table_2d(img):
    """img (..., H, W, C) -> (..., H+1, W+1, 4C): row [y+1, x+1] packs
    [img[y,x], img[y,x+1], img[y+1,x], img[y+1,x+1]] (zeros outside). Any
    dtype: float fields, int8/int4-packed codes, raw uint8 pixels."""
    p = F.pad(img, (0, 0, 1, 1, 1, 1))
    return torch.cat(
        [p[..., :-1, :-1, :], p[..., :-1, 1:, :], p[..., 1:, :-1, :],
         p[..., 1:, 1:, :]],
        dim=-1,
    )


def _quad_base(grid, h, w):
    """Bilinear footprint of normalized `grid` (..., 2) on an (h, w) image:
    fractional offsets (wx1, wy1), integer base (xi, yi) and the quad-table
    row index of the base clipped into the table's [-1, size-1] coverage
    (a sample a cell or more outside has zero weight on every tap)."""
    x = _unnormalize(grid[..., 0], w)
    y = _unnormalize(grid[..., 1], h)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    xi = x0.long()
    yi = y0.long()
    idx = (yi.clamp(-1, h - 1) + 1) * (w + 1) + xi.clamp(-1, w - 1) + 1
    return x - x0, y - y0, xi, yi, idx


def _quad_tap_weights(wx1, wy1, xi, yi, h, w, dtype=None):
    """The 4 bilinear tap weights in quad-table order with the in-bounds
    masks folded in, each product rounded to `dtype`."""
    wx1 = rounded(wx1, dtype)
    wy1 = rounded(wy1, dtype)
    wx0 = rounded(1.0 - wx1, dtype)
    wy0 = rounded(1.0 - wy1, dtype)

    def tapw(xi_, yi_, wgt):
        inb = (xi_ >= 0) & (xi_ <= w - 1) & (yi_ >= 0) & (yi_ <= h - 1)
        return rounded(wgt, dtype) * inb.float()

    return [
        tapw(xi, yi, wx0 * wy0),
        tapw(xi + 1, yi, wx1 * wy0),
        tapw(xi, yi + 1, wx0 * wy1),
        tapw(xi + 1, yi + 1, wx1 * wy1),
    ]


def lerp_dtype(table, out_dtype=None):
    """The dtype a quad-table sample rounds to: `out_dtype` when given, else
    a bfloat16 table's own dtype (the JAX samplers compute in the table's
    float dtype), else None (float32: integer codes and float32 fields)."""
    if out_dtype is not None:
        return out_dtype
    return table.dtype if table.dtype == torch.bfloat16 else None


def _quad_weighted_sum(rows, taps, scale, dtype):
    """sum_k rows[..., kC:(k+1)C] * taps[k] in tap order, then the dequant
    factor; every product and partial sum is rounded to `dtype` (None:
    float32), as arithmetic carried out in that dtype rounds them, and the
    result is a tensor of `dtype`."""
    C = rows.shape[-1] // 4
    out = None
    for k, t in enumerate(taps):
        term = rounded(rounded(rows[..., k * C:(k + 1) * C].float(), dtype) * t[..., None], dtype)
        out = term if out is None else rounded(out + term, dtype)
    if scale is not None:
        out = rounded(out * rounded(scale.float(), dtype), dtype)
    return cast(out, dtype)


def bilinear_quad_nhwc(table, grid, h, w, scale=None, out_dtype=None):
    """`grid_sample_2d_nhwc` semantics through a quad table: table (N, H+1,
    W+1, 4C), grid (N, P, 2) normalized -> (N, P, C). `scale`: per-channel
    dequantization factors of a quantized table, applied after the weighted
    sum. `out_dtype` (e.g. torch.bfloat16; default `lerp_dtype(table)`):
    the weights, products and sums are rounded to it, reproducing arithmetic
    carried out in that dtype, and the result is a tensor of it (float32
    without one)."""
    N, C4 = table.shape[0], table.shape[-1]
    dt = lerp_dtype(table, out_dtype)
    wx1, wy1, xi, yi, idx = _quad_base(grid, h, w)
    flat = table.reshape(N, (h + 1) * (w + 1), C4)
    rows = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C4))
    taps = _quad_tap_weights(wx1, wy1, xi, yi, h, w, dt)
    return _quad_weighted_sum(rows, taps, scale, dt)


def bilinear_quad_nhwc_pv(table, grid, h, w, scale=None, out_dtype=None):
    """`bilinear_quad_nhwc` with the gather emitted in (P, V) row order from
    the view-concatenated flat table: table (V, H+1, W+1, 4C), grid (V, P, 2)
    -> (P, V, C), no transpose of the result."""
    V, C4 = table.shape[0], table.shape[-1]
    dt = lerp_dtype(table, out_dtype)
    wx1, wy1, xi, yi, idx = _quad_base(grid, h, w)
    stride = (h + 1) * (w + 1)
    voff = torch.arange(V, device=grid.device)[:, None] * stride
    rows = table.reshape(V * stride, C4)[(idx + voff).T]  # (P, V, 4C)
    taps = _quad_tap_weights(wx1.T, wy1.T, xi.T, yi.T, h, w, dt)
    return _quad_weighted_sum(rows, taps, scale, dt)


def quad_rows_and_weights(table, grid, *, batched=False):
    """Gather half of a quad-table sample: the raw rows (V*P, 4C) in
    view-major order and the float32 tap weights (V, 4, P) with the
    in-bounds masks folded in. table (V, Ht+1, Wt+1, 4C), grid (V, P, 2)
    normalized. `batched` gathers view by view from the per-view table
    instead of once from the flat (V*rows) table; both return the same rows."""
    V, C4 = table.shape[0], table.shape[-1]
    h, w = table.shape[1] - 1, table.shape[2] - 1
    wx1, wy1, xi, yi, idx = _quad_base(grid, h, w)
    stride = (h + 1) * (w + 1)
    if batched:
        tab = table.reshape(V, stride, C4)
        rows = torch.cat([tab[v][idx[v]] for v in range(V)])
    else:
        voff = torch.arange(V, device=grid.device)[:, None] * stride
        rows = table.reshape(V * stride, C4)[(idx + voff).reshape(-1)]
    return rows, torch.stack(_quad_tap_weights(wx1, wy1, xi, yi, h, w), dim=1)


def bilinear_quad_nhwc_pv_kernel(table, grid, h, w, scale=None, out_dtype=None):
    """`bilinear_quad_nhwc_pv` with the weighted sum and dequantization in
    the quad-lerp kernel (ops/quad_lerp.quad_lerp_rows_vcp; the JAX
    package's `bilinear_quad_nhwc_pv_pallas`): the rows are gathered in
    view-major order, the weights stay float32, the kernel accumulates in
    float32 and rounds once to `out_dtype` (default `lerp_dtype(table)`,
    float32 for integer tables), where the other two forms round every
    product and partial sum. Returns (P, V, C) of that dtype, a transposed
    view of the kernel's (V, C, P) output."""
    from gpnerf_tpu_torch.ops.quad_lerp import quad_lerp_rows_vcp

    if (h, w) != (table.shape[1] - 1, table.shape[2] - 1):
        raise ValueError(f"table {tuple(table.shape)} is no quad table of a ({h}, {w}) image")
    rows, w4 = quad_rows_and_weights(table, grid)
    C = table.shape[-1] // 4
    sc = torch.ones(C, device=grid.device) if scale is None else scale.float()
    out_vcp = quad_lerp_rows_vcp(rows, w4, sc.contiguous(),
                                 out_dtype=lerp_dtype(table, out_dtype) or torch.float32)
    return out_vcp.permute(2, 0, 1)


def build_octet_table_3d(vol):
    """vol (D, H, W, C) -> (D+1, H+1, W+1, 8C): row [z+1, y+1, x+1] packs
    the 8 corners of the cell at base (z, y, x), corner order (dz, dy, dx)
    in itertools.product((0, 1), repeat=3) order."""
    p = F.pad(vol, (0, 0, 1, 1, 1, 1, 1, 1))
    parts = [
        p[dz : p.shape[0] - 1 + dz, dy : p.shape[1] - 1 + dy,
          dx : p.shape[2] - 1 + dx]
        for dz, dy, dx in itertools.product((0, 1), repeat=3)
    ]
    return torch.cat(parts, dim=-1)


class FlatOctetTable(NamedTuple):
    """Octet table stored flat: rows (Dp*Hp*Wp + 1, 8C) with a trailing
    dump row (never gathered) and the 3D row-stride shape (Dp, Hp, Wp)."""

    rows: torch.Tensor
    shape: Tuple[int, int, int]


def build_octet_table_scatter(feats, coords, valid, shape, pack_words=False):
    """Corner-scatter octet build for a sparse level: site (a, b, c) lands
    at table row (a+1-dz, b+1-dy, c+1-dx) in corner block k = (dz, dy, dx).
    Each (row, block) pair has at most one writing site, so a plain
    indexed write equals the JAX scatter-add; invalid rows go to the dump
    row. feats (CAP, C) already zero at invalid rows. `pack_words`: uint8
    rows with C % 4 == 0 are written as 32-bit words (the JAX package's
    word scatter), which gives the same bytes."""
    CAP, C = feats.shape
    D, H, W = shape
    Dp, Hp, Wp = D + 1, H + 1, W + 1
    R = Dp * Hp * Wp
    packed = pack_words and feats.dtype == torch.uint8 and C % 4 == 0
    rows_in = feats.contiguous().view(torch.int32) if packed else feats
    table = rows_in.new_zeros(R + 1, 8, rows_in.shape[-1])
    for k, (dz, dy, dx) in enumerate(itertools.product((0, 1), repeat=3)):
        fl = ((coords[:, 0] + 1 - dz) * Hp + coords[:, 1] + 1 - dy) * Wp + (
            coords[:, 2] + 1 - dx
        )
        table[torch.where(valid, fl, R), k] = rows_in
    if packed:
        table = table.view(torch.uint8)
    return FlatOctetTable(table.reshape(R + 1, 8 * C), (Dp, Hp, Wp))


def build_octet_table_3d_u32(q):
    """`build_octet_table_3d` of a uint8 volume (D, H, W, C), C % 4 == 0,
    stored as packed 32-bit words, 4 channels to a word (little-endian, the
    JAX package's uint32 table): (D+1, H+1, W+1, 2C), held in an int32
    tensor (torch's uint32 lacks the ops the build needs); the bytes equal
    `build_octet_table_3d(q)`'s. `octet_rows_and_weights` and
    `trilinear_octet_rows` unpack gathered rows back to bytes."""
    return build_octet_table_3d(q.contiguous().view(torch.int32))


class Int4Table(NamedTuple):
    """Octet table of int4 split-packed channels: uint8 bytes whose low
    nibble is channel c and high nibble channel c + C/2
    (`build_octet_table_3d(quantize_volume_i4(vol)[0])`); sign-extended
    after the gather by `trilinear_octet_rows`."""

    table: torch.Tensor  # (D+1, H+1, W+1, 8 * C/2) uint8


class NearestTable(NamedTuple):
    """Flat per-voxel rows (D*H*W, C) sampled nearest-neighbor; `div` is
    the grid's divisor relative to the level-0 voxel extent (2 = the
    level-1 grid). `interleave` 2 marks a grid midpoint-doubled along each
    axis (`interleave_midpoints_3d`: a valid extent of s points becomes
    2s - 1); `lerp_axes` is a d/h/w bitmask (bit 0 = d) of axes sampled
    linearly instead of rounded (2^popcount row gathers per point)."""

    rows: torch.Tensor
    shape: Tuple[int, int, int]
    div: int = 4
    interleave: int = 1
    lerp_axes: int = 0


def interleave_midpoints_3d(vol):
    """Midpoint-double a (D, H, W, C) uint8 field along each spatial axis:
    (2D-1, 2H-1, 2W-1, C), even indices the original points, odd ones the
    rounded averages of their two neighbours ((a + b + 1) >> 1 in int16)."""
    for ax in range(3):
        n = vol.shape[ax]
        a = vol.narrow(ax, 0, n - 1)
        b = vol.narrow(ax, 1, n - 1)
        mid = ((a.to(torch.int16) + b.to(torch.int16) + 1) >> 1).to(torch.uint8)
        shape = list(vol.shape)
        shape[ax] = 2 * (n - 1)
        pairs = torch.stack([a, mid], dim=ax + 1).reshape(shape)
        vol = torch.cat([pairs, vol.narrow(ax, n - 1, 1)], dim=ax)
    return vol


def _axis_resample_matrix(n_out_max, n_in_max, n_out_dyn, n_in_dyn):
    """(n_out_max, n_in_max) align-corners interpolation matrix mapping
    output position j to j*(n_in_dyn-1)/(n_out_dyn-1); rows >= n_out_dyn
    are zero. Built in float32 numpy with the JAX expression order."""
    f32 = np.float32
    j = np.arange(n_out_max, dtype=f32)
    ratio = f32(n_in_dyn - 1) / max(f32(n_out_dyn - 1), f32(1.0))
    pos = j * ratio
    lo = np.clip(np.floor(pos).astype(np.int64), 0, n_in_max - 1)
    hi = np.minimum(lo + 1, n_in_dyn - 1)
    w1 = pos - lo.astype(f32)
    m = np.zeros((n_out_max, n_in_max), f32)
    rows = np.arange(n_out_max)
    np.add.at(m, (rows, lo), f32(1.0) - w1)
    np.add.at(m, (rows, np.clip(hi, 0, n_in_max - 1)), w1)
    return m * (j < f32(n_out_dyn))[:, None].astype(f32)


def resample_volume_to(vol, out_shape_max, size_out_dyn, size_in_dyn):
    """Trilinear-resample a (D, H, W, C) align-corners field onto a finer
    grid (out_shape_max buffer, size_out_dyn valid extent) by three
    separable interpolation matmuls. Sizes are host ints."""
    dev = vol.device
    mats = [
        torch.from_numpy(
            _axis_resample_matrix(o, i, int(so), int(si))
        ).to(dev)
        for o, i, so, si in zip(
            out_shape_max, vol.shape[:3], size_out_dyn, size_in_dyn
        )
    ]
    v = vol.float()
    v = torch.einsum("od,dhwc->ohwc", mats[0], v)
    v = torch.einsum("ph,ohwc->opwc", mats[1], v)
    return torch.einsum("qw,opwc->opqc", mats[2], v)


def upsample_image_align_corners(img, Ho, Wo):
    """Bilinear align-corners resample of (V, Hi, Wi, C) images to
    (V, Ho, Wo, C) by two separable interpolation matmuls."""
    _, Hi, Wi, _ = img.shape
    mh = torch.from_numpy(_axis_resample_matrix(Ho, Hi, Ho, Hi)).to(img.device)
    mw = torch.from_numpy(_axis_resample_matrix(Wo, Wi, Wo, Wi)).to(img.device)
    out = torch.einsum("oh,vhwc->vowc", mh, img.float())
    return torch.einsum("pw,vowc->vopc", mw, out)


def quantize_volume_u8(vol, eps=1e-8):
    """Per-channel uint8 quantization of a non-negative field. Returns
    (q uint8, scale (C,) float32)."""
    vmax = vol.reshape(-1, vol.shape[-1]).amax(dim=0).clamp_min(eps)
    scale = (vmax / 255.0).float()
    q = torch.round(vol / scale).clamp(0, 255).to(torch.uint8)
    return q, scale


def quantize_image_i8(img, eps=1e-8):
    """Per-channel symmetric int8 quantization of a signed field. Returns
    (q int8, scale (C,) float32)."""
    amax = img.reshape(-1, img.shape[-1]).abs().amax(dim=0).clamp_min(eps)
    scale = (amax / 127.0).float()
    q = torch.round(img / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def quantize_image_i4(img, eps=1e-8):
    """Per-channel symmetric int4 split-pack of a feature image: channel c
    quantizes to [-7, 7] and shares a byte with channel c + C/2 (low/high
    nibble, two's complement). Returns (packed (..., C/2) uint8, scale (C,)
    float32); unpack = sign-extended nibble * scale[c]."""
    C = img.shape[-1]
    if C % 2:
        raise ValueError(f"int4 split-pack needs an even channel count, got {C}")
    amax = img.reshape(-1, C).abs().amax(dim=0).clamp_min(eps)
    scale = (amax / 7.0).float()
    q = torch.round(img / scale).clamp(-7, 7).to(torch.int32)
    h = C // 2
    return ((q[..., :h] & 0xF) | ((q[..., h:] & 0xF) << 4)).to(torch.uint8), scale


def quantize_volume_i4(vol, eps=1e-8):
    """Per-channel symmetric int4 quantization of a signed field, split-
    packed two channels to a byte (low nibbles channels [0, C/2), high
    nibbles [C/2, C)). Returns (packed (..., C/2) uint8, scale (C,)
    float32)."""
    C = vol.shape[-1]
    amax = vol.reshape(-1, C).abs().amax(dim=0).clamp_min(eps)
    scale = (amax / 7.0).float()
    q = torch.round(vol / scale).clamp(-7, 7).to(torch.int32) & 0xF
    return (q[..., : C // 2] | (q[..., C // 2:] << 4)).to(torch.uint8), scale


def _octet_flat(table):
    """(flat rows, (Dp, Hp, Wp)) of an octet table: a FlatOctetTable, or a
    dense (Dp, Hp, Wp, 8C) one (`build_octet_table_3d`)."""
    if isinstance(table, FlatOctetTable):
        return table.rows, table.shape
    return table.reshape(-1, table.shape[-1]), tuple(table.shape[:3])


def octet_rows_and_weights(table, pos, size, dtype=None):
    """Raw octet rows (P, 8C) of the cells holding `pos` (P, 3) dhw voxel
    units, and the 8 trilinear corner weights (P, 8) with the zeros-outside
    mask of the dynamic extent `size` (3,) folded in. `table`: a
    FlatOctetTable or a dense 4-D octet table, in its own dtype (packed
    int32 words as they are). `dtype`: the weights and their products are
    rounded to it (None: float32)."""
    flat, (Dp, Hp, Wp) = _octet_flat(table)
    fl = torch.floor(pos)
    base = fl.long()
    w1 = rounded(pos - fl, dtype)
    w0 = rounded(1.0 - w1, dtype)
    hi = torch.tensor([Dp - 2, Hp - 2, Wp - 2], device=pos.device)
    bc = torch.clamp(base, min=-1) + 1
    bc = torch.minimum(bc, hi + 1)
    rows = flat[(bc[:, 0] * Hp + bc[:, 1]) * Wp + bc[:, 2]]
    ws = []
    for sel in itertools.product((0, 1), repeat=3):
        corner = base + torch.tensor(sel, device=pos.device)
        inb = ((corner >= 0) & (corner < size)).all(dim=-1)
        w = rounded(
            rounded((w1[:, 0] if sel[0] else w0[:, 0])
                    * (w1[:, 1] if sel[1] else w0[:, 1]), dtype)
            * (w1[:, 2] if sel[2] else w0[:, 2]), dtype)
        ws.append(w * inb.float())
    return rows, torch.stack(ws, dim=-1)


def nearest_row_and_weight(table: NearestTable, pos, size):
    """Nearest row (P, C) of `pos` and its zeros-outside weight (P, 1)."""
    D, H, W = table.shape
    c = torch.round(pos).long()
    inb = ((c >= 0) & (c < size)).all(dim=-1)
    lim = torch.tensor([D - 1, H - 1, W - 1], device=pos.device)
    cc = torch.minimum(c.clamp_min(0), lim)
    rows = table.rows[(cc[:, 0] * H + cc[:, 1]) * W + cc[:, 2]]
    return rows, inb.float()[:, None]


def lerp_rows(rows, w, scale=None, dtype=None):
    """Weighted sum of T packed taps: rows (P, T*C), w (P, T) -> (P, C),
    taps summed in order k = 0..T-1, then dequantized. `dtype`: the rows,
    every product and partial sum are rounded to it, and the result is a
    tensor of it (None: float32)."""
    T = w.shape[-1]
    C = rows.shape[-1] // T
    out = rounded(rounded(rows[:, :C].float(), dtype) * w[:, :1], dtype)
    for k in range(1, T):
        term = rounded(rounded(rows[:, k * C : (k + 1) * C].float(), dtype) * w[:, k : k + 1],
                       dtype)
        out = rounded(out + term, dtype)
    if scale is not None:
        out = rounded(out * rounded(scale, dtype), dtype)
    return cast(out, dtype)


def _unpack_i4(rows):
    """Split-packed int4 bytes (P, T*C/2) -> sign-extended values (P, T*C),
    each tap's low nibbles (channels [0, C/2)) then its high nibbles."""
    s32 = rows.to(torch.int32)
    lo, hi = s32 & 0xF, (s32 >> 4) & 0xF
    return lo - ((lo & 8) << 1), hi - ((hi & 8) << 1)


def trilinear_octet_rows(table, pos, size, scale=None, out_dtype=None):
    """Trilinear sample of an octet table (zeros padding): a FlatOctetTable,
    a dense 4-D table of any dtype, its packed-word form
    (`build_octet_table_3d_u32`, unpacked to bytes after the gather) or an
    Int4Table (nibbles sign-extended after the gather). Returns (P, C);
    `out_dtype` as in `bilinear_quad_nhwc`, by default float32, or a float
    table's own dtype when it has no dequant (as the JAX package computes
    in the table's dtype then)."""
    int4 = isinstance(table, Int4Table)
    tab = table.table if int4 else table
    flat, _ = _octet_flat(tab)
    packed = flat.dtype == torch.int32
    dt = out_dtype
    if dt is None and scale is None and not packed and flat.dtype == torch.bfloat16:
        dt = torch.bfloat16
    rows, w = octet_rows_and_weights(tab, pos, size, dt)
    if packed:
        rows = rows.contiguous().view(torch.uint8)
    if int4:
        lo, hi = _unpack_i4(rows)
        cb = rows.shape[-1] // 8
        rows = torch.cat([torch.cat([lo[:, k * cb:(k + 1) * cb], hi[:, k * cb:(k + 1) * cb]], dim=-1)
                          for k in range(8)], dim=-1)
    return lerp_rows(rows, w, scale, dt)


def nearest_rows(table, pos, size, scale=None, out_dtype=None):
    """Nearest sample of a NearestTable (zeros outside); the axes of
    `table.lerp_axes` are sampled linearly (floor and ceil corners, each
    masked zeros-outside). Returns (P, C); `out_dtype` as in
    `bilinear_quad_nhwc`."""
    if not table.lerp_axes:
        return lerp_rows(*nearest_row_and_weight(table, pos, size), scale, out_dtype)
    D, H, W = table.shape
    dt = out_dtype
    axes = [a for a in range(3) if (table.lerp_axes >> a) & 1]
    fl = torch.floor(pos)
    base = torch.round(pos).long()
    base[:, axes] = fl.long()[:, axes]
    frac = rounded(pos - fl, dt)
    lim = torch.tensor([D - 1, H - 1, W - 1], device=pos.device)
    out = None
    for combo in itertools.product((0, 1), repeat=len(axes)):
        c = base.clone()
        w = torch.ones(pos.shape[0], device=pos.device)
        for a, hi in zip(axes, combo):
            c[:, a] += hi
            w = rounded(w * (frac[:, a] if hi else rounded(1.0 - frac[:, a], dt)), dt)
        inb = ((c >= 0) & (c < size)).all(dim=-1)
        cc = torch.minimum(c.clamp_min(0), lim)
        rows = table.rows[(cc[:, 0] * H + cc[:, 1]) * W + cc[:, 2]]
        term = rounded(rounded(rows.float(), dt) * (w * inb.float())[:, None], dt)
        out = term if out is None else rounded(out + term, dt)
    if scale is not None:
        out = rounded(out * rounded(scale, dt), dt)
    return cast(out, dt)


def trilinear_dense_rows(vol, pos, dyn_size=None):
    """Trilinear sample of a dense (D, H, W, C) volume at voxel positions
    pos (P, 3), zeros outside `dyn_size` ((3,) int tensor, default the
    volume's shape). Returns (P, C)."""
    D, H, W, C = vol.shape
    size = (torch.tensor([D, H, W], device=pos.device) if dyn_size is None
            else dyn_size.long())
    d0 = torch.floor(pos)
    base = d0.long()
    w1 = (pos - d0).to(vol.dtype)
    w0 = 1.0 - w1
    flat = vol.reshape(-1, C)
    out = 0.0
    for sel in itertools.product((0, 1), repeat=3):
        corner = torch.stack([base[:, a] + sel[a] for a in range(3)], dim=-1)
        inb = ((corner >= 0) & (corner < size)).all(dim=-1)
        idx = ((corner[:, 0].clamp(0, D - 1) * H + corner[:, 1].clamp(0, H - 1)) * W
               + corner[:, 2].clamp(0, W - 1))
        w = ((w1[:, 0] if sel[0] else w0[:, 0])
             * (w1[:, 1] if sel[1] else w0[:, 1])
             * (w1[:, 2] if sel[2] else w0[:, 2]))
        out = out + flat[idx] * (w * inb.to(vol.dtype))[:, None]
    return out


def trilinear_dense_gather(vol, pos, dyn_size=None):
    """Trilinear sample of a dense scalar (D, H, W) volume at voxel
    positions pos (P, 3), zeros outside `dyn_size` ((3,) int tensor, the
    valid extent inside the volume; default its shape): the demo renderer's
    occupancy lookup (the reference's demo_render.py:274-279). Returns
    (P,)."""
    return trilinear_dense_rows(vol[..., None], pos, dyn_size)[:, 0]
