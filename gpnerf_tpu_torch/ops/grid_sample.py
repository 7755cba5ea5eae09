"""Gather tables and samplers of the progressive renderer (the subset of
gpnerf_tpu/ops/grid_sample.py its fast and reference-semantics modes run).

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


def build_octet_table_scatter(feats, coords, valid, shape):
    """Corner-scatter octet build for a sparse level: site (a, b, c) lands
    at table row (a+1-dz, b+1-dy, c+1-dx) in corner block k = (dz, dy, dx).
    Each (row, block) pair has at most one writing site, so a plain
    indexed write equals the JAX scatter-add; invalid rows go to the dump
    row. feats (CAP, C) already zero at invalid rows."""
    CAP, C = feats.shape
    D, H, W = shape
    Dp, Hp, Wp = D + 1, H + 1, W + 1
    R = Dp * Hp * Wp
    table = feats.new_zeros(R + 1, 8, C)
    for k, (dz, dy, dx) in enumerate(itertools.product((0, 1), repeat=3)):
        fl = ((coords[:, 0] + 1 - dz) * Hp + coords[:, 1] + 1 - dy) * Wp + (
            coords[:, 2] + 1 - dx
        )
        table[torch.where(valid, fl, R), k] = feats
    return FlatOctetTable(table.reshape(R + 1, 8 * C), (Dp, Hp, Wp))


class NearestTable(NamedTuple):
    """Flat per-voxel rows (D*H*W, C) sampled nearest-neighbor; `div` is
    the grid's divisor relative to the level-0 voxel extent (2 = the
    level-1 grid)."""

    rows: torch.Tensor
    shape: Tuple[int, int, int]
    div: int = 4


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


def octet_rows_and_weights(table: FlatOctetTable, pos, size):
    """Raw octet rows (P, 8C) of the cells holding `pos` (P, 3) dhw voxel
    units, and the 8 trilinear corner weights (P, 8) with the zeros-outside
    mask of the dynamic extent `size` (3,) folded in."""
    Dp, Hp, Wp = table.shape
    fl = torch.floor(pos)
    base = fl.long()
    w1 = pos - fl
    w0 = 1.0 - w1
    hi = torch.tensor([Dp - 2, Hp - 2, Wp - 2], device=pos.device)
    bc = torch.clamp(base, min=-1) + 1
    bc = torch.minimum(bc, hi + 1)
    rows = table.rows[(bc[:, 0] * Hp + bc[:, 1]) * Wp + bc[:, 2]]
    ws = []
    for sel in itertools.product((0, 1), repeat=3):
        corner = base + torch.tensor(sel, device=pos.device)
        inb = ((corner >= 0) & (corner < size)).all(dim=-1)
        w = (
            (w1[:, 0] if sel[0] else w0[:, 0])
            * (w1[:, 1] if sel[1] else w0[:, 1])
            * (w1[:, 2] if sel[2] else w0[:, 2])
        )
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


def lerp_rows(rows, w, scale=None):
    """Weighted sum of T packed taps: rows (P, T*C), w (P, T) -> (P, C)
    float32, taps summed in order k = 0..T-1, then dequantized."""
    T = w.shape[-1]
    C = rows.shape[-1] // T
    out = rows[:, :C].float() * w[:, :1]
    for k in range(1, T):
        out = out + rows[:, k * C : (k + 1) * C].float() * w[:, k : k + 1]
    if scale is not None:
        out = out * scale
    return out


def trilinear_octet_rows(table, pos, size, scale=None):
    """Trilinear sample of an octet table (zeros padding). Returns (P, C)."""
    return lerp_rows(*octet_rows_and_weights(table, pos, size), scale)


def nearest_rows(table, pos, size, scale=None):
    """Nearest sample of a NearestTable (zeros outside). Returns (P, C)."""
    return lerp_rows(*nearest_row_and_weight(table, pos, size), scale)
