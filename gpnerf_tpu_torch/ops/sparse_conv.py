"""Sparse 3D convolution over host-built rulebooks
(gpnerf_tpu/ops/sparse_conv.py, the spconv equivalent).

A level is a padded (CAP, 3) coord list + (CAP,) validity mask plus the
neighbor tables data/sparse_host.py builds with the batch: `nbr` (CAP, 27)
same-level row ids for the submanifold conv, `down` (CAP, 27) parent-level
row ids at 2*o + offset for the strided conv (-1 = absent). A conv is one
row gather of the 27 neighbor rows and one matmul against the weight
reshaped to (27*Cin, Cout).

Weight layout: the reference spconv (kD, kH, kW, Cin, Cout) tensor read as
(27, Cin, Cout), tap k = ((kd*3)+kh)*3+kw at offset (kd-1, kh-1, kw-1).

Scatters into dense volumes write through one spare row that absorbs the
invalid rows (JAX's `mode="drop"`); level coords are unique among valid
rows (host pyramid dedup), so every real target is written once.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from gpnerf_tpu_torch.models.layers import rounded


class SparseLevel(NamedTuple):
    """coords (CAP, 3) int64 dhw (padding rows hold the level shape);
    valid (CAP,) bool; nbr (CAP, 27) int64; down (CAP, 27) int64 or None at
    level 0; shape static (D, H, W)."""

    coords: torch.Tensor
    valid: torch.Tensor
    nbr: torch.Tensor
    down: object
    shape: Tuple[int, int, int]


def _conv_gather_mm(feats, idx, valid, weight, compute_dtype):
    """feats (N, Cin); idx (CAP, 27) row ids (-1 absent); weight
    (27, Cin, Cout) -> (CAP, Cout) float32, zeroed off-valid. With a
    compute dtype the gathered rows and the weight are rounded to it and
    the product accumulates in float32 (the JAX einsum's
    preferred_element_type)."""
    feats = rounded(feats, compute_dtype)
    weight = rounded(weight, compute_dtype)
    n, cin = feats.shape
    featsz = torch.cat([feats, feats.new_zeros(1, cin)], dim=0)
    g = featsz[torch.where(idx >= 0, idx, n)]  # (CAP, 27, Cin)
    out = g.reshape(g.shape[0], -1) @ weight.reshape(-1, weight.shape[-1])
    return torch.where(valid[:, None], out, 0.0)


def subm_conv_tbl(feats, level: SparseLevel, weight, *, compute_dtype=None):
    """Submanifold 3x3x3 conv through the level's neighbor table."""
    return _conv_gather_mm(feats, level.nbr, level.valid, weight, compute_dtype)


def stride_conv_tbl(feats_in, level: SparseLevel, weight, *, compute_dtype=None):
    """Strided sparse conv k=3 s=2 p=1 through `level.down`."""
    return _conv_gather_mm(
        feats_in, level.down, level.valid, weight, compute_dtype
    )


def _flat_targets(level: SparseLevel):
    D, H, W = level.shape
    c = level.coords
    flat = (c[:, 0] * H + c[:, 1]) * W + c[:, 2]
    return torch.where(level.valid, flat, D * H * W)


def scatter_dense_rows(feats, level: SparseLevel):
    """Flat (D*H*W, C) dense rows of a level, zero at inactive sites."""
    D, H, W = level.shape
    out = feats.new_zeros(D * H * W + 1, feats.shape[-1])
    out[_flat_targets(level)] = torch.where(level.valid[:, None], feats, 0)
    return out[:-1]


def scatter_dense(feats, level: SparseLevel):
    """Dense (D, H, W, C) feature volume, zero at inactive sites."""
    return scatter_dense_rows(feats, level).reshape(
        tuple(level.shape) + (feats.shape[-1],)
    )


def scatter_channel_sum(feats, level: SparseLevel):
    """Dense (D, H, W) per-voxel channel-sum volume (the occupancy
    ingredient, reference SparseConvNet.py:131-137)."""
    D, H, W = level.shape
    out = feats.new_zeros(D * H * W + 1)
    out[_flat_targets(level)] = torch.where(level.valid, feats.sum(dim=-1), 0)
    return out[:-1].reshape(D, H, W)
