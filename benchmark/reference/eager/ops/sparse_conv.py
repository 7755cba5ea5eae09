# Frozen copy of gpnerf_tpu_torch/ops/sparse_conv.py at commit ffa1347, the benchmark's plain
# reference: the port's hand-written kernels, registries and the paths no
# configuration of the benchmark runs are removed; nothing here is imported
# from the program.
"""Sparse 3D convolution over host-built rulebooks
(gpnerf_tpu/ops/sparse_conv.py, the spconv equivalent).

A level is a padded (CAP, 3) coord list + (CAP,) validity mask plus the
neighbor tables data/sparse_host.py builds with the batch: `nbr` (CAP, 27)
same-level row ids for the submanifold conv, `down` (CAP, 27) parent-level
row ids at 2*o + offset for the strided conv (-1 = absent). A conv is one
row gather of the 27 neighbor rows (`_gather_rows`) and one matmul against
the weight reshaped to (27*Cin, Cout).

Weight layout: the reference spconv (kD, kH, kW, Cin, Cout) tensor read as
(27, Cin, Cout), tap k = ((kd*3)+kh)*3+kw at offset (kd-1, kh-1, kw-1).

Scatters into dense volumes write through one spare row that absorbs the
invalid rows (JAX's `mode="drop"`); level coords are unique among valid
rows (host pyramid dedup), so every real target is written once.

The training renderer queries the sparse rows directly: an index volume
(voxel -> row id) per level and a trilinear gather of the 8 corner rows
(`trilinear_sparse_rows`), so gradients reach the (CAP, C) level features
without a dense volume. The gathers' backward is an index_add, which on
CUDA accumulates with atomics and is not bit-reproducible.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Tuple

import torch

from benchmark.reference.eager.models.layers import cast


class SparseLevel(NamedTuple):
    """coords (CAP, 3) int64 dhw (padding rows hold the level shape);
    valid (CAP,) bool; nbr (CAP, 27) int64; down (CAP, 27) int64 or None at
    level 0; shape static (D, H, W)."""

    coords: torch.Tensor
    valid: torch.Tensor
    nbr: torch.Tensor
    down: object
    shape: Tuple[int, int, int]


def _gather_rows(feats, idx):
    """feats (N, C) rows at idx (any shape), a zero row where idx < 0.

    One `index_select`, whose backward is an `index_add` (atomics on
    CUDA). The absent entries read spread rows (their position mod N)
    under a zero mask, so they add nothing and pile no work on one row: the
    sort-based backward of advanced indexing serializes each row's
    duplicates, and one shared padding row took 0.7 s of a 0.8 s train
    step on the H100."""
    flat = idx.reshape(-1)
    spread = torch.arange(flat.numel(), device=idx.device) % feats.shape[0]
    rows = feats.index_select(0, torch.where(flat >= 0, flat, spread))
    rows = rows.reshape(*idx.shape, feats.shape[-1])
    return torch.where((idx >= 0)[..., None], rows, 0.0)


def _conv_gather_mm(feats, idx, valid, weight, compute_dtype):
    """feats (N, Cin); idx (CAP, 27) row ids (-1 absent); weight
    (27, Cin, Cout) -> (CAP, Cout) float32, zeroed off-valid. With a
    compute dtype the rows and the weight are cast to it before the gather
    (the gather moves half the bytes), and the product of the bf16 operands
    accumulates and returns in float32, as the JAX einsum's
    preferred_element_type does: on the card through cuBLAS's bf16 product
    with a float32 result (`torch.mm(..., out_dtype=)`), which has no
    autograd formula and no CPU kernel, so on the CPU and under autograd
    the operands are widened instead (their products are exact in
    float32)."""
    feats = cast(feats, compute_dtype)
    weight = cast(weight, compute_dtype)
    g = _gather_rows(feats, idx)  # (CAP, 27, Cin)
    a, w = g.reshape(g.shape[0], -1), weight.reshape(-1, weight.shape[-1])
    out = a.float() @ w.float()
    return torch.where(valid[:, None], out, 0.0)


def subm_conv_tbl(feats, level: SparseLevel, weight, *, compute_dtype=None):
    """Submanifold 3x3x3 conv through the level's neighbor table."""
    return _conv_gather_mm(feats, level.nbr, level.valid, weight, compute_dtype)


def stride_conv_tbl(feats_in, level: SparseLevel, weight, *, compute_dtype=None):
    """Strided sparse conv k=3 s=2 p=1 through `level.down`."""
    return _conv_gather_mm(feats_in, level.down, level.valid, weight, compute_dtype)


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


def build_index_volume(coords, valid, shape):
    """Dense voxel -> row-id volume (D, H, W) int64, -1 where empty, for a
    level's valid rows (unique coords; invalid rows are dropped)."""
    D, H, W = shape
    flat = (coords[:, 0] * H + coords[:, 1]) * W + coords[:, 2]
    tgt = torch.where(valid, flat, D * H * W)
    vol = torch.full((D * H * W + 1,), -1, dtype=torch.long, device=coords.device)
    vol[tgt] = torch.arange(coords.shape[0], device=coords.device)
    return vol[:-1].reshape(D, H, W)


def _lookup(index_vol, coords, shape):
    """Index-volume lookup of integer coords (..., 3); out of bounds -> -1."""
    D, H, W = shape
    c0, c1, c2 = coords.unbind(-1)
    inb = (c0 >= 0) & (c0 < D) & (c1 >= 0) & (c1 < H) & (c2 >= 0) & (c2 < W)
    idx = index_vol[c0.clamp(0, D - 1), c1.clamp(0, H - 1), c2.clamp(0, W - 1)]
    return torch.where(inb, idx, -1)


def trilinear_sparse_rows(feats, index_vol, shape, pos, dyn_size=None):
    """Trilinear query of a level's rows through its index volume at voxel
    positions pos (P, 3), zeros outside the active set and outside
    `dyn_size` ((3,) int tensor, default the static shape): the reference's
    `.dense()` + grid_sample(align_corners=True, zeros padding)."""
    d0 = torch.floor(pos)
    w1 = pos - d0
    w0 = 1.0 - w1
    base = d0.long()
    size = (torch.tensor(shape, device=pos.device) if dyn_size is None
            else dyn_size.long())
    out = 0.0
    for sel in itertools.product((0, 1), repeat=3):
        corner = torch.stack([base[:, a] + sel[a] for a in range(3)], dim=-1)
        inb = ((corner >= 0) & (corner < size)).all(dim=-1)
        idx = torch.where(inb, _lookup(index_vol, corner, shape), -1)
        w = ((w1[:, 0] if sel[0] else w0[:, 0])
             * (w1[:, 1] if sel[1] else w0[:, 1])
             * (w1[:, 2] if sel[2] else w0[:, 2]))
        out = out + _gather_rows(feats, idx) * w[:, None]
    return out
