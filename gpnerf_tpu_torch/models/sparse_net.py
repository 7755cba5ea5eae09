"""The 4-level sparse 3D CNN over the SMPL voxel grid
(gpnerf_tpu/models/sparse_net.py; reference SparseConvNet.py:90-143).

Layer stack (the reference's `net` ModuleList, whose indices the parameter
names keep): net.0 = double_conv at the input level, then per level i
net.{2i+1} = stride conv (k3 s2) and net.{2i+2} = double_conv. Each conv is
SubM/SparseConv3d (bias-free) + BatchNorm1d(eps 1e-3, running statistics)
+ ReLU, run through the host rulebooks (ops/sparse_conv.py). Per-level
features are taken after each level's double_conv.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from gpnerf_tpu_torch.models.layers import MaskedBatchNorm
from gpnerf_tpu_torch.ops.grid_sample import (
    NearestTable,
    nearest_rows,
    trilinear_dense_rows,
    trilinear_octet_rows,
)
from gpnerf_tpu_torch.ops.sparse_conv import (
    SparseLevel,
    scatter_channel_sum,
    stride_conv_tbl,
    subm_conv_tbl,
    trilinear_sparse_rows,
)


class SparseConvWeight(nn.Module):
    """A spconv conv's weight in the reference layout (kD, kH, kW, Cin,
    Cout); `taps` reads it as (27, Cin, Cout)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(3, 3, 3, cin, cout))

    def taps(self):
        return self.weight.reshape(27, *self.weight.shape[3:])


class _DoubleConv(nn.Sequential):
    def __init__(self, cin, cout):
        super().__init__(
            SparseConvWeight(cin, cout), MaskedBatchNorm(cout), nn.ReLU(),
            SparseConvWeight(cout, cout), MaskedBatchNorm(cout), nn.ReLU(),
        )

    def run(self, x, level, compute_dtype, train=False):
        for conv, bn in ((self[0], self[1]), (self[3], self[4])):
            x = subm_conv_tbl(x, level, conv.taps(), compute_dtype=compute_dtype)
            x = F.relu(bn(x, level.valid, train=train))
        return x


class _StrideConv(nn.Sequential):
    def __init__(self, cin, cout):
        super().__init__(SparseConvWeight(cin, cout), MaskedBatchNorm(cout), nn.ReLU())

    def run(self, x, level, compute_dtype, train=False):
        x = stride_conv_tbl(x, level, self[0].taps(), compute_dtype=compute_dtype)
        return F.relu(self[1](x, level.valid, train=train))


class SparseConvNet(nn.Module):
    def __init__(self, in_dim=32, n_layers=4, out_dim=(32, 32, 32, 32),
                 compute_dtype=None):
        super().__init__()
        self.n_layers = n_layers
        self.compute_dtype = compute_dtype
        mods = [_DoubleConv(in_dim, in_dim)]
        cin = in_dim
        for i in range(n_layers):
            mods += [_StrideConv(cin, out_dim[i]), _DoubleConv(out_dim[i], out_dim[i])]
            cin = out_dim[i]
        self.net = nn.ModuleList(mods)

    def features(self, code, levels: List[SparseLevel], *, train=False):
        """Run the conv stack on code (CAP0, in_dim); returns per-level
        feature matrices [(CAP_i, out_dim[i-1]) for levels 1..n_layers].
        `train`: each BatchNorm takes its statistics over the level's valid
        rows and updates its running estimates."""
        dt = self.compute_dtype
        x = self.net[0].run(code, levels[0], dt, train)
        level_feats = []
        for i in range(self.n_layers):
            x = self.net[2 * i + 1].run(x, levels[i + 1], dt, train)
            x = self.net[2 * i + 2].run(x, levels[i + 1], dt, train)
            level_feats.append(x)
        return level_feats

    def _level_positions(self, dhw_vox, out_sh):
        """(level, voxel positions, valid size) of each queried level:
        level i+1 spans out_sh // 2^(i+1) voxels. out_sh (3,) int tensor."""
        frac = dhw_vox / out_sh.to(dhw_vox.dtype)
        for i in range(self.n_layers):
            size = out_sh // (2 ** (i + 1))
            yield i, frac * (size - 1).to(dhw_vox.dtype), size

    def query_sparse(self, level_feats, index_vols, shapes, dhw_vox, out_sh):
        """Multi-scale trilinear query of the level rows through per-level
        index volumes (the training path: gradients stay on the sparse
        rows). Returns (P, sum(out_dim))."""
        return torch.cat([
            trilinear_sparse_rows(level_feats[i], index_vols[i], shapes[i], pos, dyn_size=size)
            for i, pos, size in self._level_positions(dhw_vox, out_sh)], dim=-1)

    def query_dense(self, dense_vols, dhw_vox, out_sh):
        """The multi-scale query against dense per-level (D, H, W, C)
        volumes (render/base.materialize_dense). Returns (P, sum(out_dim))."""
        return torch.cat([
            trilinear_dense_rows(dense_vols[i], pos, dyn_size=size)
            for i, pos, size in self._level_positions(dhw_vox, out_sh)], dim=-1)

    @staticmethod
    def query_octet2(octet_l1, octet_coarse, dhw_vox, out_sh, scales=None,
                     out_dtype=None):
        """Two-table multi-scale query: the level-1 octet table plus the
        merged coarse table (octet or nearest). out_sh (3,) int tensor;
        `out_dtype` as in ops/grid_sample.bilinear_quad_nhwc."""
        frac = dhw_vox / out_sh.float()
        outs = []
        for i, tab in enumerate((octet_l1, octet_coarse)):
            if isinstance(tab, NearestTable):
                size = out_sh // tab.div
                fn = nearest_rows
            else:
                size = out_sh // (2 ** (i + 1))
                fn = trilinear_octet_rows
            pos = frac * (size - 1).float()
            outs.append(fn(tab, pos, size, None if scales is None else scales[i], out_dtype))
        return torch.cat(outs, dim=-1)


def occupancy_volume(level_feats, grids: List[SparseLevel], *, levels=None):
    """The demo renderer's `masks3d`: per-level channel sums,
    nearest-upsampled to level-1 resolution and summed (all levels by
    default, the reference semantics). Returns (D1, H1, W1) float32."""
    total = level_feats[0].new_zeros(grids[1].shape)
    use = range(len(level_feats)) if levels is None else levels
    for i in use:
        vol = scatter_channel_sum(level_feats[i], grids[i + 1])
        for _ in range(i):
            vol = vol.repeat_interleave(2, 0).repeat_interleave(2, 1).repeat_interleave(2, 2)
        total = total + vol
    return total
