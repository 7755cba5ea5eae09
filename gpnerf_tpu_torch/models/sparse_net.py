"""The 4-level sparse 3D CNN over the SMPL voxel grid
(gpnerf_tpu/models/sparse_net.py; reference SparseConvNet.py:90-143).

Layer stack (the reference's `net` ModuleList, whose indices the parameter
names keep): net.0 = the submanifold convs at the input level, then per
level i net.{2i+1} = stride conv (k3 s2) and net.{2i+2} = the level's
submanifold convs. Each conv is SubM/SparseConv3d (bias-free) +
BatchNorm1d(eps 1e-3, running statistics) + ReLU, run through the host
rulebooks (ops/sparse_conv.py); conv k of a block is `net.{b}.{3k}` and its
BatchNorm `net.{b}.{3k+1}`. GP-NeRF runs two convs at every level (its
double_conv); Neural Body (models/neural_body.py) three at levels 2-4
(`convs`). Per-level features are taken after each level's convs.

`sparse_net_dense_eval` is the eval-only dense-convolution form of the same
stack (the renderer's `dense_conv`): each level's convs run as dense 3D
convolutions over the zero-filled level volume, re-masked to the active
set, with the running-statistics BatchNorm as an affine map.
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
from gpnerf_tpu_torch.models.layers import cast
from gpnerf_tpu_torch.ops.sparse_conv import (
    SparseLevel,
    scatter_channel_sum,
    scatter_dense,
    stride_conv_tbl,
    subm_conv_tbl,
    trilinear_sparse_rows,
)


class SparseConvWeight(nn.Module):
    """A spconv conv's weight in the reference layout (kD, kH, kW, Cin,
    Cout); `taps` reads it as (27, Cin, Cout).

    A state dict may carry either spconv layout, sniffed by shape as the JAX
    package's checkpoint reader does (gpnerf_tpu/train/torch_interop.py
    `_from_torch`): 1.2.1's (kD, kH, kW, Cin, Cout) loads as it is,
    2.x's (Cout, Cin, kD, kH, kW) is permuted into it; any other shape is
    left to `load_state_dict`'s size check. `state_dict` writes 1.2.1's."""

    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(3, 3, 3, cin, cout))

    def taps(self):
        return self.weight.reshape(27, *self.weight.shape[3:])

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        w = state_dict.get(prefix + "weight")
        if (isinstance(w, torch.Tensor) and w.dim() == 5 and tuple(w.shape[:3]) != (3, 3, 3)
                and tuple(w.shape[2:]) == (3, 3, 3)):
            state_dict[prefix + "weight"] = w.permute(2, 3, 4, 1, 0).contiguous()
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class _SubmConvs(nn.Sequential):
    """`n` submanifold convs of one level, cin -> cout then cout -> cout
    (the reference's double_conv at n = 2, Neural Body's triple_conv at 3)."""

    def __init__(self, cin, cout, n=2):
        mods = []
        for k in range(n):
            mods += [SparseConvWeight(cin if k == 0 else cout, cout), MaskedBatchNorm(cout),
                     nn.ReLU()]
        super().__init__(*mods)

    def pairs(self):
        """[(conv, BatchNorm)] in order."""
        return [(self[k], self[k + 1]) for k in range(0, len(self), 3)]

    def run(self, x, level, compute_dtype, train=False):
        for conv, bn in self.pairs():
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
    """`compute_dtype`: each conv's input and weight are cast to it before
    the row gather, the sums are float32 (ops/sparse_conv.py), the
    BatchNorms float32, so the level features are float32. `convs`: the
    submanifold convs at levels 0..n_layers (two at each by default)."""

    def __init__(self, in_dim=32, n_layers=4, out_dim=(32, 32, 32, 32),
                 compute_dtype=None, convs=None):
        super().__init__()
        self.n_layers = n_layers
        self.compute_dtype = compute_dtype
        convs = (2,) * (n_layers + 1) if convs is None else tuple(convs)
        mods = [_SubmConvs(in_dim, in_dim, convs[0])]
        cin = in_dim
        for i in range(n_layers):
            mods += [_StrideConv(cin, out_dim[i]),
                     _SubmConvs(out_dim[i], out_dim[i], convs[i + 1])]
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

    def query_octet(self, octet_vols, dhw_vox, out_sh, scales=None, out_dtype=None):
        """Multi-scale trilinear query through one octet table per level
        (FlatOctetTable, dense, packed-word or int4 tables). Returns (P,
        sum(out_dim)); `out_dtype` as in query_octet2."""
        return torch.cat([
            trilinear_octet_rows(octet_vols[i], pos, size,
                                 None if scales is None else scales[i], out_dtype)
            for i, pos, size in self._level_positions(dhw_vox, out_sh)], dim=-1)

    @staticmethod
    def query_octet2(octet_l1, octet_coarse, dhw_vox, out_sh, scales=None,
                     out_dtype=None):
        """Two-table multi-scale query: the level-1 table (octet, or
        nearest: flat, midpoint-interleaved or lerp-axes) plus the merged
        coarse table (octet, int4 or nearest). out_sh (3,) int tensor;
        `out_dtype` as in ops/grid_sample.bilinear_quad_nhwc."""
        frac = dhw_vox / out_sh.float()
        outs = []
        for i, tab in enumerate((octet_l1, octet_coarse)):
            if isinstance(tab, NearestTable):
                size = out_sh // tab.div
                if tab.interleave > 1:
                    # a midpoint-doubled grid: s valid points became 2s - 1
                    size = tab.interleave * (size - 1) + 1
                fn = nearest_rows
            else:
                size = out_sh // (2 ** (i + 1))
                fn = trilinear_octet_rows
            pos = frac * (size - 1).float()
            outs.append(fn(tab, pos, size, None if scales is None else scales[i], out_dtype))
        return torch.cat(outs, dim=-1)


def _bn_affine(x, bn):
    """Eval BatchNorm as the JAX package's dense stack writes it:
    (x - mean) * (1 / sqrt(var + eps)) * weight + bias, in float32."""
    inv = 1.0 / torch.sqrt(bn.running_var + bn.eps)
    return ((x.float() - bn.running_mean) * inv * bn.weight + bn.bias).to(x.dtype)


def _conv3d(vol, w27, stride, compute_dtype=None):
    """Dense 3x3x3 conv of a (D, H, W, Cin) volume with the sparse tap
    layout w27 (27, Cin, Cout) (tap k = (kd*3 + kh)*3 + kw at offset (kd-1,
    kh-1, kw-1)), padding 1: a correlation, as F.conv3d computes. Inputs are
    cast to `compute_dtype` and the result is float32, as JAX's
    preferred_element_type gives it: a bf16 convolution's sums are float32
    in cuDNN and on the CPU, but it returns them rounded, so the operands
    are widened (their products are exact in float32)."""
    k = w27.reshape(3, 3, 3, w27.shape[-2], w27.shape[-1]).permute(4, 3, 0, 1, 2)
    x = cast(vol, compute_dtype).float().permute(3, 0, 1, 2)[None]
    y = F.conv3d(x, cast(k, compute_dtype).float(), stride=stride, padding=1)
    return y[0].permute(1, 2, 3, 0)


def _dense_mask(level):
    """(D, H, W, 1) float32 mask of a level's active sites."""
    D, H, W = level.shape
    c = level.coords
    m = torch.zeros(D * H * W + 1, device=c.device)
    m[torch.where(level.valid, (c[:, 0] * H + c[:, 1]) * W + c[:, 2], D * H * W)] = 1.0
    return m[:-1].reshape(D, H, W, 1)


def sparse_net_dense_eval(net: SparseConvNet, code, levels, *, compute_dtype=None):
    """Eval-only dense-convolution form of `SparseConvNet.features`
    (gpnerf_tpu/models/sparse_net.py `sparse_net_dense_eval`): the input
    level's submanifold convs and the first strided conv run in rows form on the
    host rulebooks, then each level's convs run dense over the zero-filled
    level volume, re-masked to the active set (a submanifold conv is a dense
    conv whose output is kept at the active sites; inactive inputs add 0),
    each BatchNorm the running-statistics affine. `code`: (CAP0, in_dim)
    fused vertex codes at the level-0 rows. Returns the dense per-level
    volumes [(D_i, H_i, W_i, out_dim[i-1]) for levels 1..n_layers], zero at
    inactive sites."""
    x = code
    for conv, bn in net.net[0].pairs():
        x = subm_conv_tbl(x, levels[0], conv.taps(), compute_dtype=compute_dtype)
        x = F.relu(_bn_affine(x, bn))
    down0 = net.net[1]
    x = stride_conv_tbl(x, levels[1], down0[0].taps(), compute_dtype=compute_dtype)
    x = F.relu(_bn_affine(x, down0[1]))
    vol = scatter_dense(x, levels[1])
    vols = []
    for i in range(net.n_layers):
        mask = _dense_mask(levels[i + 1])
        if i > 0:
            down = net.net[2 * i + 1]
            vol = _conv3d(vol, down[0].taps(), 2, compute_dtype)
            vol = F.relu(_bn_affine(vol, down[1])) * mask
        for conv, bn in net.net[2 * i + 2].pairs():
            vol = _conv3d(vol, conv.taps(), 1, compute_dtype)
            vol = F.relu(_bn_affine(vol, bn)) * mask
        vols.append(vol)
    return vols


def occupancy_volume_dense(vols, *, levels=None):
    """`occupancy_volume` from dense (masked) level volumes: per-level
    channel sums, nearest-upsampled to level-1 resolution and summed.
    Returns (D1, H1, W1) float32."""
    total = vols[0].new_zeros(vols[0].shape[:3], dtype=torch.float32)
    use = range(len(vols)) if levels is None else levels
    for i in use:
        v = vols[i].sum(dim=-1).float()
        for _ in range(i):
            v = v.repeat_interleave(2, 0).repeat_interleave(2, 1).repeat_interleave(2, 2)
        total = total + v
    return total


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
