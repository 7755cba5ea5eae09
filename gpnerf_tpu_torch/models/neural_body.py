"""Neural Body (Peng et al., CVPR 2021, arXiv 2012.15838; zju3dv/neuralbody
lib/networks/latent_xyzc.py, lib/networks/embedder.py): structured latent
codes on the SMPL vertices, diffused by a sparse 3D CNN into four dense
volumes, queried at each sample and decoded by a latent-conditioned MLP.

  * `c`: one code of `code_dim` per SMPL vertex, at the vertices' level-0
    voxels (the host pyramid keeps the first vertex of a shared voxel,
    data/sparse_host.py);
  * `xyzc_net`: the sparse stack (models/sparse_net.py) `code_dim` ->
    `out_dim` with `convs` submanifold convs per level, the four levels'
    features as dense volumes;
  * the query: each level's volume read trilinearly at the point, align
    corners, zero outside (`query`, `F.grid_sample` as the source's),
    concatenated to sum(out_dim) channels;
  * density: fc_0, fc_1, fc_2 (ReLU) and alpha_fc; color: feature_fc, the
    frame's latent row (`latent`) concatenated into latent_fc, the view
    direction's and the world point's positional encodings concatenated
    into view_fc (ReLU) and rgb_fc. The source's 1x1 Conv1d layers are
    Linear layers here, weights (out, in).

`compute_dtype` (bfloat16 in the benchmark's configuration): the sparse
convs and the Linear layers take operands of that dtype and sum in float32
(the hidden layers return that dtype; alpha_fc and rgb_fc return float32,
so sigma and rgb are not rounded), and the query is rounded to it; the
BatchNorms, the volumes, the query's lerps and the encodings are float32.
None computes everything in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gpnerf_tpu_torch.models.layers import cast
from gpnerf_tpu_torch.models.sparse_net import SparseConvNet
from gpnerf_tpu_torch.ops.sparse_conv import scatter_dense


def encoding_dim(multires, dims=3):
    return dims * (1 + 2 * multires)


def positional_encoding(x, multires):
    """The source's Embedder (include_input, log sampling, sin then cos):
    [x, sin(x * 2^0), cos(x * 2^0), ..., sin(x * 2^(L-1)), cos(...)] along
    the last axis, L = multires."""
    freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
    xf = x[..., None, :] * freqs[:, None]  # (..., L, 3)
    enc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)  # (..., L, 2, 3)
    return torch.cat([x, enc.flatten(-3)], dim=-1)


class NeuralBody(nn.Module):
    def __init__(self, n_smpl=6890, code_dim=16, out_dim=(32, 64, 128, 128),
                 convs=(2, 2, 3, 3, 3), width=256, view_width=128, latent_dim=128,
                 num_train_frame=30, xyz_res=10, view_res=4, compute_dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.xyz_res, self.view_res = xyz_res, view_res
        self.c = nn.Embedding(n_smpl, code_dim)
        self.xyzc_net = SparseConvNet(in_dim=code_dim, n_layers=len(out_dim),
                                      out_dim=tuple(out_dim), compute_dtype=compute_dtype,
                                      convs=convs)
        self.latent = nn.Embedding(num_train_frame, latent_dim)
        self.fc_0 = nn.Linear(sum(out_dim), width)
        self.fc_1 = nn.Linear(width, width)
        self.fc_2 = nn.Linear(width, width)
        self.alpha_fc = nn.Linear(width, 1)
        self.feature_fc = nn.Linear(width, width)
        self.latent_fc = nn.Linear(width + latent_dim, width)
        self.view_fc = nn.Linear(
            width + encoding_dim(view_res) + encoding_dim(xyz_res), view_width)
        self.rgb_fc = nn.Linear(view_width, 3)

    def _linear(self, layer, x):
        dt = self.compute_dtype
        return F.linear(cast(x, dt), cast(layer.weight, dt), cast(layer.bias, dt))

    def _linear_out(self, layer, x):
        """An output layer: operands of the compute dtype, a float32 result
        (on the card cuBLAS's product with a float32 result, which has no
        CPU kernel; elsewhere the operands widened, their products exact
        in float32)."""
        dt = self.compute_dtype
        if dt is None:
            return F.linear(x, layer.weight, layer.bias)
        x, w = cast(x, dt), cast(layer.weight, dt).T.contiguous()
        out = torch.mm(x, w, out_dtype=torch.float32) if x.is_cuda else x.float() @ w.float()
        return out + layer.bias.float()

    def latent_row(self, latent_index):
        """The latent of frame `latent_index` (a 0-d tensor); an index past
        the trained frames takes the last one, as the source does for an
        unseen pose."""
        n = self.latent.num_embeddings
        return self.latent.weight[latent_index.long().clamp(0, n - 1).reshape(1)]

    def volumes(self, vertex_rows, levels, out_sh):
        """The four level volumes of a frame, (C_i, D_i, H_i, W_i) float32
        views at the frame's level sizes out_sh // 2^(i + 1) (out_sh three
        ints), zero at inactive sites: the vertex codes at the level-0 rows
        (`vertex_rows`, -1 for padding) through the sparse stack. Each is a
        view of the channels-last dense volume at the static level size
        (ops/sparse_conv.py `scatter_dense`), each voxel's channels
        contiguous, as ops/nbody_points.py's kernel reads them."""
        code = self.c.weight[vertex_rows.clamp_min(0)]
        code = torch.where((vertex_rows >= 0)[:, None], code, 0.0)
        feats = self.xyzc_net.features(code, levels)
        vols = []
        for i, f in enumerate(feats):
            D, H, W = (int(v) >> (i + 1) for v in out_sh)
            vols.append(scatter_dense(f, levels[i + 1]).permute(3, 0, 1, 2)[:, :D, :H, :W])
        return vols

    def query(self, vols, dhw_vox, out_sh):
        """(sum(out_dim), P) in the compute dtype: each level's volume read
        at the points' level-0 voxel positions `dhw_vox` (P, 3), [0,
        out_sh] mapped onto [-1, 1] (align corners, zero outside: the
        source's grid coordinates)."""
        sh = torch.as_tensor([int(v) for v in out_sh], dtype=dhw_vox.dtype,
                             device=dhw_vox.device)
        grid = (dhw_vox / sh * 2 - 1).flip(-1)[None, None, None]
        out = torch.empty(sum(v.shape[0] for v in vols), dhw_vox.shape[0],
                          dtype=self.compute_dtype or torch.float32, device=dhw_vox.device)
        c0 = 0
        for v in vols:
            out[c0:c0 + v.shape[0]] = F.grid_sample(v[None], grid, padding_mode="zeros",
                                                    align_corners=True)[0, :, 0, 0]
            c0 += v.shape[0]
        return out

    def head(self, feat, latent, view_enc, xyz_enc):
        """raw (P, 4) float32, rgb then sigma, from the query `feat`
        (sum(out_dim), P), the frame's latent (1, latent_dim) and the
        encodings (P, 27), (P, 63)."""
        net = F.relu(self._linear(self.fc_0, feat.T))
        net = F.relu(self._linear(self.fc_1, net))
        net = F.relu(self._linear(self.fc_2, net))
        alpha = self._linear_out(self.alpha_fc, net)
        features = self._linear(self.feature_fc, net)
        lat = cast(latent, features.dtype).expand(features.shape[0], -1)
        features = self._linear(self.latent_fc, torch.cat([features, lat], dim=-1))
        dt = features.dtype
        features = torch.cat([features, view_enc.to(dt), xyz_enc.to(dt)], dim=-1)
        net = F.relu(self._linear(self.view_fc, features))
        rgb = self._linear_out(self.rgb_fc, net)
        return torch.cat([rgb, alpha], dim=-1)

    def encodings(self, pts_world, viewdir):
        """The positional encodings of the world points (P, 3) and of the
        unit view directions (P, 3), float32."""
        return positional_encoding(viewdir, self.view_res), positional_encoding(
            pts_world, self.xyz_res)
