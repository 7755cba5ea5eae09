"""GP-NeRF heads (gpnerf_tpu/models/heads.py; reference trainhead.py):

  * `NeRFSigmaHead`: per-SMPL-vertex codes (`c`, an Embedding) fused with
    each vertex's V projected image features by cross-attention
    (`fuse_codes`), scattered onto the voxel active set and run through the
    sparse conv stack; `out_geometry_fc` = Linear(128, 64) + ELU.
  * `NeRFRGBHead`: density MLP on [sigma_feat, mean, var] (134 -> 64 -> 32
    -> 16 -> 1, ReLU) and the per-view color MLP (base_fc 105 -> 64 -> 32,
    vis_fc residual, rgb_fc 96 -> 32 -> 16 -> 3, sigmoid).
  * `NeRFHead`: the composition; parameter names follow the reference
    checkpoint (`nerfhead.sigmahead.*`, `nerfhead.rgbhead.*`).

The fast renderer runs density/color inside the point-stage kernel
(ops/point_stages.py); `density` and `color` here are the plain float32
forms of the same heads.
"""

from __future__ import annotations

import torch
from torch import nn

from gpnerf_tpu_torch.models.attention import MultiHeadAttention
from gpnerf_tpu_torch.models.layers import MLP
from gpnerf_tpu_torch.models.sparse_net import SparseConvNet


class NeRFSigmaHead(nn.Module):
    def __init__(self, in_feat_ch=32, n_smpl=6890, code_dim=16,
                 attn_n_heads=4, spconv_n_layers=4,
                 spconv_out_dim=(32, 32, 32, 32), compute_dtype=None):
        super().__init__()
        self.c = nn.Embedding(n_smpl, code_dim)
        d = code_dim // attn_n_heads
        self.xyzc_attn = MultiHeadAttention(attn_n_heads, code_dim, d, d, in_feat_ch)
        self.xyzc_net = SparseConvNet(
            code_dim, spconv_n_layers, tuple(spconv_out_dim), compute_dtype
        )
        self.out_geometry_fc = MLP(sum(spconv_out_dim), (64,), ("elu",))

    def fuse_codes(self, smpl_feat):
        """smpl_feat (S, V, in_feat_ch) -> fused codes (S, code_dim)."""
        fused, _ = self.xyzc_attn(self.c.weight[:, None, :], smpl_feat, smpl_feat)
        return fused[:, 0, :]

    def volume_features(self, fused_codes, vertex_rows, levels):
        """Scatter fused codes onto the level-0 rows (vertex_rows: winning
        vertex per row, -1 padding) and run the conv stack."""
        code = fused_codes[vertex_rows.clamp_min(0)]
        code = torch.where((vertex_rows >= 0)[:, None], code, 0.0)
        return self.xyzc_net.features(code, levels)


class NeRFRGBHead(nn.Module):
    def __init__(self, in_feat_ch=32, n_views=3):
        super().__init__()
        C = in_feat_ch + 3
        self.base_fc = MLP(3 * C, (64, 32), ("elu", "elu"))
        self.vis_fc = MLP(32, (32, 32), ("elu", "elu"))
        self.rgb_fc = MLP(n_views * 32, (32, 16, 3), ("elu", "elu", "none"))
        self.out_geometry_fc = MLP(
            64 + 2 * C, (64, 32, 16, 1), ("elu", "elu", "elu", "relu")
        )

    def density(self, sigma_feat, mean, var, num_valid_obs):
        """sigma (..., 1) from [sigma_feat, mean, var]; zero where a point
        has no valid source view."""
        sigma = self.out_geometry_fc(torch.cat([sigma_feat, mean, var], dim=-1))
        return torch.where(num_valid_obs < 1, 0.0, sigma)

    def color(self, rgb_feat, mean, var):
        """rgb_feat (..., V, C) -> rgb (..., 3) in [0, 1]."""
        V = rgb_feat.shape[-2]
        globalfeat = torch.cat([mean, var], dim=-1).expand(
            *rgb_feat.shape[:-1], -1
        )
        x = self.base_fc(torch.cat([globalfeat, rgb_feat], dim=-1))
        x = x + self.vis_fc(x / V)
        x = x.reshape(*x.shape[:-2], V * x.shape[-1])
        return torch.sigmoid(self.rgb_fc(x))


class NeRFHead(nn.Module):
    def __init__(self, in_feat_ch=32, n_smpl=6890, code_dim=16,
                 attn_n_heads=4, spconv_n_layers=4,
                 spconv_out_dim=(32, 32, 32, 32), compute_dtype=None):
        super().__init__()
        self.spconv_out_dim = tuple(spconv_out_dim)
        self.sigmahead = NeRFSigmaHead(
            in_feat_ch, n_smpl, code_dim, attn_n_heads, spconv_n_layers,
            spconv_out_dim, compute_dtype,
        )
        self.rgbhead = NeRFRGBHead(in_feat_ch)

    def volume(self, smpl_feat, vertex_rows, levels):
        """Fuse vertex codes and build the sparse feature volume once per
        frame. Returns the per-level feature matrices."""
        fused = self.sigmahead.fuse_codes(smpl_feat)
        return self.sigmahead.volume_features(fused, vertex_rows, levels)
