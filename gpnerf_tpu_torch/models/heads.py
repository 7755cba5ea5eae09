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

The progressive renderer's fused path runs density/color inside the
point-stage kernel (ops/point_stages.py); its op-by-op path calls
`density`, `color` and `query_sigma_feat_octet_folded` (or, with the
coarse table unfolded, `query_sigma_feat_octet`) here. The training
renderer (render/base.py) runs `volume(train=)` and `point_forward`. With a
`compute_dtype` the Dense layers, the queried geometry features and the
activations are tensors of that dtype, as the JAX package's heads computing
in it make them (models/layers.MLP); the attention and the sparse stack's
sums and BatchNorms stay float32.
"""

from __future__ import annotations

import torch
from torch import nn

from gpnerf_tpu_torch.models.attention import MultiHeadAttention
from gpnerf_tpu_torch.models.layers import MLP, cast
from gpnerf_tpu_torch.models.sparse_net import SparseConvNet
from gpnerf_tpu_torch.ops.sparse_conv import _gather_rows


def fused_mean_variance(x):
    """Mean and variance across the views axis: x (..., V, C) -> ((..., 1,
    C), (..., 1, C)) of x's dtype. The sums and the division run in float32
    (JAX's mean of a bf16 tensor does); the difference is of x's dtype, and
    its square feeds the float32 sum unrounded (the compiled JAX program
    keeps that excess precision)."""
    V = x.shape[-2]

    def mean_views(t):
        acc = t[..., 0, :].float()
        for v in range(1, V):
            acc = acc + t[..., v, :].float()
        return (acc / float(V)).to(x.dtype)[..., None, :]

    mean = mean_views(x)
    d = (x - mean).float()
    return mean, mean_views(d * d)


def _sigmoid(x):
    """Sigmoid; on a bf16 tensor as 1 / (1 + exp(-x)), three bf16
    operations, the form the JAX package's compiled program evaluates."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


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
        self.out_geometry_fc = MLP(sum(spconv_out_dim), (64,), ("elu",), compute_dtype)
        self.nch1 = int(spconv_out_dim[0])
        self.compute_dtype = compute_dtype

    def fuse_codes(self, smpl_feat):
        """smpl_feat (S, V, in_feat_ch) -> fused codes (S, code_dim)."""
        fused, _ = self.xyzc_attn(self.c.weight[:, None, :], smpl_feat, smpl_feat)
        return fused[:, 0, :]

    def volume_features(self, fused_codes, vertex_rows, levels, *, train=False):
        """Scatter fused codes onto the level-0 rows (vertex_rows: winning
        vertex per row, -1 padding) and run the conv stack."""
        code = _gather_rows(fused_codes, vertex_rows)
        return self.xyzc_net.features(code, levels, train=train)

    def query_sigma_feat_dense(self, dense_vols, dhw_vox, out_sh):
        """Sigma feature (P, 64) against the dense per-level volumes
        (render/base.materialize_dense): the multi-scale trilinear query,
        then out_geometry_fc. out_sh (3,) int tensor."""
        return self.out_geometry_fc(self.xyzc_net.query_dense(dense_vols, dhw_vox, out_sh))

    def query_sigma_feat_octet(self, octet_vols, dhw_vox, out_sh, scales=None,
                               with_l1_occ=False):
        """Sigma feature (P, 64) from unfolded tables: two (the level-1
        table and the merged [l2|l3|l4] coarse table, query_octet2) or four
        (one per level, query_octet), queried in the compute dtype, then
        out_geometry_fc on the full (P, 128) feature. `with_l1_occ` also
        returns the level-1 channel sum of the queried features, the
        trilinear occupancy."""
        dt = self.compute_dtype
        net = self.xyzc_net
        if len(octet_vols) == 2:
            feats = net.query_octet2(*octet_vols, dhw_vox, out_sh, scales=scales, out_dtype=dt)
        else:
            feats = net.query_octet(octet_vols, dhw_vox, out_sh, scales=scales, out_dtype=dt)
        sigma_feat = self.out_geometry_fc(feats)
        if with_l1_occ:
            return sigma_feat, feats[..., :self.nch1].sum(dim=-1)
        return sigma_feat

    def query_sigma_feat_octet_folded(self, octet_l1, octet_coarse, dhw_vox,
                                      out_sh, scales=None, with_l1_occ=False):
        """Sigma feature (P, 64) against the folded merged-coarse table:
        out_geometry_fc's coarse block was applied to the coarse volume when
        the table was built (trilinear commutes with linear maps), so the
        queried coarse rows are that block's contribution already and only
        the level-1 block of the linear runs per point:
        sigma_feat = ELU(f1 @ W[:, :nch].T + fc + b). `with_l1_occ` also
        returns the level-1 channel sum of the queried features, the
        trilinear occupancy."""
        dt = self.compute_dtype
        feats = self.xyzc_net.query_octet2(
            octet_l1, octet_coarse, dhw_vox, out_sh, scales=scales, out_dtype=dt)
        f1, fc = feats[..., :self.nch1], feats[..., self.nch1:]
        lin = self.out_geometry_fc[0]
        pre = cast(f1, dt) @ cast(lin.weight[:, :self.nch1], dt).T + cast(fc, dt)
        sigma_feat = torch.nn.functional.elu(pre + cast(lin.bias, dt))
        if with_l1_occ:
            return sigma_feat, f1.sum(dim=-1)
        return sigma_feat


class NeRFRGBHead(nn.Module):
    def __init__(self, in_feat_ch=32, n_views=3, compute_dtype=None):
        super().__init__()
        C = in_feat_ch + 3
        self.compute_dtype = compute_dtype
        dt = compute_dtype
        self.base_fc = MLP(3 * C, (64, 32), ("elu", "elu"), dt)
        self.vis_fc = MLP(32, (32, 32), ("elu", "elu"), dt)
        self.rgb_fc = MLP(n_views * 32, (32, 16, 3), ("elu", "elu", "none"), dt)
        self.out_geometry_fc = MLP(
            64 + 2 * C, (64, 32, 16, 1), ("elu", "elu", "elu", "relu"), dt
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
        return _sigmoid(self.rgb_fc(x))

    def forward(self, rgb_feat, sigma_feat, mask):
        """rgb_feat (N_rays, N_samples, V, C+3), sigma_feat (..., 64), mask
        (N_rays, N_samples, V, 1). Returns (rgb_in, rgb, sigma); the mean
        and variance are in rgb_feat's own dtype (float32 on the training
        path), as the JAX package computes them."""
        mean, var = fused_mean_variance(rgb_feat)
        sigma = self.density(sigma_feat, mean[..., 0, :], var[..., 0, :], mask.sum(dim=-2))
        return rgb_feat[..., :3], self.color(rgb_feat, mean, var), sigma


class NeRFHead(nn.Module):
    """`n_views`: the source views the color head's rgb_fc flattens (JAX's
    rgb_fc infers its input width, V * 32, from its first call)."""

    def __init__(self, in_feat_ch=32, n_smpl=6890, code_dim=16,
                 attn_n_heads=4, spconv_n_layers=4,
                 spconv_out_dim=(32, 32, 32, 32), compute_dtype=None, n_views=3):
        super().__init__()
        self.spconv_out_dim = tuple(spconv_out_dim)
        self.sigmahead = NeRFSigmaHead(
            in_feat_ch, n_smpl, code_dim, attn_n_heads, spconv_n_layers,
            spconv_out_dim, compute_dtype,
        )
        self.rgbhead = NeRFRGBHead(in_feat_ch, n_views=n_views, compute_dtype=compute_dtype)

    def volume(self, smpl_feat, vertex_rows, levels, *, train=False):
        """Fuse vertex codes and build the sparse feature volume once per
        frame. Returns the per-level feature matrices. `train`: batch
        statistics in every BatchNorm, running estimates updated."""
        fused = self.sigmahead.fuse_codes(smpl_feat)
        return self.sigmahead.volume_features(fused, vertex_rows, levels, train=train)

    def point_forward(self, query_ctx, dhw_vox, out_sh, rgb_feat, mask,
                      occupancy_cull=False):
        """Multi-scale query and heads for one ray chunk. `query_ctx` is
        {"sparse": (level_feats, index_vols, shapes)} (training: gradients
        on the sparse rows) or {"dense": [per-level (D, H, W, C) volumes]};
        both give the same values. `occupancy_cull` zeroes sigma where the
        level-1 queried feature's channel sum is <= 0 (the progressive
        renderer's empty-space cull). dhw_vox (N_rays*N_samples, 3), out_sh
        (3,) int tensor, rgb_feat (N_rays, N_samples, V, C+3), mask
        (N_rays, N_samples, V, 1). Returns (raw (N_rays, N_samples, 4),
        rgb_in)."""
        n_rays, n_samples = rgb_feat.shape[:2]
        net = self.sigmahead.xyzc_net
        if "dense" in query_ctx:
            feats = net.query_dense(query_ctx["dense"], dhw_vox, out_sh)
        else:
            feats = net.query_sparse(*query_ctx["sparse"], dhw_vox, out_sh)
        sigma_feat = self.sigmahead.out_geometry_fc(feats).reshape(n_rays, n_samples, -1)
        rgb_in, rgb, sigma = self.rgbhead(rgb_feat, sigma_feat, mask)
        if occupancy_cull:
            occ = feats[..., : self.spconv_out_dim[0]].sum(dim=-1) > 0
            sigma = torch.where(occ.reshape(n_rays, n_samples, 1), sigma, 0.0)
        return torch.cat([rgb, sigma], dim=-1), rgb_in


def build_head(cfg, compute_dtype=None):
    """The heads of `cfg` (JAX models/heads.py `build_head`,
    trainhead.py:166-177); with a `compute_dtype` they compute on tensors of
    that dtype where the JAX package's clone with that dtype does."""
    return NeRFHead(
        in_feat_ch=cfg.encoder.out_ch,
        n_smpl=cfg.head.sigma.n_smpl,
        code_dim=cfg.head.sigma.code_dim,
        attn_n_heads=cfg.head.sigma.n_heads,
        spconv_n_layers=cfg.head.sigma.n_layers,
        spconv_out_dim=tuple(cfg.head.sigma.outdims),
        compute_dtype=compute_dtype,
        n_views=cfg.src_view_num,
    )


from gpnerf_tpu_torch.registry import register  # noqa: E402

register("head", "trainhead", build_head)
