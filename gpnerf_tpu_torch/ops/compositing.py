"""Volume-rendering alpha compositing (gpnerf_tpu/ops/compositing.py;
reference BaseRender.py:75-107): distance-free opacity alpha = 1 -
exp(-sigma), shifted-cumprod transmittance with the 1e-10 stabilizer, and
the more-than-8-valid-samples ray mask. `neg` flips the sample order for
THuman's flipped ray parameterization.

`raw2outputs_distance` is Neural Body's compositing (zju3dv/neuralbody
lib/networks/renderer/if_clight_renderer.py, its raw2outputs): opacity
from the density and the sample spacing, no ray mask."""

from __future__ import annotations

from typing import NamedTuple

import torch


class CompositeOutput(NamedTuple):
    rgb_map: torch.Tensor  # (N_rays, 3)
    disp_map: torch.Tensor  # (N_rays,)
    acc_map: torch.Tensor  # (N_rays,)
    weights: torch.Tensor  # (N_rays, N_samples)
    depth_map: torch.Tensor  # (N_rays,)
    mask: torch.Tensor  # (N_rays,) bool
    alpha: torch.Tensor  # (N_rays, N_samples)


def sigma2alpha(sigma):
    return 1.0 - torch.exp(-sigma)


def shifted_transmittance(alpha):
    """T_i = prod_{j<i} (1 - alpha_j + 1e-10), T_0 = 1."""
    T = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)[..., :-1]
    return torch.cat([torch.ones_like(T[..., :1]), T], dim=-1)


def raw2outputs(raw, z_vals, pixel_mask, neg=False):
    """raw (N_rays, N_samples, 4): rgb then sigma; z_vals (N_rays,
    N_samples); pixel_mask (N_rays, N_samples): samples seen by at least
    two source views. A ray is valid when more than 8 of its samples are."""
    rgb = raw[:, :, :3]
    sigma = raw[:, :, 3]
    if neg:
        rgb = rgb.flip(1)
        sigma = sigma.flip(1)
    alpha = sigma2alpha(sigma)
    weights = alpha * shifted_transmittance(alpha)
    rgb_map = (weights[..., None] * rgb).sum(dim=1)
    depth_map = (weights * z_vals).sum(dim=-1)
    acc_map = weights.sum(dim=-1)
    # the reference's disp is NaN on empty rays (0/0); guarded, as it feeds
    # no loss or metric
    disp_map = 1.0 / torch.clamp_min(depth_map / acc_map.clamp_min(1e-10), 1e-10)
    mask = pixel_mask.float().sum(dim=1) > 8
    return CompositeOutput(rgb_map, disp_map, acc_map, weights, depth_map, mask, alpha)


def composite_scattered(rgb, alpha, n_rays, n_samples):
    """Compositing on dense buffers scattered back from a culled point set:
    rgb (n_rays*n_samples, 3), alpha (n_rays*n_samples,). Returns rgb_map
    (n_rays, 3) and weights (n_rays, n_samples)."""
    rgb = rgb.reshape(n_rays, n_samples, 3)
    alpha = alpha.reshape(n_rays, n_samples)
    weights = alpha * shifted_transmittance(alpha)
    return (weights[..., None] * rgb).sum(dim=1), weights


def raw2outputs_distance(raw, z_vals, rays_d):
    """Neural Body's compositing, without noise or white background: the
    rgb map (N_rays, 3) of raw (N_rays, N_samples, 4), rgb then sigma; rgb
    = sigmoid(raw rgb), alpha = 1 - exp(-relu(sigma) * delta), delta the
    spacing to the next sample (1e10 after the last) times |d|; the
    transmittance as `shifted_transmittance`. Every ray is kept."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1)[..., None]
    rgb = torch.sigmoid(raw[..., :3])
    alpha = 1.0 - torch.exp(-torch.relu(raw[..., 3]) * dists)
    weights = alpha * shifted_transmittance(alpha)
    return (weights[..., None] * rgb).sum(dim=-2)
