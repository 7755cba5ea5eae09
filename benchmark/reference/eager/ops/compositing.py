# Frozen copy of gpnerf_tpu_torch/ops/compositing.py at commit ffa1347, the benchmark's plain
# reference: the port's hand-written kernels, registries and the paths no
# configuration of the benchmark runs are removed; nothing here is imported
# from the program.
"""Volume-rendering alpha compositing (gpnerf_tpu/ops/compositing.py;
reference BaseRender.py:75-107): distance-free opacity alpha = 1 -
exp(-sigma), shifted-cumprod transmittance with the 1e-10 stabilizer, and
the more-than-8-valid-samples ray mask. `neg` flips the sample order for
THuman's flipped ray parameterization."""

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
