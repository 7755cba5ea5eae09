# Frozen copy of gpnerf_tpu_torch/ops/rays.py at commit ffa1347, the benchmark's plain
# reference: the port's hand-written kernels, registries and the paths no
# configuration of the benchmark runs are removed; nothing here is imported
# from the program.
"""Device-side ray utilities (gpnerf_tpu/ops/rays.py): stratified depth
sampling (reference BaseRender.py:35-50), pixel-ray generation and
ray/AABB intersection (reference demo_render.py:200-239)."""

from __future__ import annotations

import torch


def sample_z_vals(near, far, n_samples, *, perturb, generator=None, t_rand=None):
    """Stratified depth samples: near, far (...,) -> z_vals (..., n_samples).
    With `perturb` each sample is jittered uniformly within its stratum; the
    uniform draws are `t_rand` (shape (..., n_samples)) when given, else
    drawn from `generator` (a torch.Generator on the tensors' device)."""
    t_vals = torch.linspace(0.0, 1.0, n_samples, dtype=near.dtype, device=near.device)
    z_vals = near[..., None] * (1.0 - t_vals) + far[..., None] * t_vals
    if perturb:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mids], dim=-1)
        if t_rand is None:
            t_rand = torch.rand(z_vals.shape, generator=generator, dtype=z_vals.dtype,
                                device=z_vals.device)
        z_vals = lower + (upper - lower) * t_rand
    return z_vals


def sample_points(ray_o, ray_d, z_vals):
    """pts[i, k] = o_i + d_i * z[i, k]: (..., n_samples, 3)."""
    return ray_o[..., None, :] + ray_d[..., None, :] * z_vals[..., None]


def pixel_rays(xy1, K_inv, R, T):
    """World-space rays through pixel centers: o = -R^T T,
    d = (K^{-1} [x, y, 1] - T)^T R - o (un-normalized).
    xy1 (P, 3); K_inv, R (3, 3); T (3, 1). Returns rays_o, rays_d (P, 3)."""
    ori = (-R.T @ T).reshape(-1)
    pixel_camera = xy1 @ K_inv.T
    pixel_world = (pixel_camera - T.reshape(1, 3)) @ R
    rays_d = pixel_world - ori[None]
    return ori.expand_as(rays_d), rays_d


def ray_aabb_near_far(rays_o, rays_d, bounds, eps=1e-6):
    """Slab intersection with the AABB bounds (2, 3); both distances carry
    the sign of the first hit's direction (the host get_near_far
    convention). Returns near, far (P,) and mask_at_box (P,) bool — rays
    hitting the box exactly twice."""
    nominator = bounds[None] - rays_o[:, None]  # (P, 2, 3)
    safe_d = torch.where(rays_d.abs() < 1e-10, 1e-10, rays_d)
    d_intersect = (nominator / safe_d[:, None]).reshape(-1, 6)
    p_intersect = d_intersect[..., None] * rays_d[:, None] + rays_o[:, None]
    p_mask = (
        (p_intersect >= (bounds[0] - eps)) & (p_intersect <= (bounds[1] + eps))
    ).all(dim=-1)  # (P, 6)
    mask_at_box = p_mask.sum(dim=-1) == 2
    # the two valid planes first (stable), as the JAX argsort of ~p_mask
    order = torch.argsort((~p_mask).to(torch.uint8), dim=-1, stable=True)
    first = torch.gather(p_intersect, 1, order[:, 0:1, None].expand(-1, 1, 3))[:, 0]
    second = torch.gather(p_intersect, 1, order[:, 1:2, None].expand(-1, 1, 3))[:, 0]
    norm_ray = torch.linalg.norm(rays_d, dim=-1)
    sgn = torch.where(((first - rays_o) * rays_d).sum(dim=-1) < 0.0, -1.0, 1.0)
    d0 = torch.linalg.norm(first - rays_o, dim=-1) / norm_ray * sgn
    d1 = torch.linalg.norm(second - rays_o, dim=-1) / norm_ray * sgn
    return torch.minimum(d0, d1), torch.maximum(d0, d1), mask_at_box
