"""Multi-view projection + feature gathering (gpnerf_tpu/ops/projection.py,
the reference `Projector`): project query points into each source camera,
normalize pixel coords with the align_corners convention, and build the
per-view validity mask (in-bounds AND in front of the camera, with the
THuman `neg_ray` sign flip)."""

from __future__ import annotations

import torch

from gpnerf_tpu_torch.ops.grid_sample import (
    bilinear_quad_nhwc,
    bilinear_quad_nhwc_pv,
    bilinear_quad_nhwc_pv_kernel,
    grid_sample_2d_nhwc,
    quad_rows_and_weights,
)


def compute_projections(xyz, KE, *, neg_ray=False):
    """xyz (P, 3) world points, KE (V, 4, 4) -> pixel_xy (V, P, 2) clamped
    to +-1e6, in_front (V, P) bool."""
    xyz_h = torch.cat([xyz, torch.ones_like(xyz[..., :1])], dim=-1)
    proj = torch.einsum("vij,pj->vpi", KE, xyz_h)
    pixel = (proj[..., :2] / proj[..., 2:3]).clamp(-1e6, 1e6)
    in_front = proj[..., 2] < 0 if neg_ray else proj[..., 2] > 0
    return pixel, in_front


def normalize_pixels(pixel_xy, h, w):
    """Pixel coords -> [-1, 1] with the (size-1) denominator."""
    scale = torch.tensor([w - 1.0, h - 1.0], dtype=pixel_xy.dtype,
                         device=pixel_xy.device)
    return 2.0 * pixel_xy / scale - 1.0


def inbound_mask(pixel_xy, h, w):
    return (
        (pixel_xy[..., 0] <= w - 1.0)
        & (pixel_xy[..., 0] >= 0)
        & (pixel_xy[..., 1] <= h - 1.0)
        & (pixel_xy[..., 1] >= 0)
    )


def project_and_gather(xyz, KE, src_imgs, featmaps, h, w, *, neg_ray=False):
    """The reference `Projector.compute` (BaseRender.py:326-363): xyz (P, 3);
    src_imgs (V, H, W, 3) un-normalized, featmaps (V, Hf, Wf, C), both
    bilinearly sampled (differentiable in both). Returns rgb_feat (P, V,
    3 + C) and mask (P, V) float (in bounds and in front)."""
    pixel, in_front = compute_projections(xyz, KE, neg_ray=neg_ray)
    norm_pix = normalize_pixels(pixel, h, w)
    rgb = grid_sample_2d_nhwc(src_imgs, norm_pix)
    feat = grid_sample_2d_nhwc(featmaps, norm_pix)
    rgb_feat = torch.cat([rgb, feat], dim=-1).transpose(0, 1)
    mask = (inbound_mask(pixel, h, w) & in_front).to(rgb_feat.dtype)
    return rgb_feat, mask.T


def project_and_gather_quad(xyz, KE, src_quad, feat_quad, h, w, *,
                            neg_ray=False, src_scale=None, feat_scale=None):
    """Project and gather through the split quad tables, both in (P, V) row
    order: src_quad (V, H+1, W+1, 12) float or uint8 pixel bytes (`src_scale`
    then carries the 1/255 dequant), feat_quad (V, Hf+1, Wf+1, 4C) float or
    int8 (`feat_scale` its per-channel dequant). Each table is sampled in
    its `lerp_dtype`, and the rgb is cast to the features' dtype (as the
    JAX package casts it). Returns rgb_feat (P, V, 3 + C), mask (P, V)."""
    pixel, in_front = compute_projections(xyz, KE, neg_ray=neg_ray)
    norm_pix = normalize_pixels(pixel, h, w)
    rgb = bilinear_quad_nhwc_pv(src_quad, norm_pix, h, w, scale=src_scale)
    hf, wf = feat_quad.shape[1] - 1, feat_quad.shape[2] - 1
    feat = bilinear_quad_nhwc_pv(feat_quad, norm_pix, hf, wf, scale=feat_scale)
    rgb = rgb.to(feat.dtype)
    mask = (inbound_mask(pixel, h, w) & in_front).float()
    return torch.cat([rgb, feat], dim=-1), mask.T


def project_and_gather_quad_merged(xyz, KE, srcfeat_quad, h, w, *,
                                   neg_ray=False, scale=None, out_dtype=None,
                                   vp_order=False, kernel=False):
    """`project_and_gather_quad` through one merged [rgb|features] quad
    table (V, Ht+1, Wt+1, 4(3+C)) at any resolution: the gather uses the
    table's own grid, h/w are the pixel frame of K. `scale`: dequantization
    factors of an int8 table; `out_dtype`: see ops/grid_sample.
    bilinear_quad_nhwc (a bf16 table rounds to bf16 by default). Routes: `kernel`, the quad-lerp kernel on view-major
    rows (float32 accumulation, one rounding); `vp_order`, a per-view (V, P)
    gather whose float result is transposed; else the gather emitted in
    (P, V) order. Returns rgb_feat (P, V, 3 + C), mask (P, V)."""
    pixel, in_front = compute_projections(xyz, KE, neg_ray=neg_ray)
    norm_pix = normalize_pixels(pixel, h, w)
    ht, wt = srcfeat_quad.shape[1] - 1, srcfeat_quad.shape[2] - 1
    if kernel:
        sample = bilinear_quad_nhwc_pv_kernel
    elif vp_order:
        sample = bilinear_quad_nhwc
    else:
        sample = bilinear_quad_nhwc_pv
    rgb_feat = sample(srcfeat_quad, norm_pix, ht, wt, scale=scale, out_dtype=out_dtype)
    if vp_order and not kernel:
        rgb_feat = rgb_feat.transpose(0, 1)
    mask = (inbound_mask(pixel, h, w) & in_front).float()
    return rgb_feat, mask.T


def project_gather_rows_merged(xyz, KE, srcfeat_quad, h, w, *, neg_ray=False,
                               batched=False):
    """Gather half of a quad-table projection: the raw quad rows in
    view-major order, the 4 bilinear tap weights with the in-bounds mask
    folded in, and the view mask. The weighted sum and everything
    downstream happen in the point-stage kernel.

    srcfeat_quad: (V, Ht+1, Wt+1, 4C) from build_quad_table_2d (the merged
    [rgb|feat] table, or one table of the split pair; the gather uses the
    table's own grid); h/w are the source image size (the pixel frame of
    K). `batched` gathers view by view from the per-view table instead of
    once from the flat (V*rows) table; both return the same rows.
    Returns rows (V*P, 4C), w4 (V, 4, P) f32, vmask (V, P) f32."""
    pixel, in_front = compute_projections(xyz, KE, neg_ray=neg_ray)
    rows, w4 = quad_rows_and_weights(
        srcfeat_quad, normalize_pixels(pixel, h, w), batched=batched)
    vmask = (inbound_mask(pixel, h, w) & in_front).float()
    return rows, w4, vmask


def gather_smpl_features(smpl_xyz, KE, featmaps, h, w, *, neg_ray=False):
    """Per-SMPL-vertex multi-view feature gather: smpl_xyz (S, 3) ->
    smpl_feat (S, V, C)."""
    pixel, _ = compute_projections(smpl_xyz, KE, neg_ray=neg_ray)
    feat = grid_sample_2d_nhwc(featmaps, normalize_pixels(pixel, h, w))
    return feat.transpose(0, 1)
