"""Multi-view projection + feature gathering (gpnerf_tpu/ops/projection.py,
the reference `Projector`): project query points into each source camera,
normalize pixel coords with the align_corners convention, and build the
per-view validity mask (in-bounds AND in front of the camera, with the
THuman `neg_ray` sign flip)."""

from __future__ import annotations

import torch

from gpnerf_tpu_torch.ops.grid_sample import _unnormalize, grid_sample_2d_nhwc


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
    V = srcfeat_quad.shape[0]
    C4 = srcfeat_quad.shape[-1]
    pixel, in_front = compute_projections(xyz, KE, neg_ray=neg_ray)
    norm_pix = normalize_pixels(pixel, h, w)
    ht = srcfeat_quad.shape[1] - 1
    wt = srcfeat_quad.shape[2] - 1
    x = _unnormalize(norm_pix[..., 0], wt)
    y = _unnormalize(norm_pix[..., 1], ht)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wy1 = y - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    xi = x0.long()
    yi = y0.long()
    xc = xi.clamp(-1, wt - 1) + 1
    yc = yi.clamp(-1, ht - 1) + 1
    stride = (ht + 1) * (wt + 1)
    idx_vp = yc * (wt + 1) + xc  # (V, P)
    if batched:
        tab = srcfeat_quad.reshape(V, stride, C4)
        rows = torch.cat([tab[v][idx_vp[v]] for v in range(V)])
    else:
        voff = torch.arange(V, device=xyz.device)[:, None] * stride
        rows = srcfeat_quad.reshape(V * stride, C4)[(idx_vp + voff).reshape(-1)]

    def tapw(xi_, yi_, wgt):
        inb = (xi_ >= 0) & (xi_ <= wt - 1) & (yi_ >= 0) & (yi_ <= ht - 1)
        return wgt * inb.float()

    w4 = torch.stack(
        [
            tapw(xi, yi, wx0 * wy0),
            tapw(xi + 1, yi, wx1 * wy0),
            tapw(xi, yi + 1, wx0 * wy1),
            tapw(xi + 1, yi + 1, wx1 * wy1),
        ],
        dim=1,
    )
    vmask = (inbound_mask(pixel, h, w) & in_front).float()
    return rows, w4, vmask


def gather_smpl_features(smpl_xyz, KE, featmaps, h, w, *, neg_ray=False):
    """Per-SMPL-vertex multi-view feature gather: smpl_xyz (S, 3) ->
    smpl_feat (S, V, C)."""
    pixel, _ = compute_projections(smpl_xyz, KE, neg_ray=neg_ray)
    feat = grid_sample_2d_nhwc(featmaps, normalize_pixels(pixel, h, w))
    return feat.transpose(0, 1)
