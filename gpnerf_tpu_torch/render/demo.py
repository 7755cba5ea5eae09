"""The geometry-guided progressive renderer in its shipped "fast" mode
(gpnerf_tpu/render/demo.py `Renderer.render_demo_fn`; the paper's
progressive pipeline, reference demo_render.py:96-498).

Per frame:
  1. encode the V source views (ResUNet);
  2. fuse the SMPL vertex codes, run the sparse conv stack once, derive the
     occupancy field `masks3d`;
  3. build the gather tables: the u8 level-1 octet table (corner-scattered
     from the active rows), the folded merged-coarse field (out_geometry_fc's
     coarse block pre-applied) resampled onto the level-1 grid as an int8
     nearest table, and the int8 [rgb|feat] quad table of the source rgb
     downsampled to the feature grid;
  4. splat the occupied level-1 voxels into the target view: a dilated
     pixel mask (rays are compacted to `ray_cap`) and per-pixel depth-bin
     masks on the 64-sample grid (the occupancy cull);
  5. per ray keep the first K occupied samples (slot-major (K, R) frame,
     all K*R slots evaluated);
  6. project + gather the quad rows and geometry rows, run the point-stage
     kernel (ops/point_stages.py), composite front to back, scatter the rays
     into the image.

Only the default switches of configs/synthetic.yaml are ported; any other
value of a renderer switch raises NotImplementedError (`FAST_MODE`).

Index compactions and scatters write through one spare slot that absorbs
the dropped entries (JAX's `mode="drop"`). Every real target is written
once: compaction positions are an exclusive prefix sum over the kept
entries, ray pixels are distinct, and the pixel/bin splats write the
constant 1 wherever several voxels land on one target.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from gpnerf_tpu_torch.models.encoder import ResUNet
from gpnerf_tpu_torch.models.heads import NeRFHead
from gpnerf_tpu_torch.models.layers import rounded
from gpnerf_tpu_torch.models.sparse_net import occupancy_volume
from gpnerf_tpu_torch.ops.grid_sample import (
    NearestTable,
    build_octet_table_scatter,
    build_quad_table_2d,
    nearest_row_and_weight,
    octet_rows_and_weights,
    quantize_image_i8,
    quantize_volume_u8,
    resample_volume_to,
    upsample_image_align_corners,
)
from gpnerf_tpu_torch.ops.point_stages import fused_point_stages, pack_head_weights
from gpnerf_tpu_torch.ops.projection import project_gather_rows_merged
from gpnerf_tpu_torch.ops.rays import pixel_rays, ray_aabb_near_far
from gpnerf_tpu_torch.ops.sparse_conv import scatter_dense
from gpnerf_tpu_torch.registry import register
from gpnerf_tpu_torch.render.base import points_to_dhw_vox, prepare_frame, src_norm

# the renderer switches of the shipped fast mode (configs/synthetic.yaml over
# config/default.py); the port implements exactly these values
FAST_MODE = {
    "tight_cull": True,
    "quantize_volume": True,
    "merge_coarse_octet": True,
    "fold_coarse_fc": True,
    "int4_coarse": False,
    "coarse_nearest": 2,
    "l1_nearest": 0,
    "dense_conv": False,
    "merge_src_feat": False,
    "merge_lowres_src": True,
    "frame_mode": False,
    "dense_slots": True,
    "splat_bins": True,
    "quantize_proj": True,
    "pack_octet_u32": False,
    "pallas_point": True,
    "kernel_octet": True,
    "sigma_query_cull": False,
    "int4_feat": False,
}

# level-1 voxels whose occupancy (masks3d) exceeds this splat into the view
OCCUPANCY_THRESHOLD = 0.1


def _compact(mask_flat, cap):
    """Static-size index compaction: (idx (cap,) ascending, n-filled tail;
    ok (cap,); overflow count)."""
    n = mask_flat.shape[0]
    dev = mask_flat.device
    m = mask_flat.long()
    pos = torch.cumsum(m, 0) - m  # exclusive prefix
    total = pos[-1] + m[-1]
    tgt = torch.where(mask_flat & (pos < cap), pos, cap)
    idx = torch.full((cap + 1,), n, dtype=torch.long, device=dev)
    idx[tgt] = torch.arange(n, device=dev)
    ok = torch.arange(cap, device=dev) < total
    return idx[:cap], ok, (total - cap).clamp_min(0)


class Renderer(nn.Module):
    """Progressive renderer; its `encoder` and `nerfhead` children carry the
    reference checkpoint's parameter names."""

    def __init__(self, encoder, nerfhead, *, voxel_size, n_samples=64,
                 samples_per_ray=13, ray_cap=24576, bin_margin_voxels=2.0,
                 max_out_sh=(96, 320, 224), compute_dtype=None):
        super().__init__()
        self.encoder = encoder
        self.nerfhead = nerfhead
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.n_samples = int(n_samples)
        self.samples_per_ray = int(samples_per_ray)
        self.ray_cap = int(ray_cap)
        self.bin_margin_voxels = float(bin_margin_voxels)
        self.max_out_sh = tuple(int(v) for v in max_out_sh)
        self.compute_dtype = compute_dtype

    def render_demo_fn(self):
        """batch (render/base.batch_to_device) -> render dict."""
        return self.render_demo

    @torch.no_grad()
    def render_demo(self, batch):
        featmaps = self.encoder(src_norm(batch["src_imgs"]))
        pre, tables, rd = self._frame_stage(batch, featmaps)
        rgb_map, stats = self._ray_pipeline(batch, pre, tables, rd)
        H, W = batch["tar_img"].shape[0:2]
        oob = H * W
        ray_ok = rd["ray_ok"]
        tgt = torch.where(ray_ok, rd["pix_idx"], oob)
        pred = rgb_map.new_zeros(3, oob + 1)
        pred[:, tgt] = rgb_map.T
        mask = torch.zeros(oob + 1, dtype=torch.bool, device=ray_ok.device)
        mask[tgt] = True
        zero = torch.zeros((), dtype=torch.long, device=ray_ok.device)
        return {
            "rgb_map": rgb_map,
            "pred_chw": pred[:, :oob].reshape(3, H, W),
            "mask_at_box": mask[:oob],
            "ray_pix_idx": rd["pix_idx"],
            "ray_ok": ray_ok,
            "overflows": torch.stack(
                [rd["ray_overflow"], stats["perray_overflow"], zero, zero]
            ),
            "counts": torch.stack(
                [ray_ok.sum(), stats["n_sigma"], stats["n_rgb"]]
            ),
            "can_bounds": rd["can_bounds"],
        }

    # ------------------------------------------------------------------
    def _splat_pixels(self, pts_w, row_ok, batch, H, W):
        """Mark each occupied voxel's 4 neighboring target pixels. Returns
        (pixmask (H*W,) int32, (minx, miny) floor pixel per voxel)."""
        tp = batch["target_pose"]
        cam = pts_w @ tp[:, :3].T + tp[:, 3]
        pix = cam @ batch["target_K"].T
        z = pix[:, 2:3]
        z = torch.where(z.abs() < 1e-9, 1e-9, z)
        xy = pix[:, :2] / z
        minx = torch.floor(xy[:, 0]).long().clamp(0, W - 1)
        miny = torch.floor(xy[:, 1]).long().clamp(0, H - 1)
        maxx = (minx + 1).clamp(0, W - 1)
        maxy = (miny + 1).clamp(0, H - 1)
        pixmask = torch.zeros(H * W + 1, dtype=torch.int32, device=pts_w.device)
        for yy, xx in ((miny, minx), (maxy, minx), (miny, maxx), (maxy, maxx)):
            pixmask[torch.where(row_ok, yy * W + xx, H * W)] = 1
        return pixmask[:-1], minx, miny

    def _splat_bins(self, pts_w, row_ok, batch, H, W, can_bounds, minx, miny):
        """Per-pixel depth-bin occupancy (H*W, S) u8: bin s of pixel p is
        set iff an occupied voxel covers sample s of p's 64-grid, dilated
        over a 5-bin depth span and [-1, +2] pixels in x and y."""
        S = self.n_samples
        tp = batch["target_pose"]
        depth = pts_w @ tp[2, :3] + tp[2, 3]
        xy1 = torch.stack([minx, miny, torch.ones_like(minx)], dim=-1).float()
        ro, rd = pixel_rays(xy1, batch["target_K_inv"], tp[:, :3], tp[:, 3:])
        near, far, mask_box = ray_aabb_near_far(ro, rd, can_bounds)
        dz = ((far - near) / (S - 1)).clamp_min(1e-9)
        rad = float(np.float32(self.bin_margin_voxels) * np.float32(self.voxel_size[0]))
        b0 = torch.floor((depth - rad - near) / dz).long()
        ok = row_ok & mask_box & (b0 < S)
        binimg = torch.zeros(H * W * S + 1, dtype=torch.uint8, device=pts_w.device)
        binimg[torch.where(ok, (miny * W + minx) * S + b0.clamp(0, S - 1), H * W * S)] = 1
        bi = binimg[:-1].reshape(H, W, S)
        acc = bi.clone()
        for j in (1, 2, 3, 4, 5):
            acc[..., j:] |= bi[..., : S - j]
        ax = acc.clone()
        for j in (-1, 1, 2):
            ax |= torch.roll(acc, j, 1)
        ay = ax.clone()
        for j in (-1, 1, 2):
            ay |= torch.roll(ax, j, 0)
        return ay.reshape(H * W, S)

    def _frame_stage(self, batch, featmaps):
        """Volume, occupancy, gather tables, tight AABB, splats, rays and
        near/far. Returns (pre, tables, rays)."""
        dt = self.compute_dtype
        dev = featmaps.device
        src_unnorm = src_norm(batch["src_imgs"]) * 0.5 + 0.5
        pre = prepare_frame(batch, featmaps, self.max_out_sh)
        H, W = batch["tar_img"].shape[0:2]
        grids = pre["grids"]
        o = np.asarray(pre["out_sh"])

        # (2) volume + occupancy
        level_feats = self.nerfhead.volume(pre["smpl_feat"], pre["vertex_rows"], grids)
        vols = [None] + [scatter_dense(level_feats[i], grids[i + 1]) for i in (1, 2, 3)]
        masks3d = occupancy_volume(level_feats, grids)
        featmaps = rounded(featmaps, dt)
        src_unnorm = rounded(src_unnorm, dt)
        vols = [None] + [rounded(v, dt) for v in vols[1:]]

        # (3) gather tables. Coarse levels 2-4 merge onto the level-2 grid,
        # out_geometry_fc's coarse block is folded in (trilinear commutes
        # with the linear map), and the folded field is resampled onto the
        # level-1 grid and int8-quantized as a nearest table.
        sh2 = tuple(vols[1].shape[:3])
        combined = torch.cat(
            [
                vols[1].float(),
                resample_volume_to(vols[2], sh2, o // 4, o // 8),
                resample_volume_to(vols[3], sh2, o // 4, o // 16),
            ],
            dim=-1,
        )
        nch1 = self.nerfhead.spconv_out_dim[0]
        w_coarse = self.nerfhead.sigmahead.out_geometry_fc[0].weight[:, nch1:].T
        combined = torch.einsum("dhwc,co->dhwo", combined, w_coarse.float())
        g1 = grids[1]
        rows0 = torch.where(g1.valid[:, None], level_feats[0], 0.0)
        q_rows, sc0 = quantize_volume_u8(rows0)
        octet_l1 = build_octet_table_scatter(q_rows, g1.coords, g1.valid, g1.shape)
        vol = resample_volume_to(combined, g1.shape, o // 2, o // 4)
        q, sc1 = quantize_image_i8(vol)
        coarse = NearestTable(q.reshape(-1, q.shape[-1]), tuple(vol.shape[:3]), 2)
        # merged [rgb|feat] quad table at the feature grid, int8
        Hf, Wf = featmaps.shape[1:3]
        src_low = upsample_image_align_corners(src_unnorm.float(), Hf, Wf)
        qc, proj_scale = quantize_image_i8(torch.cat([src_low, featmaps.float()], dim=-1))
        src_quad = build_quad_table_2d(qc)

        # (4) occupied level-1 voxels -> world points, tight AABB
        vs = torch.tensor(self.voxel_size, dtype=torch.float32, device=dev)
        D1, H1, W1 = masks3d.shape
        c = g1.coords
        mval = masks3d[c[:, 0].clamp(0, D1 - 1), c[:, 1].clamp(0, H1 - 1),
                       c[:, 2].clamp(0, W1 - 1)]
        row_ok = g1.valid & (mval > OCCUPANCY_THRESHOLD)
        can_pts = c.flip(-1).float() * 2.0 * vs + batch["bounds"][0]
        pts_w = can_pts @ batch["Rh"].T + batch["Th"].reshape(1, 3)
        okc = row_ok[:, None]
        min_xyz = torch.where(okc, pts_w, 1e9).amin(dim=0)
        max_xyz = torch.where(okc, pts_w, -1e9).amax(dim=0)
        dzv = torch.tensor([0.0, 0.0, 0.05], device=dev)
        can_bounds = torch.stack([min_xyz - dzv, max_xyz + dzv])

        # pixel splat + one 4-neighborhood dilation, ray compaction
        pixmask, minx, miny = self._splat_pixels(pts_w, row_ok, batch, H, W)
        pm = pixmask.reshape(H, W)
        pm = (pm | torch.roll(pm, 1, 0) | torch.roll(pm, -1, 0)
              | torch.roll(pm, 1, 1) | torch.roll(pm, -1, 1))
        oob = H * W
        pix_idx, ray_ok, ray_overflow = _compact(pm.reshape(-1) > 0, self.ray_cap)
        safe = pix_idx.clamp_max(oob - 1)
        xy1 = torch.stack([safe % W, safe // W, torch.ones_like(safe)], dim=-1).float()
        tp = batch["target_pose"]
        rays_o, rays_d = pixel_rays(xy1, batch["target_K_inv"], tp[:, :3], tp[:, 3:])
        near, far, mask_at_box = ray_aabb_near_far(rays_o, rays_d, can_bounds)
        ray_ok = ray_ok & mask_at_box
        bins = self._splat_bins(pts_w, row_ok, batch, H, W, can_bounds, minx, miny)[safe]
        tables = {
            "octet_l1": octet_l1,
            "coarse": coarse,
            "octet_scales": (sc0, sc1),
            "src_quad": src_quad,
            "proj_scale": proj_scale,
        }
        rays = {
            "rays_o": rays_o, "rays_d": rays_d, "near": near, "far": far,
            "ray_ok": ray_ok, "pix_idx": pix_idx, "ray_overflow": ray_overflow,
            "can_bounds": can_bounds, "bins": bins,
        }
        return pre, tables, rays

    def _ray_pipeline(self, batch, pre, tables, rd):
        """Splat-bin cull, per-ray K-slot compaction over the dense (K, R)
        slot frame, point stages, composite."""
        S, K = self.n_samples, self.samples_per_ray
        rays_o, rays_d, ray_ok = rd["rays_o"], rd["rays_d"], rd["ray_ok"]
        nr = rays_o.shape[0]
        ok = (rd["bins"].T > 0) & ray_ok[None, :]  # (S, R)
        cum = torch.cumsum(ok.int(), dim=0)
        # slot k of a ray holds the sample index of its (k+1)-th occupied
        # sample (S when it has fewer): the nearest K survivors are kept
        ks = torch.arange(K, device=cum.device)[:, None, None]
        slot_rel = (cum[None] <= ks).sum(dim=1)  # (K, R)
        slot_valid = slot_rel < S
        perray_overflow = (cum[-1] - K).clamp_min(0).sum()
        t = slot_rel.clamp_max(S - 1).float() / float(S - 1)
        z = rd["near"][None, :] * (1.0 - t) + rd["far"][None, :] * t
        pts_c = torch.stack(
            [rays_o[None, :, i] + rays_d[None, :, i] * z for i in range(3)], dim=-1
        ).reshape(-1, 3)
        dhw_c = points_to_dhw_vox(pts_c, batch, self.voxel_size)
        alpha, rgb = self._point_stages(batch, pre, tables, pts_c, dhw_c,
                                        slot_valid.reshape(-1))
        alpha_kr = alpha.reshape(K, nr)
        trans = torch.cat(
            [alpha_kr.new_ones(1, nr),
             torch.cumprod(1.0 - alpha_kr[:-1] + 1e-10, dim=0)],
            dim=0,
        )
        w = alpha_kr * trans
        rgb_kr = rgb.T.reshape(3, K, nr)
        rgb_map = torch.stack([(w * rgb_kr[c]).sum(dim=0) for c in range(3)], dim=-1)
        rgb_map = torch.where(ray_ok[:, None], rgb_map, 0.0)
        stats = {
            "perray_overflow": perray_overflow,
            "n_sigma": slot_valid.sum(),
            "n_rgb": (alpha > 1e-14).sum(),
        }
        return rgb_map, stats

    def _point_stages(self, batch, pre, tables, pts_c, dhw_c, sig_ok):
        """Geometry-row and projection-row gathers, then the point-stage
        kernel. Returns alpha (P,) sigma-masked and rgb (P, 3) alpha-culled."""
        out_sh = torch.tensor(pre["out_sh"], device=dhw_c.device)
        frac = dhw_c / out_sh.float()
        size0 = out_sh // 2
        g0, gw0 = octet_rows_and_weights(tables["octet_l1"], frac * (size0 - 1).float(), size0)
        coarse = tables["coarse"]
        size1 = out_sh // coarse.div
        g1, gw1 = nearest_row_and_weight(coarse, frac * (size1 - 1).float(), size1)
        sc0, sc1 = tables["octet_scales"]
        geom_tabs = (
            (g0, gw0.T.contiguous(), sc0),
            (g1, gw1.T.contiguous(), sc1),
        )
        Hs, Ws = batch["src_imgs"].shape[1:3]
        rows, w4, vmask = project_gather_rows_merged(
            pts_c, pre["KE"], tables["src_quad"], Hs, Ws
        )
        weights = pack_head_weights(
            self.nerfhead, fold_nch=self.nerfhead.spconv_out_dim[0]
        )
        return fused_point_stages(
            rows, w4, tables["proj_scale"], geom_tabs, vmask, sig_ok, weights
        )


def build_render(cfg, device="cuda"):
    """The fast-mode progressive renderer for `cfg` on `device`, with
    untrained parameters (load weights with train/checkpoint.py)."""
    for key, val in FAST_MODE.items():
        if cfg.tpu[key] != val:
            raise NotImplementedError(
                f"tpu.{key}={cfg.tpu[key]!r}: the port implements the fast "
                f"mode only ({key}={val!r})"
            )
    if "thuman" in cfg.dataset.test.name:
        raise NotImplementedError("neg-ray (THuman) rendering is not ported")
    if not cfg.head.rgb.use_rgbhead:
        raise NotImplementedError("the mesh path (use_rgbhead False) is not ported")
    dtypes = {"bfloat16": torch.bfloat16, "float32": None}
    if cfg.tpu.matmul_dtype not in dtypes:
        raise NotImplementedError(f"tpu.matmul_dtype={cfg.tpu.matmul_dtype!r}")
    dt = dtypes[cfg.tpu.matmul_dtype]
    encoder = ResUNet(cfg.encoder.out_ch, cfg.encoder.name, dt)
    nerfhead = NeRFHead(
        in_feat_ch=cfg.encoder.out_ch,
        n_smpl=cfg.head.sigma.n_smpl,
        code_dim=cfg.head.sigma.code_dim,
        attn_n_heads=cfg.head.sigma.n_heads,
        spconv_n_layers=cfg.head.sigma.n_layers,
        spconv_out_dim=tuple(cfg.head.sigma.outdims),
        compute_dtype=dt,
    )
    r = Renderer(
        encoder,
        nerfhead,
        voxel_size=tuple(cfg.dataset.voxel_size),
        n_samples=cfg.train.n_samples,
        samples_per_ray=cfg.tpu.samples_per_ray,
        ray_cap=cfg.tpu.ray_cap,
        bin_margin_voxels=cfg.tpu.bin_margin_voxels,
        max_out_sh=tuple(cfg.tpu.max_out_sh),
        compute_dtype=dt,
    )
    return r.to(device).eval()


register("render", "DemoRender", build_render)
