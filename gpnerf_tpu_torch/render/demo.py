"""The geometry-guided progressive renderer (gpnerf_tpu/render/demo.py
`Renderer.render_demo_fn`; the paper's progressive pipeline, reference
demo_render.py:96-498) in its shipped "fast" mode and in its
reference-semantics mode.

Per frame:
  1. encode the V source views (ResUNet);
  2. fuse the SMPL vertex codes, run the sparse conv stack once, derive the
     occupancy field `masks3d`;
  3. build the gather tables: the u8 level-1 octet table (corner-scattered
     from the active rows), the folded merged-coarse field (out_geometry_fc's
     coarse block pre-applied) resampled onto the level-1 grid as an int8
     nearest table, and the projection tables — fast mode: one int8
     [rgb|feat] quad table of the source rgb downsampled to the feature
     grid; reference mode: the split pair, the raw u8 source pixels at full
     resolution (dequant 1/255) and the int8 (or int4 split-packed) encoder
     features on their own grid;
  4. splat occupied level-1 voxels into the target view and compact the hit
     pixels to `ray_cap` rays. Fast mode (`tight_cull`): the level-1 active
     set, a dilated pixel mask and per-pixel depth-bin masks on the
     64-sample grid (the occupancy cull). Reference mode: every voxel of
     the sum-over-levels occupancy blanket (compacted to `splat_cap` rows
     first), no pixel dilation, and a one-voxel-dilated u8 occupancy volume
     `occb` for the per-sample tap;
  5. cull the 64 samples of each ray (bin masks, or a nearest tap of `occb`)
     and keep the first K occupied ones in a slot-major (K, R) frame, all
     K*R slots evaluated; reference mode has K = 64, so nothing is dropped.
     Its windowless `frame_mode` skips tap and slots: the frame is the
     whole sample grid and the cull is the kernel's trilinear level-1
     occupancy (`occ_geom`), which `sigma_query_cull` also applies on top
     of the tap;
  6. project + gather the quad rows and geometry rows (or, with
     `kernel_octet` off, query the geometry feature in torch ops), run the
     point-stage kernel (ops/point_stages.py), composite front to back,
     scatter the rays into the image.

`build_render` accepts the fast mode, the reference mode, the reference mode
with one of `frame_mode`, `sigma_query_cull`, `int4_feat`, and either mode
with `kernel_octet` off; any other renderer switch raises
NotImplementedError naming the key.

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
from gpnerf_tpu_torch.models.sparse_net import SparseConvNet, occupancy_volume
from gpnerf_tpu_torch.ops.grid_sample import (
    NearestTable,
    build_octet_table_scatter,
    build_quad_table_2d,
    nearest_row_and_weight,
    octet_rows_and_weights,
    quantize_image_i4,
    quantize_image_i8,
    quantize_volume_u8,
    resample_volume_to,
    upsample_image_align_corners,
)
from gpnerf_tpu_torch.ops.point_stages import fused_point_stages_tabs, pack_head_weights
from gpnerf_tpu_torch.ops.projection import project_gather_rows_merged
from gpnerf_tpu_torch.ops.rays import pixel_rays, ray_aabb_near_far
from gpnerf_tpu_torch.ops.sparse_conv import scatter_dense
from gpnerf_tpu_torch.registry import register
from gpnerf_tpu_torch.render.base import points_to_dhw_vox, prepare_frame, src_norm

# Renderer switches (configs/synthetic.yaml over config/default.py) and the
# values the port implements: COMMON in every mode; FAST_MODE with
# tight_cull on; REF_MODE (the reference-semantics mode: blanket cull, all
# samples kept, no tap window, split projection tables) with it off, where
# at most one of REF_VARIANTS leaves its default. `kernel_octet` is free in
# both modes. `splat_bins` is inert without tight_cull, as in the JAX package.
COMMON = {
    "quantize_volume": True,
    "merge_coarse_octet": True,
    "fold_coarse_fc": True,
    "int4_coarse": False,
    "coarse_nearest": 2,
    "l1_nearest": 0,
    "dense_conv": False,
    "merge_src_feat": False,
    "dense_slots": True,
    "quantize_proj": True,
    "pack_octet_u32": False,
    "pallas_point": True,
}
FAST_MODE = {
    "merge_lowres_src": True,
    "frame_mode": False,
    "splat_bins": True,
    "sigma_query_cull": False,
    "int4_feat": False,
}
REF_MODE = {"merge_lowres_src": False, "tap_window": 0}
REF_VARIANTS = {
    "frame_mode": False,
    "sigma_query_cull": False,
    "int4_feat": False,
    "kernel_octet": True,
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
                 max_out_sh=(96, 320, 224), compute_dtype=None,
                 tight_cull=True, splat_cap=0, frame_mode=False,
                 sigma_query_cull=False, int4_feat=False, kernel_octet=True):
        super().__init__()
        if not tight_cull and samples_per_ray != n_samples:
            raise NotImplementedError(
                "the blanket cull (tight_cull off) is ported with all "
                f"{n_samples} samples kept, not samples_per_ray={samples_per_ray}")
        if tight_cull and (frame_mode or sigma_query_cull or int4_feat):
            raise NotImplementedError(
                "frame_mode, sigma_query_cull and int4_feat are ported for "
                "the blanket cull (tight_cull off) only")
        if not kernel_octet and (frame_mode or sigma_query_cull):
            raise NotImplementedError(
                "the trilinear occupancy cull (frame_mode, sigma_query_cull) "
                "is ported in its in-kernel form only (kernel_octet on)")
        # tight_cull: splat and cull against the level-1 occupancy (fast
        # mode); off: against the sum-over-levels blanket, compacted to
        # splat_cap voxels (0 = dense walk), with split projection tables
        self.tight_cull = bool(tight_cull)
        self.splat_cap = int(splat_cap)
        self.frame_mode = bool(frame_mode)
        self.sigma_query_cull = bool(sigma_query_cull)
        self.int4_feat = bool(int4_feat)
        self.kernel_octet = bool(kernel_octet)
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

    def _occupied_world_pts(self, masks3d, batch, vs):
        """The reference's dense occupied-voxel walk (demo_render.py:166-175):
        every voxel of the sum-over-levels occupancy field above threshold,
        mapped to world space. Returns (pts_w (N, 3), row_ok (N,))."""
        _, H1, W1 = masks3d.shape
        idx = torch.arange(masks3d.numel(), device=masks3d.device)
        vox_xyz = torch.stack([idx % W1, (idx // W1) % H1, idx // (H1 * W1)], dim=-1)
        can_pts = vox_xyz.float() * 2.0 * vs + batch["bounds"][0]
        pts_w = can_pts @ batch["Rh"].T + batch["Th"].reshape(1, 3)
        return pts_w, (masks3d > OCCUPANCY_THRESHOLD).reshape(-1)

    def _frame_stage(self, batch, featmaps):
        """Volume, occupancy, gather tables, AABB of the occupied voxels,
        splats, rays and near/far. Returns (pre, tables, rays)."""
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
        tables = {"octet_l1": octet_l1, "coarse": coarse, "octet_scales": (sc0, sc1)}
        if self.tight_cull:
            # merged [rgb|feat] quad table at the feature grid, int8
            Hf, Wf = featmaps.shape[1:3]
            src_low = upsample_image_align_corners(src_unnorm.float(), Hf, Wf)
            qc, tables["proj_scale"] = quantize_image_i8(
                torch.cat([src_low, featmaps.float()], dim=-1))
            tables["src_quad"] = build_quad_table_2d(qc)
        else:
            # split tables (reference semantics: rgb at full source
            # resolution, demo_render.py:586): the raw u8 pixels with a 1/255
            # dequant after the bilinear sum, and the quantized encoder
            # features on their own grid
            if batch["src_imgs"].dtype != torch.uint8:
                raise NotImplementedError(
                    "the split source table stores the uint8 pixels the data "
                    f"pipeline yields, got {batch['src_imgs'].dtype}")
            tables["src_quad"] = build_quad_table_2d(batch["src_imgs"])
            tables["src_scale"] = torch.full((3,), 1.0 / 255.0, device=dev)
            quantize = quantize_image_i4 if self.int4_feat else quantize_image_i8
            qf, tables["feat_scale"] = quantize(featmaps.float())
            tables["feat_quad"] = build_quad_table_2d(qf)

        # (4) occupied voxels -> world points and their AABB
        vs = torch.tensor(self.voxel_size, dtype=torch.float32, device=dev)
        tables["voxel_size"] = vs
        splat_overflow = 0
        if self.tight_cull:
            # the level-1 active set (occupied voxels are a subset of it)
            D1, H1, W1 = masks3d.shape
            c = g1.coords
            mval = masks3d[c[:, 0].clamp(0, D1 - 1), c[:, 1].clamp(0, H1 - 1),
                           c[:, 2].clamp(0, W1 - 1)]
            row_ok = g1.valid & (mval > OCCUPANCY_THRESHOLD)
            can_pts = c.flip(-1).float() * 2.0 * vs + batch["bounds"][0]
            pts_w = can_pts @ batch["Rh"].T + batch["Th"].reshape(1, 3)
        else:
            pts_w, row_ok = self._occupied_world_pts(masks3d, batch, vs)
        okc = row_ok[:, None]
        min_xyz = torch.where(okc, pts_w, 1e9).amin(dim=0)
        max_xyz = torch.where(okc, pts_w, -1e9).amax(dim=0)
        dzv = torch.tensor([0.0, 0.0, 0.05], device=dev)
        can_bounds = torch.stack([min_xyz - dzv, max_xyz + dzv])
        if not self.tight_cull and self.splat_cap:
            # compact the blanket's occupied voxels before the splat
            # scatters; exact when drop-free, and a drop is counted into
            # ray_overflow (a dropped voxel can lose pixels)
            sidx, row_ok, splat_overflow = _compact(row_ok, self.splat_cap)
            pts_w = pts_w[sidx.clamp_max(pts_w.shape[0] - 1)]

        # pixel splat, ray compaction
        pixmask, minx, miny = self._splat_pixels(pts_w, row_ok, batch, H, W)
        pm = pixmask.reshape(H, W)
        if self.tight_cull:
            # level-1 voxel spacing can project to > 2 px at close range; one
            # 4-neighborhood dilation closes the gaps the dense walk never has
            pm = (pm | torch.roll(pm, 1, 0) | torch.roll(pm, -1, 0)
                  | torch.roll(pm, 1, 1) | torch.roll(pm, -1, 1))
        oob = H * W
        pix_idx, ray_ok, ray_overflow = _compact(pm.reshape(-1) > 0, self.ray_cap)
        ray_overflow = ray_overflow + splat_overflow
        safe = pix_idx.clamp_max(oob - 1)
        xy1 = torch.stack([safe % W, safe // W, torch.ones_like(safe)], dim=-1).float()
        tp = batch["target_pose"]
        rays_o, rays_d = pixel_rays(xy1, batch["target_K_inv"], tp[:, :3], tp[:, 3:])
        near, far, mask_at_box = ray_aabb_near_far(rays_o, rays_d, can_bounds)
        ray_ok = ray_ok & mask_at_box
        bins = None
        if self.tight_cull:
            bins = self._splat_bins(pts_w, row_ok, batch, H, W, can_bounds, minx, miny)[safe]
        else:
            # occupancy-cull byte volume, one-voxel dilated (_occupancy_tap)
            occb = masks3d > 0
            for ax in range(3):
                occb = occb | torch.roll(occb, 1, ax) | torch.roll(occb, -1, ax)
            tables["occb"] = occb.to(torch.uint8)
        rays = {
            "rays_o": rays_o, "rays_d": rays_d, "near": near, "far": far,
            "ray_ok": ray_ok, "pix_idx": pix_idx, "ray_overflow": ray_overflow,
            "can_bounds": can_bounds, "bins": bins,
        }
        return pre, tables, rays

    def _occupancy_tap(self, batch, pre, tables, rd):
        """The blanket cull (demo_render.py:270-283, equivalent-or-looser):
        sample s of ray r survives iff the nearest level-1 voxel of the
        one-voxel-dilated occupancy volume is set. Positions are computed per
        ray as (S, R) component planes. Returns (S, R) bool. (The JAX
        package gathers u32 words and shifts the byte out, a TPU gather
        workaround; here the tap reads the byte directly.)"""
        S = self.n_samples
        occb = tables["occb"]
        rays_o, rays_d = rd["rays_o"], rd["rays_d"]
        dev = rays_o.device
        t = torch.arange(S, dtype=torch.float32, device=dev)[:, None] / torch.full(
            (), float(S - 1), device=dev)
        z = rd["near"][None, :] * (1.0 - t) + rd["far"][None, :] * t  # (S, R)
        Rh, Th = batch["Rh"], batch["Th"].reshape(3)
        min_xyz, vs, out_sh = batch["bounds"][0], tables["voxel_size"], pre["out_sh"]
        cells, inb = [], None
        for j in (2, 1, 0):  # dhw component j = canonical axis (2 - j)
            can = None
            for i in range(3):
                term = (rays_o[None, :, i] + rays_d[None, :, i] * z - Th[i]) * Rh[i, 2 - j]
                can = term if can is None else can + term
            size1 = out_sh[j] // 2
            scale1 = float(np.float32(size1 - 1) / np.float32(out_sh[j]))
            cell = torch.round((can - min_xyz[2 - j]) / vs[2 - j] * scale1).long()
            ok = (cell >= 0) & (cell < size1)
            inb = ok if inb is None else inb & ok
            cells.append(cell.clamp(0, occb.shape[j] - 1))
        _, H1, W1 = occb.shape
        flat = (cells[2] * H1 + cells[1]) * W1 + cells[0]
        return (occb.reshape(-1)[flat] > 0) & inb & rd["ray_ok"][None, :]

    def _ray_pipeline(self, batch, pre, tables, rd):
        """Sample cull (splat bins, or the occupancy tap), per-ray K-slot
        compaction over the dense (K, R) slot frame — or, in frame mode, the
        whole (S, R) sample grid with the cull left to the kernel — then
        point stages and composite."""
        S, K = self.n_samples, self.samples_per_ray
        rays_o, rays_d, ray_ok = rd["rays_o"], rd["rays_d"], rd["ray_ok"]
        nr = rays_o.shape[0]
        dev = rays_o.device
        s_max = torch.full((), float(S - 1), device=dev)
        n_sigma = None
        if self.frame_mode:
            # windowless frame (K == S): no tap, no rank compaction; the
            # trilinear level-1 occupancy cull comes from the kernel
            slot = torch.arange(K, dtype=torch.float32, device=dev)[:, None].expand(K, nr)
            sig_ok = ray_ok[None, :].expand(K, nr)
            perray_overflow = torch.zeros((), dtype=torch.long, device=dev)
            mask_from_query = True
        else:
            if rd["bins"] is not None:
                ok = (rd["bins"].T > 0) & ray_ok[None, :]  # (S, R)
            else:
                ok = self._occupancy_tap(batch, pre, tables, rd)
            cum = torch.cumsum(ok.int(), dim=0)
            # slot k of a ray holds the sample index of its (k+1)-th occupied
            # sample (S when it has fewer): the nearest K survivors are kept.
            # The index is the count of samples with cum <= k, found per ray
            # by binary search in the non-decreasing cum.
            ks = torch.arange(K, dtype=cum.dtype, device=dev).repeat(nr, 1)
            slot_rel = torch.searchsorted(cum.T.contiguous(), ks, right=True).T  # (K, R)
            sig_ok = slot_rel < S
            n_sigma = sig_ok.sum()
            perray_overflow = (cum[-1] - K).clamp_min(0).sum()
            slot = slot_rel.clamp_max(S - 1).float()
            mask_from_query = self.sigma_query_cull
        t = slot / s_max
        z = rd["near"][None, :] * (1.0 - t) + rd["far"][None, :] * t
        pts_c = torch.stack(
            [rays_o[None, :, i] + rays_d[None, :, i] * z for i in range(3)], dim=-1
        ).reshape(-1, 3)
        dhw_c = points_to_dhw_vox(pts_c, batch, self.voxel_size)
        alpha, rgb, sig_ok = self._point_stages(
            batch, pre, tables, pts_c, dhw_c, sig_ok.reshape(-1), mask_from_query)
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
            # frame mode counts the samples that passed the kernel's cull
            "n_sigma": sig_ok.sum() if n_sigma is None else n_sigma,
            "n_rgb": (alpha > 1e-14).sum(),
        }
        return rgb_map, stats

    def _point_stages(self, batch, pre, tables, pts_c, dhw_c, sig_ok, mask_from_query):
        """Geometry-row and projection-row gathers, then the point-stage
        kernel. Returns alpha (P,) sigma-masked, rgb (P, 3) alpha-culled and
        sig_ok with the kernel's occupancy verdict folded in."""
        out_sh = torch.tensor(pre["out_sh"], device=dhw_c.device)
        sc0, sc1 = tables["octet_scales"]
        coarse = tables["coarse"]
        geom_tabs, feats = (), None
        if self.kernel_octet:
            # raw quantized rows + corner weights: the kernel lerps them
            frac = dhw_c / out_sh.float()
            size0 = out_sh // 2
            g0, gw0 = octet_rows_and_weights(tables["octet_l1"], frac * (size0 - 1).float(), size0)
            size1 = out_sh // coarse.div
            g1, gw1 = nearest_row_and_weight(coarse, frac * (size1 - 1).float(), size1)
            geom_tabs = (
                (g0, gw0.T.contiguous(), sc0),
                (g1, gw1.T.contiguous(), sc1),
            )
        else:
            feats = SparseConvNet.query_octet2(
                tables["octet_l1"], coarse, dhw_c, out_sh, scales=(sc0, sc1))
        Hs, Ws = batch["src_imgs"].shape[1:3]
        rows, w4, vmask = project_gather_rows_merged(
            pts_c, pre["KE"], tables["src_quad"], Hs, Ws
        )
        if "feat_quad" in tables:
            # split tables, both lerped in the kernel; the view mask is
            # projection-only and the same for both
            rows_f, w4_f, _ = project_gather_rows_merged(
                pts_c, pre["KE"], tables["feat_quad"], Hs, Ws, batched=True
            )
            tabs = ((rows, w4, tables["src_scale"]), (rows_f, w4_f, tables["feat_scale"]))
        else:
            tabs = ((rows, w4, tables["proj_scale"]),)
        weights = pack_head_weights(
            self.nerfhead, fold_nch=self.nerfhead.spconv_out_dim[0]
        )
        # mask_from_query: the kernel derives the reference's `sp_feats > 0`
        # cull (demo_render.py:294) from the lerped level-1 block
        outs = fused_point_stages_tabs(
            tabs, feats, vmask, sig_ok, weights, geom_tabs=geom_tabs,
            occ_geom=mask_from_query,
        )
        if mask_from_query:
            sig_ok = sig_ok & (outs[2] > 0.5)
        return outs[0], outs[1], sig_ok


def check_mode(cfg):
    """Raise NotImplementedError, naming the key, for a renderer switch
    outside the modes the port implements (see COMMON above)."""
    t = cfg.tpu

    def need(table, mode):
        for key, val in table.items():
            if t[key] != val:
                raise NotImplementedError(
                    f"tpu.{key}={t[key]!r}: the port's {mode} needs {key}={val!r}")

    need(COMMON, "renderer")
    if t.tight_cull:
        need(FAST_MODE, "fast mode (tight_cull on)")
        return
    need(REF_MODE, "reference mode (tight_cull off)")
    if t.samples_per_ray != cfg.train.n_samples:
        raise NotImplementedError(
            f"tpu.samples_per_ray={t.samples_per_ray}: the port's reference mode "
            f"keeps all train.n_samples={cfg.train.n_samples} samples")
    on = [k for k, v in REF_VARIANTS.items() if t[k] != v]
    if len(on) > 1:
        raise NotImplementedError(
            f"tpu.{on[1]}={t[on[1]]!r} together with tpu.{on[0]}={t[on[0]]!r}: the "
            "port renders one variant of the reference mode at a time")


def build_render(cfg, device="cuda"):
    """The progressive renderer for `cfg` on `device` in the mode its
    switches select, with untrained parameters (load weights with
    train/checkpoint.py)."""
    check_mode(cfg)
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
        tight_cull=cfg.tpu.tight_cull,
        splat_cap=cfg.tpu.splat_cap,
        frame_mode=cfg.tpu.frame_mode,
        sigma_query_cull=cfg.tpu.sigma_query_cull,
        int4_feat=cfg.tpu.int4_feat,
        kernel_octet=cfg.tpu.kernel_octet,
    )
    return r.to(device).eval()


register("render", "DemoRender", build_render)
