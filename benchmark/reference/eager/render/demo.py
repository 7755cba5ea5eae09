# Frozen copy of gpnerf_tpu_torch/render/demo.py at commit ffa1347, the benchmark's plain
# reference: the port's hand-written kernels, registries and the paths no
# configuration of the benchmark runs are removed; nothing here is imported
# from the program.
"""The geometry-guided progressive renderer, op by op: the port's
render/demo.py `Renderer` without its fused point-stage path, its quad-lerp
kernel route, its entry points other than `render_demo`, its profiler and
its mesh branch.

Per frame: encode the source views; fuse the SMPL vertex codes and run the
sparse conv stack, derive the occupancy field; build the geometry and
projection tables (quantized as the configuration states); splat the
occupied voxels into the target view and compact the hit pixels to
`ray_cap` rays; cull each ray's samples (splat bins under the tight cull,
the occupancy tap otherwise) and keep the first `samples_per_ray` in a
slot-major frame; run the point stages op by op (projection samplers, the
sigma query, mean and variance over the views, the density and color
heads); composite front to back and scatter the rays into the image.
Index compactions and scatters write through one spare slot that absorbs
dropped entries."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from benchmark.reference.eager.models.heads import fused_mean_variance
from benchmark.reference.eager.models.layers import cast
from benchmark.reference.eager.models.sparse_net import (
    occupancy_volume,
    occupancy_volume_dense,
    sparse_net_dense_eval,
)
from benchmark.reference.eager.ops.grid_sample import (
    Int4Table,
    NearestTable,
    build_octet_table_3d,
    build_octet_table_3d_u32,
    build_octet_table_scatter,
    build_quad_table_2d,
    interleave_midpoints_3d,
    quantize_image_i4,
    quantize_image_i8,
    quantize_volume_i4,
    quantize_volume_u8,
    resample_volume_to,
    upsample_image_align_corners,
)
from benchmark.reference.eager.ops.projection import (
    project_and_gather_quad,
    project_and_gather_quad_merged,
)
from benchmark.reference.eager.ops.rays import pixel_rays, ray_aabb_near_far
from benchmark.reference.eager.ops.sparse_conv import _gather_rows, scatter_dense, scatter_dense_rows
from benchmark.reference.eager.render.base import (
    points_to_dhw_vox,
    prepare_frame,
    src_norm,
)

# The geometry-table switches (`Renderer._geometry_tables`); `build_render`
# hands them to the constructor by name.
GEOMETRY_SWITCHES = ("quantize_volume", "merge_coarse_octet", "fold_coarse_fc", "int4_coarse",
                     "coarse_nearest", "l1_nearest", "pack_octet_u32", "dense_conv")

# the names a render can stop after, in pipeline order (Renderer.profile)
FRAME_STOPS = ("pre", "codes", "fuse", "occv", "volume", "rays")
RAY_STOPS = ("cull_occ", "cull_slots", "cull_compact")
POINT_STOPS = ("cull", "sigma_q", "meanvar", "sigma", "rgb")
STOP_STAGES = FRAME_STOPS + RAY_STOPS + POINT_STOPS
# the prefixes Renderer.profile times; None is the whole render
PROFILE_LADDER = ("volume", "rays", "cull_occ", "cull_compact", "cull",
                  "sigma_q", "sigma", None)
# the op-by-op heads run over chunks of this many points: the color head's
# (P, V, 105) activations are several GB at the reference mode's P
HEAD_CHUNK = 1 << 20

# level-1 voxels whose occupancy (masks3d) exceeds this splat into the view
OCCUPANCY_THRESHOLD = 0.1
# the front depth of a pixel no occupied voxel splats onto
_ZFAR = 1e9


def pred_img_hwc(ret):
    """Host-side (H, W, 3) numpy image of a render dict (`pred_img`, or the
    channel planes `pred_chw`)."""
    if "pred_img" in ret:
        return ret["pred_img"].detach().cpu().numpy()
    return ret["pred_chw"].detach().permute(1, 2, 0).cpu().numpy()


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


def _occupied_bounds(pts_w, row_ok):
    """The world AABB (2, 3) of the occupied points, padded by 0.05 in z
    (demo_render.py:168-175)."""
    okc = row_ok[:, None]
    dzv = torch.tensor([0.0, 0.0, 0.05], device=pts_w.device)
    return torch.stack([torch.where(okc, pts_w, 1e9).amin(dim=0) - dzv,
                        torch.where(okc, pts_w, -1e9).amax(dim=0) + dzv])


def _scatter_rows(v, idx, n):
    """(n, ...) zeros with v's rows at idx; indices >= n are dropped (JAX's
    `.at[idx].set(v, mode="drop")` for the fill index n)."""
    out = v.new_zeros((n + 1,) + v.shape[1:])
    out[idx.clamp_max(n)] = v
    return out[:n]


class Renderer(nn.Module):
    """Progressive renderer; its `encoder` and `nerfhead` children carry the
    reference checkpoint's parameter names."""

    def __init__(self, encoder, nerfhead, *, voxel_size, n_samples=64,
                 samples_per_ray=13, ray_cap=24576, bin_margin_voxels=2.0,
                 max_out_sh=(96, 320, 224), compute_dtype=None,
                 tight_cull=True, splat_cap=0, frame_mode=False,
                 sigma_query_cull=False, int4_feat=False, kernel_octet=True,
                 pallas_point=True, pallas_lerp=True, proj_vp_order=False,
                 merge_src_feat=False, merge_lowres_src=False, quantize_proj=True,
                 quantize_volume=True, merge_coarse_octet=True, fold_coarse_fc=True,
                 int4_coarse=False, coarse_nearest=2, l1_nearest=0, pack_octet_u32=False,
                 dense_conv=False, dense_slots=True, sigma_cap=319488, neg_ray_val=False,
                 n_views=3, splat_bins=True, tap_window=32, window_margin_voxels=6.0,
                 mesh_th=-1.0):
        super().__init__()
        # tight_cull: splat and cull against the level-1 occupancy (fast
        # mode); off: against the sum-over-levels blanket, compacted to
        # splat_cap voxels (0 = dense walk), with split projection tables
        self.tight_cull = bool(tight_cull)
        self.splat_cap = int(splat_cap)
        # splat_bins: under the tight cull, per-pixel depth-bin masks are the
        # cull; without them the occupancy tap, over tap_window grid samples
        # from each ray's front depth less window_margin_voxels level-0
        # voxels (0 or >= n_samples: every sample)
        self.splat_bins = bool(splat_bins)
        self.tap_window = int(tap_window)
        self.window_margin_voxels = float(window_margin_voxels)
        self.frame_mode = bool(frame_mode)
        # dense_slots: evaluate every slot of the (K, R) frame; off, compact
        # the valid slots globally to sigma_cap points per ray_cap rays
        self.dense_slots = bool(dense_slots)
        self.sigma_cap = int(sigma_cap)
        self.sigma_query_cull = bool(sigma_query_cull)
        self.int4_feat = bool(int4_feat)
        self.kernel_octet = bool(kernel_octet)
        # pallas_point: the point stages in the fused kernel
        # (ops/point_stages.py); off, op by op, where pallas_lerp routes the
        # merged table's weighted sum through the quad-lerp kernel
        # (ops/quad_lerp.py) and proj_vp_order picks the (V, P) gather order
        # of the torch-op route. Each switch alone decides its route: CUDA
        # tensors take the kernel, CPU tensors its plain version.
        self.pallas_point = bool(pallas_point)
        self.pallas_lerp = bool(pallas_lerp)
        self.proj_vp_order = bool(proj_vp_order)
        # the projection tables (projection_rows)
        self.merge_src_feat = bool(merge_src_feat)
        self.merge_lowres_src = bool(merge_lowres_src)
        self.quantize_proj = bool(quantize_proj)
        # the geometry tables (`_geometry_tables`), narrowed as the JAX
        # package narrows them (gpnerf_tpu/render/demo.py:181-219):
        # quantize_volume: u8 / int8 tables with per-channel scales, else
        # float tables; merge_coarse_octet: levels 2-4 resampled onto the
        # level-2 grid as one table, else one table per level;
        # fold_coarse_fc: out_geometry_fc's coarse block pre-applied to the
        # merged table (its rows are signed, so not with the unsigned
        # word-packed tables of pack_octet_u32); int4_coarse: that folded
        # table int4 split-packed; coarse_nearest 1 / 2: it sampled nearest
        # on its own grid / on the level-1 grid; l1_nearest 1 / 2 / 10 + d/h/w
        # bitmask: the level-1 table sampled nearest on its grid / on the
        # midpoint-doubled grid / linearly along the masked axes;
        # pack_octet_u32: octet tables built in 32-bit words; dense_conv: the
        # conv stack as dense 3D convolutions (eval only)
        self.quantize_volume = bool(quantize_volume)
        self.merge_coarse_octet = bool(merge_coarse_octet)
        self.pack_octet_u32 = bool(pack_octet_u32)
        self.fold_coarse_fc = (bool(fold_coarse_fc) and self.merge_coarse_octet
                               and not self.pack_octet_u32)
        self.int4_coarse = bool(int4_coarse) and self.fold_coarse_fc and self.quantize_volume
        self.coarse_nearest = (int(coarse_nearest) if self.fold_coarse_fc and self.quantize_volume
                               and not self.int4_coarse else 0)
        self.l1_nearest = int(l1_nearest) if self.quantize_volume else 0
        self.dense_conv = bool(dense_conv)
        # THuman's convention (see the module docstring)
        self.neg_ray_val = bool(neg_ray_val)
        self.encoder = encoder
        self.nerfhead = nerfhead
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.n_samples = int(n_samples)
        self.samples_per_ray = int(samples_per_ray)
        self.ray_cap = int(ray_cap)
        self.bin_margin_voxels = float(bin_margin_voxels)
        self.max_out_sh = tuple(int(v) for v in max_out_sh)
        self.compute_dtype = compute_dtype
        # the source views each frame brings (cfg.src_view_num)
        self.n_views = int(n_views)
        # the mesh path's alpha threshold (1 / test.mesh_th; -1 without it)
        self.mesh_th = float(mesh_th)

    def _uses_bins(self):
        """The splat-bin cull: `splat_bins` under the tight cull."""
        return self.splat_bins and self.tight_cull

    def _uses_window(self):
        """JAX's windowed tap (gpnerf_tpu/render/demo.py:424-430): no bins,
        0 < tap_window < n_samples, ascending traversal."""
        return (not self._uses_bins() and 0 < self.tap_window < self.n_samples
                and not self.neg_ray_val)

    def _frame_mode_on(self):
        """JAX's frame (gpnerf_tpu/render/demo.py:459-461): `frame_mode`
        with the tap window, or without bins and with K == S on ascending
        rays; inert otherwise."""
        return self.frame_mode and (self._uses_window() or (
            not self._uses_bins() and not self.neg_ray_val
            and self.samples_per_ray == self.n_samples))

    @torch.no_grad()
    def _encode(self, src_imgs):
        return self.encoder(src_norm(src_imgs))

    @torch.no_grad()
    def render_demo(self, batch):
        return self._demo_impl(batch, self._encode(batch["src_imgs"]))

    def _demo_impl(self, batch, featmaps, stop_stage=None):
        """Frame stage, ray pipeline and image assembly on encoded feature
        maps. `stop_stage` (one of STOP_STAGES) ends the render after that
        stage and returns None."""
        if stop_stage is not None and stop_stage not in STOP_STAGES:
            raise ValueError(f"stop_stage {stop_stage!r} is none of {STOP_STAGES}")
        out = self._frame_stage(batch, featmaps, stop_stage=stop_stage)
        if out is None:
            return None
        pre, tables, rd = out
        out = self._ray_pipeline(batch, pre, tables, rd, stop_stage=stop_stage)
        if out is None:
            return None
        return self._assemble(batch, rd, *out)

    def _assemble(self, batch, rd, rgb_map, stats):
        """The render dict: the ray colors scattered into the image, the
        overflow counters and counts. `rd` holds the frame's `ray_ok`,
        `pix_idx`, `ray_overflow` and `can_bounds`, `stats` the ray
        pipeline's counters over the same rays."""
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
            # the color head is alpha-masked and has no cap: rgb never drops
            "overflows": torch.stack(
                [rd["ray_overflow"], stats["perray_overflow"], stats["sig_overflow"], zero]
            ),
            "counts": torch.stack(
                [ray_ok.sum(), stats["n_sigma"], stats["n_rgb"]]
            ),
            "can_bounds": rd["can_bounds"],
        }

    def _splat_pixels(self, pts_w, row_ok, batch, H, W, with_zmin=False):
        """Mark each occupied voxel's 4 neighboring target pixels and, with
        `with_zmin`, scatter-min its camera depth onto them (the front depth
        the tap window starts from; camera depth is the rays' t-parameter).
        Returns (pixmask (H*W,) int32, zmin (H*W,) float32 with _ZFAR where
        no voxel lands, or None; (minx, miny) floor pixel per voxel)."""
        tp = batch["target_pose"]
        cam = pts_w @ tp[:, :3].T + tp[:, 3]
        pix = cam @ batch["target_K"].T
        # sign-preserving guard: neg-ray scene points lie at negative z
        z = pix[:, 2:3]
        z = torch.where(z.abs() < 1e-9, 1e-9, z)
        xy = pix[:, :2] / z
        minx = torch.floor(xy[:, 0]).long().clamp(0, W - 1)
        miny = torch.floor(xy[:, 1]).long().clamp(0, H - 1)
        maxx = (minx + 1).clamp(0, W - 1)
        maxy = (miny + 1).clamp(0, H - 1)
        pixmask = torch.zeros(H * W + 1, dtype=torch.int32, device=pts_w.device)
        zmin = depth = None
        if with_zmin:
            zmin = torch.full((H * W + 1,), _ZFAR, dtype=torch.float32, device=pts_w.device)
            depth = torch.where(row_ok, cam[:, 2], _ZFAR)
        for yy, xx in ((miny, minx), (maxy, minx), (miny, maxx), (maxy, maxx)):
            tgt = torch.where(row_ok, yy * W + xx, H * W)
            pixmask[tgt] = 1
            if with_zmin:
                zmin.scatter_reduce_(0, tgt, depth, "amin")
        return pixmask[:-1], None if zmin is None else zmin[:-1], minx, miny

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

    def _geometry_tables(self, vols, level_feats, flat1, g1, o):
        """The geometry gather tables, as the JAX package builds them
        (render/demo.py:1201-1370): the level-1 table and either the merged
        coarse table (levels 2-4 resampled onto the level-2 grid, with
        out_geometry_fc's coarse block folded in under fold_coarse_fc) or
        one table per coarse level. vols: the dense level volumes in the
        compute dtype (level 1 None on the rows path, where its table is
        corner-scattered from the active rows `level_feats[0]`, or built from
        the dense rows `flat1` when unquantized); o: out_sh. Returns
        {"octet_vols": [tables], "octet_scales": [per-channel dequant
        scales] or None (float tables), "folded": fold_coarse_fc}."""
        head = self.nerfhead
        if self.merge_coarse_octet:
            sh2 = tuple(vols[1].shape[:3])
            combined = torch.cat(
                [
                    vols[1].float(),
                    resample_volume_to(vols[2], sh2, o // 4, o // 8),
                    resample_volume_to(vols[3], sh2, o // 4, o // 16),
                ],
                dim=-1,
            )
            if self.fold_coarse_fc:
                # trilinear commutes with the linear map: the coarse block of
                # out_geometry_fc applied once per frame; the folded field is
                # signed, so its quantization is int8
                nch1 = head.spconv_out_dim[0]
                w_coarse = head.sigmahead.out_geometry_fc[0].weight[:, nch1:].T
                combined = torch.einsum("dhwc,co->dhwo", combined, w_coarse.float())
            dense_list = [vols[0], combined]
        else:
            dense_list = vols
        octet_vols = []
        if not self.quantize_volume:
            if flat1 is not None:
                v1 = flat1.reshape(tuple(g1.shape) + (flat1.shape[-1],))
                dense_list = [v1 if self.compute_dtype is None else v1.to(self.compute_dtype)
                              ] + list(dense_list[1:])
            return {"octet_vols": [build_octet_table_3d(v) for v in dense_list],
                    "octet_scales": None, "folded": self.fold_coarse_fc}
        build = build_octet_table_3d_u32 if self.pack_octet_u32 else build_octet_table_3d
        scales = []
        for i, vol in enumerate(dense_list):
            if i == 0 and vol is None:
                # level 1 from its active rows: quantized (their max is the
                # dense volume's, post-ReLU) and corner-scattered into a flat
                # octet table, or scattered once into flat nearest rows
                rows0 = torch.where(g1.valid[:, None], level_feats[0], 0.0)
                q_rows, sc = quantize_volume_u8(rows0)
                shape = tuple(g1.shape)
                if not self.l1_nearest:
                    tab = build_octet_table_scatter(q_rows, g1.coords, g1.valid, shape)
                else:
                    flat = scatter_dense_rows(q_rows, g1)
                    if self.l1_nearest >= 10:
                        # linear along the bitmask's axes, nearest on the rest
                        tab = NearestTable(flat, shape, 2, 1, self.l1_nearest - 10)
                    elif self.l1_nearest >= 2:
                        # the exact u8 midpoint-doubled grid
                        up = interleave_midpoints_3d(flat.reshape(shape + (flat.shape[-1],)))
                        tab = NearestTable(up.reshape(-1, up.shape[-1]), tuple(up.shape[:3]), 2, 2)
                    else:
                        tab = NearestTable(flat, shape, 2)
            elif i == 1 and self.coarse_nearest:
                # the folded field nearest-sampled: on the level-1 grid
                # (resampled once per frame) or on its own level-2 grid
                if self.coarse_nearest >= 2:
                    vol = resample_volume_to(vol, tuple(g1.shape), o // 2, o // 4)
                    div = 2
                else:
                    div = 4
                q, sc = quantize_image_i8(vol)
                tab = NearestTable(q.reshape(-1, q.shape[-1]), tuple(vol.shape[:3]), div)
            elif i == 1 and self.int4_coarse:
                q, sc = quantize_volume_i4(vol)
                tab = Int4Table(build_octet_table_3d(q))
            else:
                q, sc = (quantize_image_i8 if i == 1 and self.fold_coarse_fc
                         else quantize_volume_u8)(vol)
                tab = build(q)
            octet_vols.append(tab)
            scales.append(sc)
        return {"octet_vols": octet_vols, "octet_scales": scales, "folded": self.fold_coarse_fc}

    def _frame_stage(self, batch, featmaps, stop_stage=None):
        """Volume, occupancy, gather tables, AABB of the occupied voxels,
        splats, rays and near/far. Returns (pre, tables, rays), or None
        after a `stop_stage` of FRAME_STOPS."""
        dt = self.compute_dtype
        dev = featmaps.device
        src_unnorm = src_norm(batch["src_imgs"]) * 0.5 + 0.5
        pre = prepare_frame(batch, featmaps, self.max_out_sh, neg_ray=self.neg_ray_val)
        H, W = batch["tar_img"].shape[0:2]
        grids = pre["grids"]
        o = np.asarray(pre["out_sh"])
        if stop_stage == "pre":
            return None
        if stop_stage == "codes":
            self.nerfhead.sigmahead.fuse_codes(pre["smpl_feat"])
            return None

        # (2) volume + occupancy: dense per-level volumes (zero at inactive
        # sites), the level-1 one only where a table needs it dense
        head = self.nerfhead
        g1 = grids[1]
        if self.dense_conv:
            # the eval-only dense-convolution stack (JAX demo.py:1118-1133)
            code = _gather_rows(head.sigmahead.fuse_codes(pre["smpl_feat"]), pre["vertex_rows"])
            vols = sparse_net_dense_eval(head.sigmahead.xyzc_net, code, grids, compute_dtype=dt)
            level_feats = flat1 = None
        else:
            level_feats = head.volume(pre["smpl_feat"], pre["vertex_rows"], grids)
            flat1 = None if self.quantize_volume else scatter_dense_rows(level_feats[0], g1)
            vols = [None] + [scatter_dense(level_feats[i], grids[i + 1]) for i in (1, 2, 3)]
        if stop_stage == "fuse":
            return None
        masks3d = (occupancy_volume_dense(vols) if self.dense_conv
                   else occupancy_volume(level_feats, grids))
        if stop_stage == "occv":
            return None
        # the tables are built from the feature maps (the encoder's output,
        # of the compute dtype), the source colors and the volumes in the
        # compute dtype, as JAX casts them (quantization scales are then
        # computed in that dtype)
        featmaps = cast(featmaps, dt)
        src_unnorm = cast(src_unnorm, dt)
        vols = [None if v is None else cast(v, dt) for v in vols]

        # (3) gather tables
        tables = self._geometry_tables(vols, level_feats, flat1, g1, o)
        # projection quad tables (projection_rows). A table with no dequant
        # gets a unit scale (JAX render/demo.py:757-759): multiplying by 1 is
        # exact, so the op-by-op samplers also round as with none.
        fdt = dt or torch.float32
        if self.merge_src_feat:
            # one [rgb|feat] table at the source resolution, the features
            # upsampled (align corners), in the compute dtype
            Hs, Ws = src_unnorm.shape[1:3]
            feat_up = upsample_image_align_corners(featmaps.float(), Hs, Ws)
            comb = torch.cat([src_unnorm.float(), feat_up], dim=-1)
            tables["src_quad"] = build_quad_table_2d(comb.to(fdt))
            tables["proj_scale"] = torch.ones(comb.shape[-1], device=dev)
        elif self.merge_lowres_src:
            # one [rgb|feat] table at the feature grid, the source rgb
            # downsampled (align corners); int8 under quantize_proj
            Hf, Wf = featmaps.shape[1:3]
            src_low = upsample_image_align_corners(src_unnorm.float(), Hf, Wf)
            comb = torch.cat([src_low, featmaps.float()], dim=-1)
            if self.quantize_proj:
                qc, tables["proj_scale"] = quantize_image_i8(comb)
                tables["src_quad"] = build_quad_table_2d(qc)
            else:
                tables["src_quad"] = build_quad_table_2d(comb.to(fdt))
                tables["proj_scale"] = torch.ones(comb.shape[-1], device=dev)
        else:
            # split tables (reference semantics: rgb at full source
            # resolution, demo_render.py:586): uint8 sources as the raw
            # pixels with a 1/255 dequant after the bilinear sum, float ones
            # in the compute dtype; the encoder features on their own grid,
            # quantized (int4 only on the fused path, which alone unpacks
            # it) or in the compute dtype
            if batch["src_imgs"].dtype == torch.uint8:
                tables["src_quad"] = build_quad_table_2d(batch["src_imgs"])
                tables["src_scale"] = torch.full((3,), 1.0 / 255.0, device=dev)
            else:
                tables["src_quad"] = build_quad_table_2d(src_unnorm.to(fdt))
                tables["src_scale"] = torch.ones(3, device=dev)
            if self.quantize_proj:
                int4 = self.int4_feat and self.pallas_point
                quantize = quantize_image_i4 if int4 else quantize_image_i8
                qf, tables["feat_scale"] = quantize(featmaps.float())
                tables["feat_quad"] = build_quad_table_2d(qf)
            else:
                tables["feat_quad"] = build_quad_table_2d(featmaps.to(fdt))
                tables["feat_scale"] = torch.ones(featmaps.shape[-1], device=dev)
        if stop_stage == "volume":
            return None

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
        can_bounds = _occupied_bounds(pts_w, row_ok)
        if not self.tight_cull and self.splat_cap:
            # compact the blanket's occupied voxels before the splat
            # scatters; exact when drop-free, and a drop is counted into
            # ray_overflow (a dropped voxel can lose pixels)
            sidx, row_ok, splat_overflow = _compact(row_ok, self.splat_cap)
            pts_w = pts_w[sidx.clamp_max(pts_w.shape[0] - 1)]

        # pixel splat, ray compaction
        window = self._uses_window()
        pixmask, zmin, minx, miny = self._splat_pixels(pts_w, row_ok, batch, H, W,
                                                       with_zmin=window)
        if window:
            # the front-depth image's 4-neighborhood min fills the
            # dilation-only pixels and guards against splat overshoot
            zm = zmin.reshape(H, W)
            zm = torch.minimum(
                torch.minimum(zm, torch.minimum(torch.roll(zm, 1, 0), torch.roll(zm, -1, 0))),
                torch.minimum(torch.roll(zm, 1, 1), torch.roll(zm, -1, 1)))
            zmin = zm.reshape(-1)
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
        if stop_stage == "rays":
            return None
        bins = None
        if self._uses_bins():
            bins = self._splat_bins(pts_w, row_ok, batch, H, W, can_bounds, minx, miny)[safe]
        else:
            # occupancy-cull byte volume, one-voxel dilated (_occupancy_tap):
            # the level-1 occupancy under the tight cull, else the blanket
            if not self.tight_cull:
                cull_vol = masks3d
            elif self.dense_conv:
                cull_vol = occupancy_volume_dense(vols, levels=(0,))
            else:
                cull_vol = occupancy_volume(level_feats, grids, levels=(0,))
            occb = cull_vol > 0
            for ax in range(3):
                occb = occb | torch.roll(occb, 1, ax) | torch.roll(occb, -1, ax)
            tables["occb"] = occb.to(torch.uint8)
        rays = {
            "rays_o": rays_o, "rays_d": rays_d, "near": near, "far": far,
            "ray_ok": ray_ok, "pix_idx": pix_idx, "ray_overflow": ray_overflow,
            "can_bounds": can_bounds, "bins": bins,
            "zmin": zmin[safe] if window else None,
        }
        return pre, tables, rays

    def _occupancy_tap(self, batch, pre, tables, rd, s_cand):
        """The occupancy cull (demo_render.py:270-283, equivalent-or-looser):
        sample s of ray r survives iff the nearest level-1 voxel of the
        one-voxel-dilated occupancy volume is set. `s_cand` (W, R) holds the
        candidates' sample indices in traversal order (the window's from
        `s_lo`, or all S, descending under neg-ray); positions are computed
        per ray as (W, R) component planes. Returns (W, R) bool. (The JAX
        package gathers u32 words and shifts the byte out, a TPU gather
        workaround; here the tap reads the byte directly.)"""
        occb = tables["occb"]
        rays_o, rays_d = rd["rays_o"], rd["rays_d"]
        t = s_cand / torch.full((), float(self.n_samples - 1), device=rays_o.device)
        z = rd["near"][None, :] * (1.0 - t) + rd["far"][None, :] * t  # (W, R)
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

    def _window_start(self, rd, W):
        """Each ray's first tapped grid sample `s_lo` (R,) int64 (JAX
        render/demo.py:431-437): the front depth less the margin, floored
        onto the sample grid in float32 in JAX's order of operations,
        clipped to [0, S - W]; 0 where no voxel splatted. The compiled JAX
        program multiplies by the float32 reciprocal of S - 1 where the
        source divides by it; a quotient that lands on an integer floors
        differently under the two, so the port multiplies too."""
        S = self.n_samples
        near, zmin = rd["near"], rd["zmin"]
        dz = ((rd["far"] - near) * float(np.float32(1.0) / np.float32(S - 1))).clamp_min(1e-9)
        margin = float(np.float32(self.window_margin_voxels) * np.float32(self.voxel_size[0]))
        s_lo = torch.floor((zmin - margin - near) / dz).long()
        return torch.where(zmin > 1e8, 0, s_lo.clamp(0, S - W))

    def _ray_pipeline(self, batch, pre, tables, rd, stop_stage=None):
        """Sample cull (splat bins, or the occupancy tap over the window or
        every sample), per-ray K-slot compaction over the (K, R) slot frame
        — or, in frame mode, the K grid samples from each ray's window start
        with the cull left to the point stages — then, without
        `dense_slots`, the global compaction of the valid slots to
        sigma_cap points, point stages and composite. Returns (rgb_map,
        stats), or None after a `stop_stage` of RAY_STOPS or POINT_STOPS."""
        S, K = self.n_samples, self.samples_per_ray
        rays_o, rays_d, ray_ok = rd["rays_o"], rd["rays_d"], rd["ray_ok"]
        nr = rays_o.shape[0]
        dev = rays_o.device
        s_max = torch.full((), float(S - 1), device=dev)
        n_sigma = None
        neg = self.neg_ray_val
        sig_idx = None
        sig_overflow = torch.zeros((), dtype=torch.long, device=dev)
        # the tap's W candidates from s_lo, in traversal order: sample
        # s0 + sgn * w is the w-th from the front (descending under neg-ray)
        W = max(self.tap_window, K) if self._uses_window() else S
        s_lo = (self._window_start(rd, W) if self._uses_window()
                else torch.zeros(nr, dtype=torch.long, device=dev))
        s_lo_f = s_lo.float()
        sgn = -1.0 if neg else 1.0
        s0_f = s_lo_f + (W - 1) if neg else s_lo_f
        if self._frame_mode_on():
            # the frame is the K grid samples from s_lo: no tap, no rank or
            # global compaction; the trilinear level-1 occupancy cull comes
            # from the kernel
            slot = s_lo_f[None, :] + torch.arange(K, dtype=torch.float32, device=dev)[:, None]
            sig_ok = ray_ok[None, :].expand(K, nr)
            perray_overflow = torch.zeros((), dtype=torch.long, device=dev)
            mask_from_query = True
        else:
            if rd["bins"] is not None:
                ok = rd["bins"].T > 0  # (S, R), ascending sample index
                if neg:
                    ok = ok.flip(0)  # traversal order: front to back
                ok = ok & ray_ok[None, :]
            else:
                w = torch.arange(W, dtype=torch.float32, device=dev)[:, None]
                ok = self._occupancy_tap(batch, pre, tables, rd, s0_f[None, :] + sgn * w)
            if stop_stage == "cull_occ":
                return None
            cum = torch.cumsum(ok.int(), dim=0)
            # slot k of a ray holds the candidate index of its (k+1)-th
            # occupied sample (W when it has fewer): the nearest K survivors
            # are kept. The index is the count of candidates with cum <= k,
            # found per ray by binary search in the non-decreasing cum.
            ks = torch.arange(K, dtype=cum.dtype, device=dev).repeat(nr, 1)
            slot_rel = torch.searchsorted(cum.T.contiguous(), ks, right=True).T  # (K, R)
            sig_ok = slot_rel < W
            n_sigma = sig_ok.sum()
            perray_overflow = (cum[-1] - K).clamp_min(0).sum()
            if stop_stage == "cull_slots":
                return None
            # the absolute sample index of each slot; masked slots clamp to
            # the last candidate
            slot = s0_f[None, :] + sgn * slot_rel.clamp_max(W - 1).float()
            mask_from_query = self.sigma_query_cull
            if not self.dense_slots:
                # global compaction, slot-major: an overflow drops the
                # deepest slots of every ray first (JAX render/demo.py:608-638)
                P = K * nr
                sig_cap = max(1, self.sigma_cap * nr // self.ray_cap)
                sig_idx, sig_ok, sig_overflow = _compact(sig_ok.reshape(-1), sig_cap)
                # each point recomputed from one packed row [o, d, near, far, s]
                # of the (K, R, 9) frame
                ray_tab = torch.cat([rays_o, rays_d, rd["near"][:, None], rd["far"][:, None]], 1)
                packed = torch.cat([ray_tab[None].expand(K, nr, 8), slot[:, :, None]], -1)
                rows9 = packed.reshape(P, 9)[sig_idx.clamp_max(P - 1)]
                t = rows9[:, 8] / s_max
                z = rows9[:, 6] * (1.0 - t) + rows9[:, 7] * t
                pts_c = rows9[:, 0:3] + rows9[:, 3:6] * z[:, None]
        if sig_idx is None:
            t = slot / s_max
            z = rd["near"][None, :] * (1.0 - t) + rd["far"][None, :] * t
            pts_c = torch.stack(
                [rays_o[None, :, i] + rays_d[None, :, i] * z for i in range(3)], dim=-1
            ).reshape(-1, 3)
        dhw_c = points_to_dhw_vox(pts_c, batch, self.voxel_size)
        if stop_stage in RAY_STOPS:  # the frame has no tap and no slots
            return None
        out = self._point_stages(
            batch, pre, tables, pts_c, dhw_c, sig_ok.reshape(-1), mask_from_query,
            stop_stage=stop_stage)
        if out is None:
            return None
        alpha, rgb, sig_ok = out
        if sig_idx is not None:
            # the compacted points back into their slots (zeros elsewhere;
            # the tail's index K*R lands in the spare row). A point's rgb is
            # zero wherever its alpha is, so one target serves both.
            alpha, rgb = (_scatter_rows(v, sig_idx, K * nr) for v in (alpha, rgb))
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
            "sig_overflow": sig_overflow,
            # frame mode counts the samples that passed the kernel's cull,
            # the slot paths every valid slot (dropped ones included)
            "n_sigma": sig_ok.sum() if n_sigma is None else n_sigma,
            "n_rgb": (alpha > 1e-14).sum(),
        }
        return rgb_map, stats

    def _point_stages(self, batch, pre, tables, pts_c, dhw_c, sig_ok, mask_from_query,
                      stop_stage=None):
        """Projection gather, density and color of the P frame points:
        fused in one kernel (`pallas_point`), or op by op, which is also the
        path every `stop_stage` prefix takes. Returns alpha (P,)
        sigma-masked, rgb (P, 3) zero where not alive, and sig_ok with the
        occupancy verdict of `mask_from_query` folded in; None after a
        `stop_stage` of POINT_STOPS."""
        dt = self.compute_dtype
        head = self.nerfhead
        Hs, Ws = batch["src_imgs"].shape[1:3]
        if "feat_quad" in tables:
            # quantized feature tables lerp in float32, bf16 ones in bf16
            rgb_feat, view_mask = project_and_gather_quad(
                pts_c, pre["KE"], tables["src_quad"], tables["feat_quad"], Hs, Ws,
                neg_ray=self.neg_ray_val, src_scale=tables["src_scale"],
                feat_scale=tables["feat_scale"])
        else:
            rgb_feat, view_mask = project_and_gather_quad_merged(
                pts_c, pre["KE"], tables["src_quad"], Hs, Ws, neg_ray=self.neg_ray_val,
                scale=tables["proj_scale"], out_dtype=dt,
                vp_order=self.proj_vp_order)
        if stop_stage == "cull":
            return None

        # density; the level-1 trilinear occupancy (the reference's
        # `sp_feats > 0` cull) comes off the same query
        out_sh = torch.tensor(pre["out_sh"], device=dhw_c.device)
        octet_vols, scales = tables["octet_vols"], tables["octet_scales"]
        if tables["folded"]:
            q = head.sigmahead.query_sigma_feat_octet_folded(
                *octet_vols, dhw_c, out_sh, scales=scales, with_l1_occ=mask_from_query)
        else:
            q = head.sigmahead.query_sigma_feat_octet(
                octet_vols, dhw_c, out_sh, scales=scales, with_l1_occ=mask_from_query)
        if mask_from_query:
            sigma_feat, occ_l1 = q
            sig_ok = sig_ok & (occ_l1 > 0)
        else:
            sigma_feat = q
        if stop_stage == "sigma_q":
            return None
        mean, var = fused_mean_variance(rgb_feat)  # (P, 1, C), rgb_feat's dtype
        num_valid_obs = view_mask.sum(dim=-1, keepdim=True)
        if stop_stage == "meanvar":
            return None
        P = pts_c.shape[0]
        chunks = [slice(s, min(P, s + HEAD_CHUNK)) for s in range(0, P, HEAD_CHUNK)]
        sigma = torch.cat([
            head.rgbhead.density(sigma_feat[c], mean[c, 0], var[c, 0], num_valid_obs[c])[:, 0]
            for c in chunks])
        # alpha and the composite in float32, as JAX casts the heads' output
        sigma = torch.where(sig_ok, sigma.float(), 0.0)
        alpha = 1.0 - torch.exp(-sigma)
        if stop_stage == "sigma":
            return None

        # color on the whole frame; the composite weighs masked points 0
        rgb = torch.cat([
            head.rgbhead.color(rgb_feat[c, None], mean[c, None], var[c, None])[:, 0]
            for c in chunks]).float()
        alive = (alpha > 1e-14) & sig_ok
        rgb = torch.where(alive[:, None], rgb, 0.0)
        if stop_stage == "rgb":
            return None
        return alpha, rgb, sig_ok
