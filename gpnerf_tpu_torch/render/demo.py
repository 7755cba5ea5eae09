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
  6. the point stages, fused (`pallas_point`, the default) or op by op:
     fused, project + gather the quad rows and geometry rows (or, with
     `kernel_octet` off, query the geometry feature in torch ops) and run
     the point-stage kernel (ops/point_stages.py); op by op, sample the
     projection tables (merged: through the quad-lerp kernel of
     ops/quad_lerp.py with `pallas_lerp`, else in torch ops in (P, V) or,
     with `proj_vp_order`, (V, P) order; split: in torch ops), query the
     folded sigma feature, take mean/variance over the views and run the
     density and color heads (models/heads.py). Then composite front to
     back and scatter the rays into the image.

`build_render` accepts the fast mode, the reference mode, the reference mode
with one of `frame_mode`, `sigma_query_cull`, `int4_feat`, each with
`kernel_octet` and `pallas_point` either way (`pallas_lerp` and
`proj_vp_order` choose the op-by-op route of the merged table); any other
renderer switch raises NotImplementedError naming the key. As in the JAX
package, `int4_feat` stores the int8 table off the fused path.

Every mode also renders THuman's neg-ray convention (`dataset.test.name`
holding "thuman"): scene points lie at negative camera z and the rays'
t-parameters are negative, so ascending t runs back to front. The view
masks test z < 0, and the cull walks each ray's sample grid in descending
index (the bin rows flipped, the tap's candidates from the far end), so
the K kept slots are still the nearest survivors and the composite runs
front to back. As in the JAX package, the windowless `frame_mode` needs
ascending traversal and is inert under neg-ray: the render takes the tap
and the dense slots.

`stop_stage` (one of STOP_STAGES) ends a render after the named stage and
returns None; `Renderer.profile` times those prefixes.

Index compactions and scatters write through one spare slot that absorbs
the dropped entries (JAX's `mode="drop"`). Every real target is written
once: compaction positions are an exclusive prefix sum over the kept
entries, ray pixels are distinct, and the pixel/bin splats write the
constant 1 wherever several voxels land on one target.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch import nn

from gpnerf_tpu_torch.models.encoder import ResUNet
from gpnerf_tpu_torch.models.heads import NeRFHead, fused_mean_variance
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
from gpnerf_tpu_torch.ops.projection import (
    project_and_gather_quad,
    project_and_gather_quad_merged,
    project_gather_rows_merged,
)
from gpnerf_tpu_torch.ops.rays import pixel_rays, ray_aabb_near_far
from gpnerf_tpu_torch.ops.sparse_conv import scatter_dense
from gpnerf_tpu_torch.registry import register
from gpnerf_tpu_torch.render.base import points_to_dhw_vox, prepare_frame, src_norm

# Renderer switches (configs/synthetic.yaml over config/default.py) and the
# values the port implements: COMMON in every mode; FAST_MODE with
# tight_cull on; REF_MODE (the reference-semantics mode: blanket cull, all
# samples kept, no tap window, split projection tables) with it off, where
# at most one of REF_VARIANTS leaves its default. `kernel_octet`,
# `pallas_point`, `pallas_lerp` and `proj_vp_order` are free in both modes.
# `splat_bins` is inert without tight_cull, as in the JAX package.
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
}

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


class Renderer(nn.Module):
    """Progressive renderer; its `encoder` and `nerfhead` children carry the
    reference checkpoint's parameter names."""

    def __init__(self, encoder, nerfhead, *, voxel_size, n_samples=64,
                 samples_per_ray=13, ray_cap=24576, bin_margin_voxels=2.0,
                 max_out_sh=(96, 320, 224), compute_dtype=None,
                 tight_cull=True, splat_cap=0, frame_mode=False,
                 sigma_query_cull=False, int4_feat=False, kernel_octet=True,
                 pallas_point=True, pallas_lerp=True, proj_vp_order=False,
                 neg_ray_val=False):
        super().__init__()
        if not tight_cull and samples_per_ray != n_samples:
            raise NotImplementedError(
                "the blanket cull (tight_cull off) is ported with all "
                f"{n_samples} samples kept, not samples_per_ray={samples_per_ray}")
        if tight_cull and (frame_mode or sigma_query_cull or int4_feat):
            raise NotImplementedError(
                "frame_mode, sigma_query_cull and int4_feat are ported for "
                "the blanket cull (tight_cull off) only")
        if int4_feat and pallas_point and not kernel_octet:
            raise NotImplementedError(
                "the point-stage kernel has no instantiation for int4_feat "
                "rows with a feature input (kernel_octet off)")
        # tight_cull: splat and cull against the level-1 occupancy (fast
        # mode); off: against the sum-over-levels blanket, compacted to
        # splat_cap voxels (0 = dense walk), with split projection tables
        self.tight_cull = bool(tight_cull)
        self.splat_cap = int(splat_cap)
        self.frame_mode = bool(frame_mode)
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

    def render_demo_fn(self):
        """batch (render/base.batch_to_device) -> render dict."""
        return self.render_demo

    @torch.no_grad()
    def render_demo(self, batch):
        return self._demo_impl(batch, self.encoder(src_norm(batch["src_imgs"])))

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
        rgb_map, stats = out
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

    @torch.no_grad()
    def profile(self, batch, reps=3):
        """Per-stage time of the render, keyed by the reference's time_slots
        names. `batch`: one frame or a sequence of distinct frames; every
        program is warmed on each frame once, then timed `reps` times per
        frame (CUDA events on a card, the host clock on the CPU), the
        programs in turn within each rep; a frame's time is the least of its
        reps, a program's the mean over the frames. Seconds throughout.

        The prefixes of PROFILE_LADDER run with `pallas_point` forced off
        (the fused kernel has no stage boundaries inside it), and their
        differences are mapped onto the closest slot; the fused render, when
        it is the configured path, is timed apart as `rtime_production`.
        Returns {"etime": encoder, "rtime": the op-by-op render without the
        encoder, "time_slots": {...}[, "rtime_production"]}."""
        frames = [batch] if isinstance(batch, dict) else list(batch)
        dev = frames[0]["src_imgs"].device

        def once(fn, f):
            if dev.type != "cuda":
                t0 = time.perf_counter()
                fn(f)
                return time.perf_counter() - t0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
            fn(f)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3

        feats = {id(f): self.encoder(src_norm(f["src_imgs"])) for f in frames}
        orig = self.pallas_point

        def ladder_program(name, pallas_point):
            def run(f):
                self.pallas_point = pallas_point
                return self._demo_impl(f, feats[id(f)], stop_stage=name)
            return run

        programs = {"etime": lambda f: self.encoder(src_norm(f["src_imgs"]))}
        if orig:
            programs["rtime_production"] = ladder_program(None, True)
        programs.update({st: ladder_program(st, False) for st in PROFILE_LADDER})
        # every rep runs each program once on each frame, in turn: a drift
        # of the host's pace then reaches every program alike
        best = {name: [math.inf] * len(frames) for name in programs}
        try:
            for f in frames:
                for fn in programs.values():
                    fn(f)
            for _ in range(reps):
                for i, f in enumerate(frames):
                    for name, fn in programs.items():
                        best[name][i] = min(best[name][i], once(fn, f))
        finally:
            self.pallas_point = orig
        mean = {name: sum(v) / len(v) for name, v in best.items()}
        out = {k: mean[k] for k in ("etime", "rtime_production") if k in mean}
        totals = {st: mean[st] for st in PROFILE_LADDER}
        deltas, prev = {}, 0.0
        for stage in PROFILE_LADDER:
            deltas[stage] = totals[stage] - prev
            prev = totals[stage]
        out["rtime"] = totals[None]
        out["time_slots"] = {
            "bc_attn": 0.0,  # code fusion is part of sp_encode
            "sigma_attn": 0.0,
            "sigma_c": 0.0,
            "sp_encode": deltas["volume"],  # fuse + conv + occupancy + tables
            "bc_time": deltas["rays"],  # splat + rays + near/far
            "bf_sigma": deltas["cull_occ"] + deltas["cull_compact"]
            + deltas["cull"] + deltas["sigma_q"],  # culls + proj/octet gathers
            "sigma_f": deltas["sigma"],  # mean/var + density MLP
            "bf_rgb": 0.0,
            "rgb_f": deltas[None],  # color MLP + composite
            "bc_render": 0.0,
        }
        return out

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

        # (2) volume + occupancy
        level_feats = self.nerfhead.volume(pre["smpl_feat"], pre["vertex_rows"], grids)
        vols = [None] + [scatter_dense(level_feats[i], grids[i + 1]) for i in (1, 2, 3)]
        if stop_stage == "fuse":
            return None
        masks3d = occupancy_volume(level_feats, grids)
        if stop_stage == "occv":
            return None
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
            # only the fused kernel unpacks int4 rows
            int4 = self.int4_feat and self.pallas_point
            quantize = quantize_image_i4 if int4 else quantize_image_i8
            qf, tables["feat_scale"] = quantize(featmaps.float())
            tables["feat_quad"] = build_quad_table_2d(qf)
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
        if stop_stage == "rays":
            return None
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
        ray as (S, R) component planes, in traversal order (row w is sample
        S - 1 - w under neg-ray). Returns (S, R) bool. (The JAX
        package gathers u32 words and shifts the byte out, a TPU gather
        workaround; here the tap reads the byte directly.)"""
        S = self.n_samples
        occb = tables["occb"]
        rays_o, rays_d = rd["rays_o"], rd["rays_d"]
        dev = rays_o.device
        s = torch.arange(S, dtype=torch.float32, device=dev)[:, None]
        if self.neg_ray_val:
            s = (S - 1) - s
        t = s / torch.full((), float(S - 1), device=dev)
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

    def _ray_pipeline(self, batch, pre, tables, rd, stop_stage=None):
        """Sample cull (splat bins, or the occupancy tap), per-ray K-slot
        compaction over the dense (K, R) slot frame — or, in frame mode, the
        whole (S, R) sample grid with the cull left to the point stages —
        then point stages and composite. Returns (rgb_map, stats), or None
        after a `stop_stage` of RAY_STOPS or POINT_STOPS."""
        S, K = self.n_samples, self.samples_per_ray
        rays_o, rays_d, ray_ok = rd["rays_o"], rd["rays_d"], rd["ray_ok"]
        nr = rays_o.shape[0]
        dev = rays_o.device
        s_max = torch.full((), float(S - 1), device=dev)
        n_sigma = None
        neg = self.neg_ray_val
        if self.frame_mode and not neg:
            # windowless frame (K == S): no tap, no rank compaction; the
            # trilinear level-1 occupancy cull comes from the kernel
            slot = torch.arange(K, dtype=torch.float32, device=dev)[:, None].expand(K, nr)
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
                ok = self._occupancy_tap(batch, pre, tables, rd)
            if stop_stage == "cull_occ":
                return None
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
            if stop_stage == "cull_slots":
                return None
            slot = slot_rel.clamp_max(S - 1).float()
            if neg:
                slot = (S - 1) - slot
            mask_from_query = self.sigma_query_cull
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

    def _point_stages(self, batch, pre, tables, pts_c, dhw_c, sig_ok, mask_from_query,
                      stop_stage=None):
        """Projection gather, density and color of the P frame points:
        fused in one kernel (`pallas_point`), or op by op, which is also the
        path every `stop_stage` prefix takes. Returns alpha (P,)
        sigma-masked, rgb (P, 3) zero where not alive, and sig_ok with the
        occupancy verdict of `mask_from_query` folded in; None after a
        `stop_stage` of POINT_STOPS."""
        if self.pallas_point and stop_stage is None:
            return self._point_stages_fused(
                batch, pre, tables, pts_c, dhw_c, sig_ok, mask_from_query)
        dt = self.compute_dtype
        head = self.nerfhead
        Hs, Ws = batch["src_imgs"].shape[1:3]
        if "feat_quad" in tables:
            rgb_feat, view_mask = project_and_gather_quad(
                pts_c, pre["KE"], tables["src_quad"], tables["feat_quad"], Hs, Ws,
                neg_ray=self.neg_ray_val, src_scale=tables["src_scale"],
                feat_scale=tables["feat_scale"])
            feat_dt = None  # quantized split tables lerp in float32
        else:
            rgb_feat, view_mask = project_and_gather_quad_merged(
                pts_c, pre["KE"], tables["src_quad"], Hs, Ws, neg_ray=self.neg_ray_val,
                scale=tables["proj_scale"], out_dtype=dt,
                vp_order=self.proj_vp_order, kernel=self.pallas_lerp)
            feat_dt = dt
        if stop_stage == "cull":
            return None

        # density; the level-1 trilinear occupancy (the reference's
        # `sp_feats > 0` cull) comes off the same query
        out_sh = torch.tensor(pre["out_sh"], device=dhw_c.device)
        q = head.sigmahead.query_sigma_feat_octet_folded(
            tables["octet_l1"], tables["coarse"], dhw_c, out_sh,
            scales=tables["octet_scales"], with_l1_occ=mask_from_query)
        if mask_from_query:
            sigma_feat, occ_l1 = q
            sig_ok = sig_ok & (occ_l1 > 0)
        else:
            sigma_feat = q
        if stop_stage == "sigma_q":
            return None
        mean, var = fused_mean_variance(rgb_feat, feat_dt)  # (P, 1, C)
        num_valid_obs = view_mask.sum(dim=-1, keepdim=True)
        if stop_stage == "meanvar":
            return None
        P = pts_c.shape[0]
        chunks = [slice(s, min(P, s + HEAD_CHUNK)) for s in range(0, P, HEAD_CHUNK)]
        sigma = torch.cat([
            head.rgbhead.density(sigma_feat[c], mean[c, 0], var[c, 0], num_valid_obs[c])[:, 0]
            for c in chunks])
        sigma = torch.where(sig_ok, sigma, 0.0)
        alpha = 1.0 - torch.exp(-sigma)
        if stop_stage == "sigma":
            return None

        # color on the whole frame; the composite weighs masked points 0
        rgb = torch.cat([
            head.rgbhead.color(rgb_feat[c, None], mean[c, None], var[c, None])[:, 0]
            for c in chunks])
        alive = (alpha > 1e-14) & sig_ok
        rgb = torch.where(alive[:, None], rgb, 0.0)
        if stop_stage == "rgb":
            return None
        return alpha, rgb, sig_ok

    def _point_stages_fused(self, batch, pre, tables, pts_c, dhw_c, sig_ok, mask_from_query):
        """Geometry-row and projection-row gathers, then the point-stage
        kernel. Returns as `_point_stages`."""
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
            if mask_from_query:
                nch = self.nerfhead.spconv_out_dim[0]
                sig_ok = sig_ok & (feats[:, :nch].sum(dim=-1) > 0)
        Hs, Ws = batch["src_imgs"].shape[1:3]
        rows, w4, vmask = project_gather_rows_merged(
            pts_c, pre["KE"], tables["src_quad"], Hs, Ws, neg_ray=self.neg_ray_val
        )
        if "feat_quad" in tables:
            # split tables, both lerped in the kernel; the view mask is
            # projection-only and the same for both
            rows_f, w4_f, _ = project_gather_rows_merged(
                pts_c, pre["KE"], tables["feat_quad"], Hs, Ws, neg_ray=self.neg_ray_val,
                batched=True
            )
            tabs = ((rows, w4, tables["src_scale"]), (rows_f, w4_f, tables["feat_scale"]))
        else:
            tabs = ((rows, w4, tables["proj_scale"]),)
        weights = pack_head_weights(
            self.nerfhead, fold_nch=self.nerfhead.spconv_out_dim[0]
        )
        # mask_from_query: the kernel derives the reference's `sp_feats > 0`
        # cull (demo_render.py:294) from the lerped level-1 block; with a
        # feature input the cull is taken from the queried features above
        occ_geom = mask_from_query and self.kernel_octet
        outs = fused_point_stages_tabs(
            tabs, feats, vmask, sig_ok, weights, geom_tabs=geom_tabs,
            occ_geom=occ_geom,
        )
        if occ_geom:
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
    if t.int4_feat and t.pallas_point and not t.kernel_octet:
        raise NotImplementedError(
            "tpu.kernel_octet=False together with tpu.int4_feat=True: the "
            "point-stage kernel has no such instantiation")


def build_render(cfg, device="cuda"):
    """The progressive renderer for `cfg` on `device` in the mode its
    switches select, with untrained parameters (load weights with
    train/checkpoint.py)."""
    check_mode(cfg)
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
        pallas_point=cfg.tpu.pallas_point,
        pallas_lerp=cfg.tpu.pallas_lerp,
        proj_vp_order=cfg.tpu.proj_vp_order,
        neg_ray_val="thuman" in cfg.dataset.test.name,
    )
    return r.to(device).eval()


register("render", "DemoRender", build_render)
