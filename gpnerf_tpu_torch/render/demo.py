"""The geometry-guided progressive renderer (gpnerf_tpu/render/demo.py
`Renderer.render_demo_fn`; the paper's progressive pipeline, reference
demo_render.py:96-498) in its shipped "fast" mode and in its
reference-semantics mode.

Per frame:
  1. encode the V source views (ResUNet);
  2. fuse the SMPL vertex codes, run the sparse conv stack once (in rows
     form on the host rulebooks, or with `dense_conv` as dense 3D
     convolutions over the level volumes), derive the occupancy field
     `masks3d`;
  3. build the gather tables. The geometry tables by default: the u8
     level-1 octet table (corner-scattered from the active rows) and the
     folded merged-coarse field (out_geometry_fc's coarse block
     pre-applied) resampled onto the level-1 grid as an int8 nearest table;
     the geometry-table switches choose others as the JAX package does
     (`_geometry_tables`; `geometry_layout` names what the kernel gets).
     The projection tables, chosen apart from the cull
     as the JAX package chooses them (`projection_rows`): one [rgb|feat]
     quad table at the source resolution in the compute dtype
     (`merge_src_feat`); one at the feature grid (`merge_lowres_src`, the
     shipped synthetic config), int8 or in the compute dtype
     (`quantize_proj`); or the split pair, the raw u8 source pixels at full
     resolution (dequant 1/255; float sources in the compute dtype) and the
     encoder features on their own grid, int8, int4 split-packed
     (`int4_feat`, fused path) or in the compute dtype (the paper configs'
     default);
  4. splat occupied level-1 voxels into the target view and compact the hit
     pixels to `ray_cap` rays. Fast mode (`tight_cull`): the level-1 active
     set and a dilated pixel mask; with `splat_bins` (the default) also
     per-pixel depth-bin masks on the 64-sample grid (the occupancy cull).
     Reference mode: every voxel of the sum-over-levels occupancy blanket
     (compacted to `splat_cap` rows first), no pixel dilation. Without bins
     a one-voxel-dilated u8 occupancy volume `occb` (level 1 under the
     tight cull, the blanket otherwise) serves the per-sample tap, and the
     splat also scatter-mins each voxel's camera depth into a front-depth
     image `zmin` (eroded over the 4-neighbourhood) for the tap window;
  5. cull the samples of each ray (bin masks, or a nearest tap of `occb`)
     and keep the first K (`samples_per_ray`) occupied ones in a slot-major
     (K, R) frame (the reference mode, at K = 64, keeps every survivor).
     The windowed tap (`tap_window` W with 0 < W < 64, no bins, positive
     rays) taps only the max(W, K) grid samples from the ray's front depth
     less `window_margin_voxels` (`s_lo`); otherwise all 64.
     With `dense_slots` (the default) all K*R slots are evaluated; without,
     the valid slots are compacted globally, slot-major, to `sigma_cap`
     points (an overflow drops the deepest slots of every ray first and is
     counted as `sig_overflow`), each point recomputed from one packed
     [o, d, near, far, s] row. `frame_mode` without bins (windowed, or with
     K = 64) skips tap, slots and compaction: the frame is the K grid
     samples from `s_lo` (0 without the window) and the cull is the
     kernel's trilinear level-1 occupancy (`occ_geom`), which
     `sigma_query_cull` also applies on top of the tap;
  6. the point stages, fused (`pallas_point`, the default) or op by op:
     fused, project + gather the quad rows and geometry rows (or, with
     `kernel_octet` off, query the geometry feature in torch ops) and run
     the point-stage kernel (ops/point_stages.py); op by op, sample the
     projection tables (merged: through the quad-lerp kernel of
     ops/quad_lerp.py with `pallas_lerp`, else in torch ops in (P, V) or,
     with `proj_vp_order`, (V, P) order; split: in torch ops), query the
     folded sigma feature, take mean/variance over the views and run the
     density and color heads (models/heads.py). Then composite front to
     back (compacted points scattered back into their slots first) and
     scatter the rays into the image.

`build_render` takes every renderer switch the JAX package's takes: the
fast mode and the reference mode, with or without splat bins and the tap
window, each with the dense slots or the global compaction and any
`samples_per_ray`, under every projection-table choice and every
geometry-table switch (`quantize_volume`, `merge_coarse_octet`,
`fold_coarse_fc`, `int4_coarse`, `coarse_nearest`, `l1_nearest`,
`pack_octet_u32`, `dense_conv`, narrowed as the JAX package narrows them),
each with any of `frame_mode`, `sigma_query_cull`, `int4_feat` and
`kernel_octet` and `pallas_point` either way (`pallas_lerp` and
`proj_vp_order` choose the op-by-op route of the merged table), and any
`src_view_num` from 1 to 8 on the fused path (more op by op only); the
fused path builds the point-stage kernel for the key the combination
selects at its first launch. With `head.rgb.use_rgbhead False` it builds
the mesh renderer (`Renderer.render_mesh`). As in the JAX package,
`int4_feat` stores the int8 table off the fused path and acts on split
tables only, `frame_mode` acts only without splat bins, and `splat_bins`
only under the tight cull.

Every mode also renders THuman's neg-ray convention (`dataset.test.name`
holding "thuman"): scene points lie at negative camera z and the rays'
t-parameters are negative, so ascending t runs back to front. The view
masks test z < 0, and the cull walks each ray's sample grid in descending
index (the bin rows flipped, the tap's candidates from the far end), so
the K kept slots are still the nearest survivors and the composite runs
front to back. As in the JAX package, the tap window and `frame_mode` need
ascending traversal and are inert under neg-ray: the render taps all 64
samples into the slot frame.

`stop_stage` (one of STOP_STAGES) ends a render after the named stage and
returns None; `Renderer.profile` times those prefixes.

The entry points carry the JAX package's names: `render_demo_fn()` (batch
-> render dict), `encode_fn()` (the encoder alone), `render(batch)` (the
dict with the encoder's `etime` and the remainder's `rtime`) and
`render_demo_scan_fn()` (a stacked sequence of frames rendered in the
order of an index tensor, reduced per frame to overflows, counts and a
checksum). Under a compute dtype (`tpu.matmul_dtype bfloat16`) the
encoder, the sparse stack's operands, the tables built from the feature
maps and volumes, the samplers and the heads compute on tensors of that
dtype, as the JAX package's do; the level volumes, the occupancy, alpha
and the composite stay float32.

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

from gpnerf_tpu_torch.models.heads import fused_mean_variance
from gpnerf_tpu_torch.models.layers import cast
from gpnerf_tpu_torch.models.sparse_net import (
    occupancy_volume,
    occupancy_volume_dense,
    sparse_net_dense_eval,
)
from gpnerf_tpu_torch.ops.grid_sample import (
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
    trilinear_dense_gather,
    upsample_image_align_corners,
)
from gpnerf_tpu_torch.ops.point_stages import (
    check_key,
    fetchable,
    fused_point_stages_from_tables,
    make_key,
    pack_head_weights,
    table_channels,
)
from gpnerf_tpu_torch.ops.projection import (
    project_and_gather_quad,
    project_and_gather_quad_merged,
)
from gpnerf_tpu_torch.ops.rays import pixel_rays, ray_aabb_near_far
from gpnerf_tpu_torch.ops.sparse_conv import _gather_rows, scatter_dense, scatter_dense_rows
from gpnerf_tpu_torch.registry import get, register
from gpnerf_tpu_torch.render.base import (
    mesh_from_alpha,
    mesh_sigma,
    mesh_volume,
    points_to_dhw_vox,
    prepare_frame,
    src_norm,
)
from gpnerf_tpu_torch.utils.profiling import count, span

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


@span("gpnerf.download")
def pred_img_hwc(ret):
    """Host-side (H, W, 3) numpy image of a render dict (`pred_img`, or the
    channel planes `pred_chw`)."""
    if "pred_img" in ret:
        return ret["pred_img"].detach().cpu().numpy()
    return ret["pred_chw"].detach().permute(1, 2, 0).cpu().numpy()


def stack_frames(batches):
    """Device batches (render/base.batch_to_device) of one shape -> one
    batch whose every entry has a leading frame axis (the host `out_sh`
    stacked on the host): the `stacked` input of
    `Renderer.render_demo_scan_fn`."""
    return {k: (np.stack([b[k] for b in batches]) if isinstance(batches[0][k], np.ndarray)
                else torch.stack([b[k] for b in batches])) for k in batches[0]}


def frame_checksum(ret):
    """pred_chw.sum() + rgb_map.sum() + mask_at_box.sum() of a render dict,
    on its device: `render_demo_scan_fn`'s per-frame checksum."""
    return ret["pred_chw"].sum() + ret["rgb_map"].sum() + ret["mask_at_box"].sum()


def synchronize(dev):
    """Wait for `dev`'s queued work (a no-op off the card)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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


def projection_rows(merge_src_feat, merge_lowres_src, quantize_proj, int4_feat,
                    compute_dtype, src_uint8=True):
    """Row types of the projection tables the switches select, as
    ops/point_stages.Key holds them, by the JAX package's precedence
    (gpnerf_tpu/render/demo.py:1376-1457): `merge_src_feat`, one merged
    table at the source resolution in the compute dtype; `merge_lowres_src`,
    one merged table at the feature grid, int8 under `quantize_proj`, else in
    the compute dtype; otherwise the split pair, the source half the raw u8
    pixels (float sources: the compute dtype) and the feature half int4
    (`int4_feat`, fused path only), int8 (`quantize_proj`) or the compute
    dtype."""
    flt = "bf16" if compute_dtype == torch.bfloat16 else "f32"
    if merge_src_feat:
        return (flt,)
    if merge_lowres_src:
        return ("i8",) if quantize_proj else (flt,)
    src = "u8" if src_uint8 else flt
    if not quantize_proj:
        return (src, flt)
    return (src, "i4" if int4_feat else "i8")


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
        # every switch set selects a key the kernel compiles (float source
        # images change only the row types); a view count may not
        if self.pallas_point:
            try:
                check_key(self.kernel_form())
            except NotImplementedError as e:
                raise NotImplementedError(f"src_view_num={self.n_views}: {e} (tpu.pallas_point "
                                          "False renders op by op)") from None

    def kernel_form(self, src_uint8=True):
        """The point-stage kernel key (ops/point_stages.Key) the fused path
        launches for uint8 (or float) source images: the projection tables'
        row types, the geometry layout (`geometry_layout`), the in-kernel
        occupancy cull (`occ_geom`: the windowless frame or
        sigma_query_cull, with geometry tables in the kernel) and the view
        count."""
        rows = projection_rows(self.merge_src_feat, self.merge_lowres_src, self.quantize_proj,
                               self.int4_feat, self.compute_dtype, src_uint8)
        layout = self.geometry_layout()
        mask_from_query = self._frame_mode_on() or self.sigma_query_cull
        return make_key(rows, layout, mask_from_query and not str(layout).startswith("feats"),
                        self.n_views)

    def geometry_layout(self):
        """The geometry input the fused path hands the kernel: the
        ((taps, channels, row type), ...) specs of the tables
        `_geometry_tables` builds, where the kernel lerps them all (octet
        and plain nearest rows; JAX render/demo.py:689-731), else the
        queried (P, F) feature, ops/point_stages.GEOMS' "feats96" (folded
        coarse) or "feats128" (int4, word-packed and lerp-axes tables, or
        kernel_octet off), "-bf16" where it is queried in bf16.
        `kernel_form`'s key names specs a GEOMS entry holds by that name."""
        feats = "feats96" if self.fold_coarse_fc else "feats128"
        if self.compute_dtype == torch.bfloat16:
            feats += "-bf16"
        q = self.quantize_volume
        if (not self.kernel_octet or self.int4_coarse or (q and self.pack_octet_u32)
                or (self.l1_nearest >= 10 and not self.dense_conv)):
            return feats
        flt = "bf16" if self.compute_dtype == torch.bfloat16 else "f32"
        if not q:
            l1 = (8, 32, flt)
        elif self.l1_nearest and not self.dense_conv:
            l1 = (1, 32, "u8")
        else:
            l1 = (8, 32, "u8")
        if not self.merge_coarse_octet:
            coarse = ((8, 32, "u8" if q else flt),) * 3
        elif self.coarse_nearest:
            coarse = ((1, 64, "i8"),)
        elif not q:
            coarse = ((8, 64 if self.fold_coarse_fc else 96, "f32"),)
        else:
            coarse = ((8, 64, "i8") if self.fold_coarse_fc else (8, 96, "u8"),)
        return (l1,) + coarse

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

    def encode_fn(self):
        """src_imgs (V, H, W, 3) -> the encoder's feature maps (JAX
        `encode_fn`: the encoder alone, which `render` times as `etime`)."""
        return self._encode

    @span("gpnerf.encoder")
    @torch.no_grad()
    def _encode(self, src_imgs):
        return self.encoder(src_norm(src_imgs))

    def render_demo_fn(self):
        """batch (render/base.batch_to_device) -> render dict."""
        return self.render_demo

    @span("gpnerf.render")
    @torch.no_grad()
    def render_demo(self, batch):
        count("renders", 1)
        return self._demo_impl(batch, self._encode(batch["src_imgs"]))

    @torch.no_grad()
    def render(self, batch):
        """Reference-style entry (JAX `Renderer.render`, demo_render.py:
        429-498): the render dict plus `etime`, the encoder's seconds, and
        `rtime`, the remainder's, each stage bracketed by device
        synchronizations as the reference's cuda.synchronize calls (host
        clock)."""
        dev = batch["src_imgs"].device
        synchronize(dev)
        t0 = time.perf_counter()
        featmaps = self._encode(batch["src_imgs"])
        synchronize(dev)
        etime = time.perf_counter() - t0
        t0 = time.perf_counter()
        ret = self._demo_impl(batch, featmaps)
        synchronize(dev)
        ret["rtime"] = time.perf_counter() - t0
        ret["etime"] = etime
        return ret

    def render_demo_scan_fn(self):
        """(stacked, order) -> per-frame reduced outputs (JAX
        `render_demo_scan_fn`, the sequence `bench.py` times): renders
        frame order[i] of `stacked` (`stack_frames` of device batches) for
        each i in turn, with no host synchronization of its own between
        frames (a device `order` is read to the host once, before the
        first), and returns {"overflows" (F, 4), "counts" (F, 3),
        "checksum" (F,)} stacked on the device, F = len(order); the
        checksum (`frame_checksum`) sums the image, the ray colors and the
        mask, so no frame's image is left uncomputed."""
        return self._demo_scan

    @torch.no_grad()
    def _demo_scan(self, stacked, order):
        outs = {"overflows": [], "counts": [], "checksum": []}
        for i in torch.as_tensor(order).tolist():
            ret = self.render_demo({k: v[i] for k, v in stacked.items()})
            outs["overflows"].append(ret["overflows"])
            outs["counts"].append(ret["counts"])
            outs["checksum"].append(frame_checksum(ret))
        return {k: torch.stack(v) for k, v in outs.items()}

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

    @span("gpnerf.assemble")
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
        encoder, "totals": each PROFILE_LADDER prefix's time, "time_slots":
        {...}[, "rtime_production"]}."""
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

        feats = {id(f): self._encode(f["src_imgs"]) for f in frames}
        orig = self.pallas_point

        def ladder_program(name, pallas_point):
            def run(f):
                self.pallas_point = pallas_point
                return self._demo_impl(f, feats[id(f)], stop_stage=name)
            return run

        programs = {"etime": lambda f: self._encode(f["src_imgs"])}
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
        out["totals"] = totals
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
    @torch.no_grad()
    def mesh_frame(self, batch):
        """The mesh path's volume stage (JAX render/demo.py:1856-1883):
        render/base.mesh_volume, the frame's occupancy field `masks3d` and
        the world AABB of its occupied voxels, padded by 0.05 in z
        (`can_bounds`)."""
        vol = mesh_volume(self.encoder, self.nerfhead, batch, self.max_out_sh,
                          neg_ray=self.neg_ray_val)
        masks3d = occupancy_volume(vol["level_feats"], vol["pre"]["grids"])
        vs = torch.tensor(self.voxel_size, dtype=torch.float32, device=masks3d.device)
        vol["masks3d"] = masks3d
        vol["can_bounds"] = _occupied_bounds(*self._occupied_world_pts(masks3d, batch, vs))
        return vol

    @torch.no_grad()
    def render_mesh(self, batch, chunk=65536):
        """The occupancy-driven mesh branch (JAX render/demo.py:1886-1965;
        the reference's demo_render.py:249-268,366-376): a grid on the host
        from can_bounds[0] in steps of the voxel size up to can_bounds[1]
        per axis (ij order; the dataset's visual hull `pts` / `inside` is
        not read), sigma at every grid point in chunks of `chunk`
        (render/base.mesh_sigma, zero where the trilinear level-1
        occupancy of masks3d is not > 0: the reference's `sp_feats > 0`
        cull), 1 - exp(-sigma) as the alpha cube, padded by 10, marching
        cubes at `mesh_th`. Returns {"cube" (padded), "mesh"
        (utils/mesh_io.Trimesh, index coordinates)}."""
        vol = self.mesh_frame(batch)
        cb = vol["can_bounds"].cpu().numpy()
        vs = np.asarray(self.voxel_size, np.float64)
        axes = [np.arange(cb[0, i], cb[1, i] + vs[i], vs[i]) for i in range(3)]
        grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).astype(np.float32)
        pts = torch.from_numpy(grid.reshape(-1, 3)).to(vol["masks3d"].device)
        out_sh = vol["out_sh"]
        size1 = out_sh // 2
        sigmas = []
        for i in range(0, pts.shape[0], chunk):
            p = pts[i:i + chunk]
            pos1 = points_to_dhw_vox(p, batch, self.voxel_size) / out_sh.float() * (
                size1 - 1).float()
            occ = trilinear_dense_gather(vol["masks3d"], pos1, dyn_size=size1)
            sigma = mesh_sigma(self.nerfhead, vol, batch, p, self.voxel_size,
                               neg_ray=self.neg_ray_val)
            sigmas.append(torch.where(occ > 0, sigma, 0.0))
        alpha = 1.0 - np.exp(-torch.cat(sigmas).cpu().numpy())
        return mesh_from_alpha(alpha.reshape(grid.shape[:3]), self.mesh_th)

    # ------------------------------------------------------------------
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

    @span("gpnerf.frame_stage")
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

    @span("gpnerf.ray_pipeline")
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
        count("point_slots", pts_c.shape[0])
        count("colored_points", stats["n_rgb"])
        return rgb_map, stats

    @span("gpnerf.point_stages")
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
            # quantized feature tables lerp in float32, bf16 ones in bf16
            rgb_feat, view_mask = project_and_gather_quad(
                pts_c, pre["KE"], tables["src_quad"], tables["feat_quad"], Hs, Ws,
                neg_ray=self.neg_ray_val, src_scale=tables["src_scale"],
                feat_scale=tables["feat_scale"])
        else:
            rgb_feat, view_mask = project_and_gather_quad_merged(
                pts_c, pre["KE"], tables["src_quad"], Hs, Ws, neg_ray=self.neg_ray_val,
                scale=tables["proj_scale"], out_dtype=dt,
                vp_order=self.proj_vp_order, kernel=self.pallas_lerp)
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

    def _point_stages_fused(self, batch, pre, tables, pts_c, dhw_c, sig_ok, mask_from_query):
        """The point-stage kernel fed by the frame's tables: it projects the
        points and fetches the quad rows and the geometry rows itself
        (ops/point_stages.py fused_point_stages_from_tables); geometry tables
        it does not fetch from are queried here into the (P, F) feature.
        Returns as `_point_stages`."""
        octet_vols, scales = tables["octet_vols"], tables["octet_scales"]
        nch = self.nerfhead.spconv_out_dim[0]
        # the geometry tables the kernel lerps (JAX render/demo.py:689-714):
        # octet and plain nearest tables; scale None is a unit one
        geom = None
        if self.kernel_octet and all(fetchable(t) for t in octet_vols):
            geom = tuple((t, None if scales is None else scales[i])
                         for i, t in enumerate(octet_vols))
        # mask_from_query: the kernel derives the reference's `sp_feats > 0`
        # cull (demo_render.py:294) from the lerped level-1 block, where
        # table 0 is the nch-channel level-1 table; else the queried
        # features give it
        occ_geom = False
        if geom is not None and mask_from_query:
            if table_channels(geom[0][0]) == nch:
                occ_geom = True
            else:
                geom = None
        feats = None
        if geom is None:
            # the (P, F) feature queried in the compute dtype (JAX's sparse
            # net queries in its own), handed to the kernel as it is
            out_sh = torch.tensor(pre["out_sh"], device=dhw_c.device)
            net = self.nerfhead.sigmahead.xyzc_net
            dt = self.compute_dtype
            if len(octet_vols) == 2:
                feats = net.query_octet2(*octet_vols, dhw_c, out_sh, scales=scales, out_dtype=dt)
            else:
                feats = net.query_octet(octet_vols, dhw_c, out_sh, scales=scales, out_dtype=dt)
            if mask_from_query:
                sig_ok = sig_ok & (feats[:, :nch].sum(dim=-1) > 0)
        if "feat_quad" in tables:
            # split tables, both lerped in the kernel
            quads = ((tables["src_quad"], tables["src_scale"]),
                     (tables["feat_quad"], tables["feat_scale"]))
        else:
            quads = ((tables["src_quad"], tables["proj_scale"]),)
        # the folded coarse rows are out_geometry_fc's coarse block already
        weights = pack_head_weights(self.nerfhead, fold_nch=nch if tables["folded"] else None)
        outs = fused_point_stages_from_tables(
            quads, pts_c, pre["KE"], tuple(batch["src_imgs"].shape[1:3]), sig_ok, weights,
            geom=geom or (), dhw_c=dhw_c, out_sh=pre["out_sh"], feats=feats,
            neg_ray=self.neg_ray_val, occ_geom=occ_geom,
        )
        if occ_geom:
            sig_ok = sig_ok & (outs[2] > 0.5)
        return outs[0], outs[1], sig_ok


def build_render(cfg, device="cuda"):
    """The progressive renderer for `cfg` on `device` in the mode its
    switches select, its encoder and heads built through the registry
    (`encoder.file`, `head.file`), with untrained parameters (load weights
    with train/checkpoint.py)."""
    dtypes = {"bfloat16": torch.bfloat16, "float32": None}
    if cfg.tpu.matmul_dtype not in dtypes:
        raise NotImplementedError(f"tpu.matmul_dtype={cfg.tpu.matmul_dtype!r}")
    dt = dtypes[cfg.tpu.matmul_dtype]
    r = Renderer(
        get("encoder", cfg.encoder.file)(cfg, compute_dtype=dt),
        get("head", cfg.head.file)(cfg, compute_dtype=dt),
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
        merge_src_feat=cfg.tpu.merge_src_feat,
        merge_lowres_src=cfg.tpu.merge_lowres_src,
        quantize_proj=cfg.tpu.quantize_proj,
        **{k: cfg.tpu[k] for k in GEOMETRY_SWITCHES},
        dense_slots=cfg.tpu.dense_slots,
        sigma_cap=cfg.tpu.sigma_cap,
        neg_ray_val="thuman" in cfg.dataset.test.name,
        n_views=cfg.src_view_num,
        splat_bins=cfg.tpu.splat_bins,
        tap_window=cfg.tpu.tap_window,
        window_margin_voxels=cfg.tpu.window_margin_voxels,
        mesh_th=-1.0 if cfg.head.rgb.use_rgbhead else 1.0 / cfg.test.mesh_th,
    )
    return r.to(device).eval()


register("render", "DemoRender", build_render)
