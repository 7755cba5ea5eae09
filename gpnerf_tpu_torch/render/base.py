"""BaseRender, the training and quick-val renderer (gpnerf_tpu/render/
base.py; reference BaseRender.py:11-403), and the per-frame geometry the
progressive renderer shares with it: source-image normalization, camera
matrices, the frame's SMPL features and sparse pyramid, and the world ->
level-0 voxel mapping (reference BaseRender.py:52-73).

`Renderer` is an nn.Module whose `encoder` and `nerfhead` children carry
the reference checkpoint's parameter names, as the progressive renderer's
do, so one state dict fills either. Per frame the sparse volume is built
once and queried per ray chunk through per-level index volumes
(`sparse_query_ctx`), so gradients stay on the sparse rows:

  * `render_train`: the batch's n_rays rays in one chunk, stratified
    samples jittered by uniform draws, every BatchNorm on the frame's batch
    statistics (running estimates updated in place);
  * `render_eval_fn`: the padded box rays of a whole image in chunks of
    `eval_chunk`, no jitter, running statistics, no autograd.

  * `render_mesh`: the mesh branch (`head.rgb.use_rgbhead False`): the
    density MLP's sigma over the dataset's visual-hull grid (`pts`,
    `inside`), its alpha cube and marching cubes at `mesh_th`.

THuman's neg-ray convention (scene points at negative camera z, ray
t-parameters negative) is on for the training render when
`dataset.train.name` holds "thuman" and for the eval render when
`dataset.test.name` does: the view mask tests z < 0 and the composite
flips the sample order (reference BaseRender.py:86-88).

The mesh paths of both renderers share `mesh_volume`, `mesh_sigma` and
`mesh_from_alpha` here.

Under `tpu.train_dtype bfloat16` the encoder and the heads compute on real
bf16 tensors (models/layers.py) over float32 parameters.

Training runs data parallel over the ranks of a process group
(parallel/dp.py); `build_render` refuses, naming the keys, a data-parallel
group of some ranks only and several frames per step over several ranks
(`check_train_scope`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from gpnerf_tpu_torch.models.attention import MultiHeadAttention
from gpnerf_tpu_torch.models.heads import fused_mean_variance
from gpnerf_tpu_torch.models.layers import InstanceNorm, MaskedBatchNorm
from gpnerf_tpu_torch.models.sparse_net import SparseConvWeight
from gpnerf_tpu_torch.ops.compositing import raw2outputs
from gpnerf_tpu_torch.ops.marching_cubes import marching_cubes
from gpnerf_tpu_torch.ops.projection import gather_smpl_features, project_and_gather
from gpnerf_tpu_torch.ops.rays import sample_points, sample_z_vals
from gpnerf_tpu_torch.ops.sparse_conv import (
    SparseLevel,
    build_index_volume,
    scatter_dense,
)
from gpnerf_tpu_torch.registry import get, register
from gpnerf_tpu_torch.utils.mesh_io import Trimesh
from gpnerf_tpu_torch.utils.profiling import count, span


@span("gpnerf.upload")
def batch_to_device(batch, device):
    """Host batch dict (numpy, from data/) -> tensors on `device`. Integer
    rulebooks (int16 on the host) become int64 index tensors with -1 kept
    as "absent"; `out_sh` stays a host array (it sizes per-frame buffers).
    Counts the bytes copied as `upload_bytes`."""
    out = {}
    nbytes = 0
    for k, v in batch.items():
        if k == "out_sh":
            out[k] = np.asarray(v)
            continue
        a = np.asarray(v)
        if a.dtype in (np.int16, np.int32) and (
            k.startswith("lvl") or k == "vertex_rows"
        ):
            a = a.astype(np.int64)
        nbytes += a.nbytes
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    count("upload_bytes", nbytes)
    return out


def src_norm(imgs):
    """uint8 source images -> the normalized float frame (x/127.5 - 1)."""
    if imgs.dtype == torch.uint8:
        return imgs.float() / 127.5 - 1.0
    return imgs


def homogenize(m):
    """(..., 3, 4) pose or (..., 3, 3) K -> (..., 4, 4)."""
    out = torch.eye(4, dtype=m.dtype, device=m.device).expand(
        *m.shape[:-2], 4, 4
    ).clone()
    out[..., : m.shape[-2], : m.shape[-1]] = m
    return out


def camera_matrices(batch):
    """KE = K_h @ pose_h per source view (V, 4, 4)."""
    return torch.einsum(
        "vij,vjk->vik", homogenize(batch["src_Ks"]), homogenize(batch["src_poses"])
    )


def grid_shapes(max_out_sh, n_levels=5):
    D, H, W = max_out_sh
    return [(D >> i, H >> i, W >> i) for i in range(n_levels)]


def prepare_frame(batch, featmaps, max_out_sh, *, neg_ray=False):
    """Geometry-only per-frame preliminaries: camera matrices, world SMPL
    vertices, per-vertex multi-view features, and the host-built sparse
    pyramid (data/sparse_host.py) as SparseLevels."""
    H, W = batch["src_imgs"].shape[1:3]
    KE = camera_matrices(batch)
    xyz_can = batch["feature"][:, :3]
    smpl_xyz = xyz_can @ batch["Rh"].T + batch["Th"].reshape(1, 3)
    smpl_feat = gather_smpl_features(smpl_xyz, KE, featmaps, H, W, neg_ray=neg_ray)
    shapes = grid_shapes(max_out_sh)
    levels = [
        SparseLevel(
            batch[f"lvl{i}_coords"],
            batch[f"lvl{i}_valid"],
            batch[f"lvl{i}_nbr"],
            batch.get(f"lvl{i}_down"),
            shapes[i],
        )
        for i in range(5)
    ]
    return {
        "KE": KE,
        "smpl_feat": smpl_feat,
        "grids": levels,
        "vertex_rows": batch["vertex_rows"],
        "out_sh": tuple(int(v) for v in batch["out_sh"]),
        "overflows": batch.get("pyramid_overflows"),
    }


def points_to_dhw_vox(pts, batch, voxel_size):
    """World points -> canonical -> level-0 voxel units (dhw). (P, 3)."""
    can = (pts.reshape(-1, 3) - batch["Th"].reshape(1, 3)) @ batch["Rh"]
    dhw = can.flip(-1)
    min_dhw = batch["bounds"][0].flip(-1)
    vs = torch.tensor(voxel_size[::-1], dtype=dhw.dtype, device=dhw.device)
    return (dhw - min_dhw) / vs


def mesh_volume(encoder, nerfhead, batch, max_out_sh, *, neg_ray=False):
    """The mesh paths' per-frame stage (JAX render/base.py:409-420): the
    encoder, the frame's sparse volume in eval mode and its dense per-level
    volumes. Returns {"featmaps", "pre", "level_feats", "dense_vols",
    "out_sh" (3,) int tensor}."""
    featmaps = encoder(src_norm(batch["src_imgs"]))
    pre = prepare_frame(batch, featmaps, max_out_sh, neg_ray=neg_ray)
    grids = pre["grids"]
    level_feats = nerfhead.volume(pre["smpl_feat"], pre["vertex_rows"], grids)
    return {
        "featmaps": featmaps, "pre": pre, "level_feats": level_feats,
        "dense_vols": [scatter_dense(f, grids[i + 1]) for i, f in enumerate(level_feats)],
        "out_sh": torch.tensor(pre["out_sh"], device=featmaps.device),
    }


def mesh_sigma(nerfhead, vol, batch, pts, voxel_size, *, neg_ray=False):
    """The density MLP's sigma (P,) at world points pts (P, 3) (JAX
    render/base.py:422-441): the dense multi-scale query, the projected
    source colors and features, their mean and variance over the views.
    Returned as float32 (a bf16 head's values widened) for the host's
    alpha."""
    dhw = points_to_dhw_vox(pts, batch, voxel_size)
    sigma_feat = nerfhead.sigmahead.query_sigma_feat_dense(vol["dense_vols"], dhw,
                                                          vol["out_sh"])
    H, W = batch["src_imgs"].shape[1:3]
    rgb_feat, vm = project_and_gather(pts, vol["pre"]["KE"],
                                      src_norm(batch["src_imgs"]) * 0.5 + 0.5,
                                      vol["featmaps"], H, W, neg_ray=neg_ray)
    mean, var = fused_mean_variance(rgb_feat)
    return nerfhead.rgbhead.density(sigma_feat, mean[:, 0], var[:, 0],
                                    vm.sum(dim=-1, keepdim=True))[:, 0].float()


def mesh_from_alpha(alpha, th):
    """The alpha cube padded by 10 zero voxels, and its marching-cubes mesh
    at `th` (index coordinates of the padded cube). Returns {"cube",
    "mesh"}."""
    cube = np.pad(alpha, 10, mode="constant")
    vertices, triangles = marching_cubes(cube, th)
    return {"cube": cube, "mesh": Trimesh(vertices, triangles)}


# flax's truncated normal draws from N(0, 1) cut at +-2 and rescales by this
# factor so the kept values have unit variance
_TRUNC_STD = 0.87962566103423978


def _variance_scaling(t, scale, fan_in, generator, truncated=True):
    std = math.sqrt(scale / fan_in)
    if truncated:
        std /= _TRUNC_STD
        nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    else:
        nn.init.normal_(t, 0.0, std, generator=generator)


class Renderer(nn.Module):
    """The training renderer; see the module docstring."""

    def __init__(self, encoder, nerfhead, *, voxel_size, max_out_sh, n_samples=64,
                 eval_chunk=8192, occupancy_cull=False, neg_ray_train=False,
                 neg_ray_val=False, mesh_th=-1.0):
        super().__init__()
        self.encoder = encoder
        self.nerfhead = nerfhead
        self.neg_ray_train = bool(neg_ray_train)
        self.neg_ray_val = bool(neg_ray_val)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.max_out_sh = tuple(int(v) for v in max_out_sh)
        self.n_samples = int(n_samples)
        self.eval_chunk = int(eval_chunk)
        # the progressive renderer's empty-space cull in this renderer too
        # (NeRFHead.point_forward occupancy_cull)
        self.occupancy_cull = bool(occupancy_cull)
        # the mesh branch's alpha threshold (1 / test.mesh_th; -1 without it)
        self.mesh_th = float(mesh_th)

    @torch.no_grad()
    def init_variables(self, seed):
        """Fresh parameters with the JAX package's initializers, drawn on
        the CPU from `seed` and copied in: lecun-normal (truncated) conv and
        attention kernels, he-normal (truncated) head Linear kernels,
        normal(1/(27 Cin)) sparse conv weights, normal(1) vertex codes, zero
        biases, unit norm scales, running statistics reset. Returns self."""
        g = torch.Generator().manual_seed(int(seed))
        attn_linears = {id(m) for a in self.modules() if isinstance(a, MultiHeadAttention)
                        for m in a.children() if isinstance(m, nn.Linear)}
        for mod in self.modules():
            fresh = {}
            if isinstance(mod, nn.Conv2d):
                fresh["weight"] = torch.empty(mod.weight.shape)
                _variance_scaling(fresh["weight"], 1.0, mod.weight[0].numel(), g)
            elif isinstance(mod, nn.Linear):
                fresh["weight"] = torch.empty(mod.weight.shape)
                scale = 1.0 if id(mod) in attn_linears else 2.0
                _variance_scaling(fresh["weight"], scale, mod.in_features, g)
            elif isinstance(mod, nn.Embedding):
                fresh["weight"] = torch.randn(mod.weight.shape, generator=g)
            elif isinstance(mod, SparseConvWeight):
                fresh["weight"] = torch.empty(mod.weight.shape)
                _variance_scaling(fresh["weight"], 1.0, 27 * mod.weight.shape[3], g,
                                  truncated=False)
            elif isinstance(mod, (InstanceNorm, MaskedBatchNorm, nn.LayerNorm)):
                fresh["weight"] = torch.ones(mod.weight.shape)
            if isinstance(mod, MaskedBatchNorm):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
                mod.num_batches_tracked.zero_()
            bias = getattr(mod, "bias", None)
            if isinstance(bias, nn.Parameter):
                fresh["bias"] = torch.zeros(bias.shape)
            for name, val in fresh.items():
                getattr(mod, name).copy_(val)
        return self

    # ------------------------------------------------------------------
    def materialize_dense(self, level_feats, levels):
        """Dense per-level feature volumes (the reference's `.dense()`)."""
        return [scatter_dense(f, levels[i + 1]) for i, f in enumerate(level_feats)]

    def sparse_query_ctx(self, level_feats, levels):
        """Per-level index volumes over the sparse level rows: the query
        context of `models/heads.NeRFHead.point_forward` that keeps autograd on the rows."""
        index_vols = [
            build_index_volume(levels[i + 1].coords, levels[i + 1].valid, levels[i + 1].shape)
            for i in range(len(level_feats))
        ]
        shapes = tuple(levels[i + 1].shape for i in range(len(level_feats)))
        return {"sparse": (level_feats, index_vols, shapes)}

    def render_chunk(self, query_ctx, pre, batch, src_unnorm, featmaps, rays_o, rays_d,
                     near, far, *, neg_ray, perturb, generator=None, t_rand=None):
        """One ray chunk through sampling, projection, heads and
        compositing (reference render_rays, BaseRender.py:110-157)."""
        H, W = batch["src_imgs"].shape[1:3]
        z_vals = sample_z_vals(near, far, self.n_samples, perturb=perturb,
                               generator=generator, t_rand=t_rand)
        pts = sample_points(rays_o, rays_d, z_vals)
        nr = pts.shape[0]
        dhw_vox = points_to_dhw_vox(pts, batch, self.voxel_size)
        rgb_feat, mask = project_and_gather(pts.reshape(-1, 3), pre["KE"], src_unnorm,
                                            featmaps, H, W, neg_ray=neg_ray)
        rgb_feat = rgb_feat.reshape(nr, self.n_samples, -1, rgb_feat.shape[-1])
        mask = mask.reshape(nr, self.n_samples, -1)
        pixel_mask = mask.sum(dim=2) > 1  # seen by at least 2 views
        raw, rgb_in = self.nerfhead.point_forward(
            query_ctx, dhw_vox, pre["out_sh_t"], rgb_feat, mask[..., None],
            occupancy_cull=self.occupancy_cull)
        # compositing runs in float32: the cumprod accumulates over samples
        comp = raw2outputs(raw.float(), z_vals, pixel_mask, neg=neg_ray)
        rgb_in_map = (comp.weights[..., None, None] * rgb_in.float()).sum(dim=1)
        return {
            "rgb_map": comp.rgb_map,
            "disp_map": comp.disp_map,
            "acc_map": comp.acc_map,
            "depth_map": comp.depth_map,
            "alpha": comp.weights,
            "z_vals": z_vals,
            "rgb_in_map": rgb_in_map[:, 0],
            "pixel_mask": comp.mask,
        }

    def _frame(self, batch, train, neg_ray):
        src = src_norm(batch["src_imgs"])
        featmaps = self.encoder(src)
        pre = prepare_frame(batch, featmaps, self.max_out_sh, neg_ray=neg_ray)
        pre["out_sh_t"] = torch.as_tensor(np.asarray(batch["out_sh"]), device=featmaps.device)
        level_feats = self.nerfhead.volume(pre["smpl_feat"], pre["vertex_rows"], pre["grids"],
                                           train=train)
        return src * 0.5 + 0.5, featmaps, pre, self.sparse_query_ctx(level_feats, pre["grids"])

    def render_train(self, batch, generator=None, t_rand=None):
        """Training forward of one frame's n_rays rays with autograd; the
        BatchNorms' running estimates move in place. `t_rand` (n_rays,
        n_samples) are the uniform jitter draws, else drawn from
        `generator`. Returns the render dict with `overflows`."""
        neg_ray = self.neg_ray_train
        src_unnorm, featmaps, pre, ctx = self._frame(batch, train=True, neg_ray=neg_ray)
        ret = self.render_chunk(ctx, pre, batch, src_unnorm, featmaps, batch["ray_o"],
                                batch["ray_d"], batch["near"], batch["far"], neg_ray=neg_ray,
                                perturb=True, generator=generator, t_rand=t_rand)
        ret["overflows"] = pre["overflows"]
        return ret

    def render_eval_fn(self):
        """batch -> the whole-image eval render (`render_eval`)."""
        return self.render_eval

    @torch.no_grad()
    def render_eval(self, batch):
        """All padded box rays of the frame in chunks of eval_chunk, no
        jitter, running statistics. Returns rgb_map, depth_map, acc_map and
        rgb_in_map over the ray cap."""
        neg_ray = self.neg_ray_val
        src_unnorm, featmaps, pre, ctx = self._frame(batch, train=False, neg_ray=neg_ray)
        ray_cap = batch["ray_o"].shape[0]
        chunk = min(self.eval_chunk, ray_cap)
        if ray_cap % chunk:
            raise ValueError(f"tpu.eval_ray_cap={ray_cap} is not a multiple of "
                             f"tpu.eval_chunk={chunk}")
        keys = ("rgb_map", "depth_map", "acc_map", "rgb_in_map")
        outs = {k: [] for k in keys}
        for s in range(0, ray_cap, chunk):
            sl = slice(s, s + chunk)
            out = self.render_chunk(ctx, pre, batch, src_unnorm, featmaps, batch["ray_o"][sl],
                                    batch["ray_d"][sl], batch["near"][sl], batch["far"][sl],
                                    neg_ray=neg_ray, perturb=False)
            for k in keys:
                outs[k].append(out[k])
        return {k: torch.cat(v) for k, v in outs.items()}

    @torch.no_grad()
    def render_mesh(self, batch, chunk=65536):
        """The mesh branch (JAX render/base.py:446-489): the density MLP's
        sigma at the dataset's visual-hull grid points inside the hull
        (`batch["pts"]` (X, Y, Z, 3), `batch["inside"]`), in chunks of
        `chunk` points, 1 - exp(-sigma) into a zero cube, padded by 10,
        marching cubes at `mesh_th`. The reference reads the raw red channel
        as sigma here (BaseRender.py:267), a quirk not reproduced. Returns
        {"cube" (float64, padded), "mesh" (utils/mesh_io.Trimesh)}."""
        vol = mesh_volume(self.encoder, self.nerfhead, batch, self.max_out_sh,
                          neg_ray=self.neg_ray_val)
        pts = batch["pts"]
        sel = torch.nonzero(batch["inside"].reshape(-1).bool())[:, 0]
        flat = pts.reshape(-1, 3)[sel].float()
        sigma = torch.cat([
            mesh_sigma(self.nerfhead, vol, batch, flat[i:i + chunk], self.voxel_size,
                       neg_ray=self.neg_ray_val)
            for i in range(0, flat.shape[0], chunk)]) if flat.shape[0] else flat.new_zeros(0)
        alpha = 1.0 - np.exp(-sigma.cpu().numpy())
        cube = np.zeros(int(np.prod(pts.shape[:-1])), np.float64)
        cube[sel.cpu().numpy()] = alpha
        return mesh_from_alpha(cube.reshape(tuple(pts.shape[:-1])), self.mesh_th)

    def render(self, batch, generator=None):
        """Reference-style entry: with a generator, the training render of
        the sampled rays; without, the whole-image eval render."""
        if generator is not None:
            return self.render_train(batch, generator)
        return self.render_eval(batch)


def resolved_dp(cfg, world):
    """The data-parallel width of training over `world` ranks:
    `tpu.dp_size` (0: every rank) clamped to the ranks, as the JAX package
    clamps it to its devices (train/trainer.py:78-79)."""
    want = cfg.tpu.dp_size if cfg.tpu.dp_size > 0 else world
    return max(1, min(want, world))


def check_train_scope(cfg, world=None):
    """Raise NotImplementedError, naming the keys, for a training switch
    outside what the port implements over `world` ranks (the process
    group's size by default): a data-parallel group of some of the ranks
    only, or several frames per step (`dataset.img_num_per_gpu` > 1) with
    more than one rank, which the JAX package does not run in parallel
    either (its trainer steps such a list on one device, train/trainer.py
    :144-161)."""
    if world is None:
        from gpnerf_tpu_torch.utils.dist import get_world_size

        world = get_world_size()
    dp = resolved_dp(cfg, world)
    if 1 < dp < world:
        raise NotImplementedError(
            f"tpu.dp_size={cfg.tpu.dp_size} over {world} ranks: the data-parallel group is "
            "every rank of the process group (tpu.dp_size 0, or the world size)")
    if world > 1 and cfg.dataset.img_num_per_gpu > 1:
        raise NotImplementedError(
            f"dataset.img_num_per_gpu={cfg.dataset.img_num_per_gpu} with {world} ranks "
            f"(tpu.dp_size={cfg.tpu.dp_size}): a data-parallel step takes one frame per rank")


def build_render(cfg, device="cuda"):
    """BaseRender for `cfg` on `device` with untrained float32 parameters
    (call `init_variables(seed)` or load a state dict). Under
    `tpu.train_dtype bfloat16` the encoder and the heads compute in bf16 on
    real bf16 tensors (JAX render/base.py:500-507: float32 master
    parameters, every convolution and Dense layer cast; the norms, the
    attention and the compositing in float32); `tpu.matmul_dtype` does not
    act here, as in the JAX package."""
    check_train_scope(cfg)
    dt = {"float32": None, "bfloat16": torch.bfloat16}[cfg.tpu.train_dtype]
    r = Renderer(
        get("encoder", cfg.encoder.file)(cfg, compute_dtype=dt),
        get("head", cfg.head.file)(cfg, compute_dtype=dt),
        voxel_size=tuple(cfg.dataset.voxel_size),
        max_out_sh=tuple(cfg.tpu.max_out_sh),
        n_samples=cfg.train.n_samples,
        eval_chunk=cfg.tpu.eval_chunk,
        occupancy_cull=cfg.tpu.base_occupancy_cull,
        neg_ray_train="thuman" in cfg.dataset.train.name,
        neg_ray_val="thuman" in cfg.dataset.test.name,
        mesh_th=-1.0 if cfg.head.rgb.use_rgbhead else 1.0 / cfg.test.mesh_th,
    )
    return r.to(device)


register("render", "BaseRender", build_render)
