# Frozen copy of gpnerf_tpu_torch/render/base.py at commit ffa1347, the benchmark's plain
# reference: the port's hand-written kernels, registries and the paths no
# configuration of the benchmark runs are removed; nothing here is imported
# from the program.
"""The training renderer's forward (BaseRender.render_train) and the
per-frame geometry the progressive renderer shares with it: source-image
normalization, camera matrices, the frame's SMPL features and sparse
pyramid, and the world -> level-0 voxel mapping.

`render_train`: the batch's n_rays rays in one chunk, stratified samples
jittered by the given uniform draws, every BatchNorm on the frame's batch
statistics (running estimates updated in place). The eval, mesh and
data-parallel paths of the port are not copied."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from benchmark.reference.eager.ops.compositing import raw2outputs
from benchmark.reference.eager.ops.projection import gather_smpl_features, project_and_gather
from benchmark.reference.eager.ops.rays import sample_points, sample_z_vals
from benchmark.reference.eager.ops.sparse_conv import (
    SparseLevel,
    build_index_volume,
    scatter_dense,
)


def batch_to_device(batch, device):
    """Host batch dict (numpy, from data/) -> tensors on `device`. Integer
    rulebooks (int16 on the host) become int64 index tensors with -1 kept
    as "absent"; `out_sh` stays a host array (it sizes per-frame buffers)."""
    out = {}
    for k, v in batch.items():
        if k == "out_sh":
            out[k] = np.asarray(v)
            continue
        a = np.asarray(v)
        if a.dtype in (np.int16, np.int32) and (
            k.startswith("lvl") or k == "vertex_rows"
        ):
            a = a.astype(np.int64)
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
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
