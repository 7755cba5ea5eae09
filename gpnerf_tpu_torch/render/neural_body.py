"""The novel-view renderer of Neural Body (zju3dv/neuralbody
lib/networks/renderer/if_clight_renderer.py at test time), registered as
`render` / `NeuralBody`.

One request renders every ray of the batch that hits the body's box (the
data layer's test rays: `ray_o`, `ray_d`, `near`, `far` for the pixels of
`mask_at_box`, world coordinates, as the source's) with `n_samples`
evenly spaced samples each, no perturbation:

  * `nbody.volume`: the vertex codes through the sparse stack into the four
    dense volumes, once a frame;
  * `nbody.points`: every sample through ops/nbody_points.py
    `nbody_points` (one kernel launch on the card; on the CPU the torch
    path in chunks of `chunk_rays` rays): each point mapped world -> SMPL
    space ((x - Th) Rh) -> level-0 voxels, the volumes' query, the
    encodings of the world point and of the view direction, and the whole
    MLP (models/neural_body.py); no cull, no skipped sample, no early ray
    termination;
  * `nbody.composite`: Neural Body's compositing
    (ops/compositing.py `raw2outputs_distance`) and the ray colors
    scattered into the image, black elsewhere, as `pred_chw`.

Counters (utils/profiling.py): `nbody_points`, the samples run through the
MLP, and `nbody_rays` (and the kernel's own `nbody_kernel_points`).

The host pyramid (data/sparse_host.py) builds each level's active sites on
the static `max_out_sh` grid; the source's sparse tensors span the frame's
`out_sh` only. Sites at or past the frame's level size (a level-0 voxel at
out_sh - 1 reaches one) are dropped here, with every rulebook entry that
points at one, so the active sets are the source's.
"""

from __future__ import annotations

import torch
from torch import nn

from gpnerf_tpu_torch.models.neural_body import NeuralBody
from gpnerf_tpu_torch.ops.compositing import raw2outputs_distance
from gpnerf_tpu_torch.ops.nbody_points import nbody_points
from gpnerf_tpu_torch.ops.rays import sample_z_vals
from gpnerf_tpu_torch.ops.sparse_conv import SparseLevel
from gpnerf_tpu_torch.registry import register
from gpnerf_tpu_torch.render.base import grid_shapes
from gpnerf_tpu_torch.utils.profiling import count, span


def _drop_rows(table, keep):
    """A rulebook (CAP, 27) with every entry that points at a dropped row
    of `keep` set to absent (-1)."""
    return torch.where((table >= 0) & keep[table.clamp_min(0)], table, -1)


def frame_levels(batch, max_out_sh, n_levels=5):
    """The batch's sparse pyramid as SparseLevels, cut to the frame's
    `out_sh` (level i spans out_sh // 2^i). A frame whose `out_sh` is the
    static grid has nothing to cut: every site lies inside it and the
    rulebooks point at valid rows only (data/sparse_host.py), so its levels
    are the batch's as they are, with no launch."""
    shapes = grid_shapes(max_out_sh, n_levels)
    if tuple(int(v) for v in batch["out_sh"]) == tuple(max_out_sh):
        return [SparseLevel(batch[f"lvl{i}_coords"], batch[f"lvl{i}_valid"],
                            batch[f"lvl{i}_nbr"], batch.get(f"lvl{i}_down"), shapes[i])
                for i in range(n_levels)]
    return cut_levels(batch, shapes)


def cut_levels(batch, shapes):
    """`frame_levels` of a frame smaller than the static grid (`shapes`,
    each level's): the sites at or past the frame's level sizes dropped,
    with every rulebook entry that points at one."""
    out_sh = torch.as_tensor(batch["out_sh"], dtype=torch.long,
                             device=batch["lvl0_coords"].device)
    levels, prev_keep = [], None
    for i in range(len(shapes)):
        coords, valid = batch[f"lvl{i}_coords"], batch[f"lvl{i}_valid"]
        keep = valid & (coords < out_sh // 2 ** i).all(dim=-1)
        down = batch.get(f"lvl{i}_down")
        if down is not None:
            down = _drop_rows(down, prev_keep)
        levels.append(SparseLevel(coords, keep, _drop_rows(batch[f"lvl{i}_nbr"], keep), down,
                                  shapes[i]))
        prev_keep = keep
    return levels


class NeuralBodyRender(nn.Module):
    """The views program: `render_demo_fn()` maps an uploaded batch
    (render/base.py `batch_to_device`) to {"pred_chw": the image (3, H,
    W)}."""

    def __init__(self, net: NeuralBody, *, voxel_size, max_out_sh, n_samples=64,
                 chunk_rays=16384):
        super().__init__()
        self.net = net
        self.voxel_size = tuple(voxel_size)
        self.max_out_sh = tuple(max_out_sh)
        self.n_samples = n_samples
        self.chunk_rays = chunk_rays

    def render_demo_fn(self):
        return self.render_demo

    @span("nbody.render")
    @torch.no_grad()
    def render_demo(self, batch):
        vols = self._volume(batch)
        n = int(batch["n_rays"])
        raw, z_vals = self._points(batch, vols, n)
        return self._composite(batch, raw, z_vals, n)

    @span("nbody.volume")
    def _volume(self, batch):
        return self.net.volumes(batch["vertex_rows"], frame_levels(batch, self.max_out_sh),
                                batch["out_sh"])

    @span("nbody.points")
    def _points(self, batch, vols, n):
        """raw (n, S, 4) float32 of every sample of the first n rays, and
        their depths (n, S)."""
        S = self.n_samples
        z_vals = sample_z_vals(batch["near"][:n], batch["far"][:n], S, perturb=False)
        latent = self.net.latent_row(batch["latent_index"])
        raw = nbody_points(self.net, vols, batch, batch["ray_o"][:n], batch["ray_d"][:n],
                           z_vals, latent, self.voxel_size, chunk_rays=self.chunk_rays)
        count("nbody_rays", n)
        count("nbody_points", n * S)
        return raw, z_vals

    @span("nbody.composite")
    def _composite(self, batch, raw, z_vals, n):
        rgb_map = raw2outputs_distance(raw, z_vals, batch["ray_d"][:n])
        H, W = batch["tar_img"].shape[0:2]
        pix = batch["mask_at_box"].reshape(-1).nonzero()[:n, 0]
        pred = rgb_map.new_zeros(3, H * W)
        pred[:, pix] = rgb_map.T
        return {"pred_chw": pred.reshape(3, H, W)}


def build_render(cfg, device="cuda"):
    """Neural Body's views program for `cfg` with untrained parameters (load
    a state dict; tools/make_nbody_ckpt.py makes one): the published widths
    (models/neural_body.py), and of the configuration the keys the source's
    configuration names alike: `num_frame` latent rows (the source's
    num_train_frame), `xyz_res`, `view_res`; `train.n_samples` samples a
    ray; `tpu.matmul_dtype`; `tpu.eval_chunk` rays a chunk."""
    dt = {"float32": None, "bfloat16": torch.bfloat16}[cfg.tpu.matmul_dtype]
    net = NeuralBody(num_train_frame=cfg.num_frame, xyz_res=cfg.xyz_res, view_res=cfg.view_res,
                     compute_dtype=dt)
    r = NeuralBodyRender(net, voxel_size=cfg.dataset.voxel_size, max_out_sh=cfg.tpu.max_out_sh,
                         n_samples=cfg.train.n_samples, chunk_rays=cfg.tpu.eval_chunk)
    return r.to(device)


register("render", "NeuralBody", build_render)
