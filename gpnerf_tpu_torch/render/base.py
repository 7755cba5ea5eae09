"""Per-frame geometry shared by the renderers (gpnerf_tpu/render/base.py):
source-image normalization, camera matrices, the frame's SMPL features and
sparse pyramid, and the world -> level-0 voxel mapping (reference
BaseRender.py:52-73)."""

from __future__ import annotations

import numpy as np
import torch

from gpnerf_tpu_torch.ops.projection import gather_smpl_features
from gpnerf_tpu_torch.ops.sparse_conv import SparseLevel


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
    }


def points_to_dhw_vox(pts, batch, voxel_size):
    """World points -> canonical -> level-0 voxel units (dhw). (P, 3)."""
    can = (pts.reshape(-1, 3) - batch["Th"].reshape(1, 3)) @ batch["Rh"]
    dhw = can.flip(-1)
    min_dhw = batch["bounds"][0].flip(-1)
    vs = torch.tensor(voxel_size[::-1], dtype=dhw.dtype, device=dhw.device)
    return (dhw - min_dhw) / vs
