"""Mesh evaluator (gpnerf_tpu/train/mesh_evaluator.py; reference
evaluators/if_nerf_mesh.py:7-60): saves the thresholded alpha points of a
frame, exports the extracted mesh as .ply, and a voxel view (one box per
occupied voxel, which the reference builds through its VoxelGrid).

`output` is a `render_mesh` dict (`cube`, `mesh`); `batch` the host batch."""

from __future__ import annotations

import os

import numpy as np

from gpnerf_tpu_torch.utils.mesh_io import Trimesh


class MeshEvaluator:
    def __init__(self, cfg, seq_name="mesh"):
        self.cfg = cfg
        self.seq_name = seq_name

    def _dir(self):
        path = os.path.join(self.cfg.result_dir, self.seq_name)
        os.makedirs(path, exist_ok=True)
        return path

    def evaluate(self, output, batch):
        """Save thresholded alpha points (if_nerf_mesh.py:18-30)."""
        cube = np.asarray(output["cube"])
        th = 1.0 / self.cfg.test.mesh_th
        pts = np.argwhere(cube > th)
        idx = int(np.asarray(batch["frame_index"]))
        np.save(os.path.join(self._dir(), f"pts_{idx}.npy"), pts)

    def visualize(self, output, batch):
        """Export the mesh (if_nerf_mesh.py:49-60)."""
        mesh = output["mesh"]
        idx = int(np.asarray(batch["frame_index"]))
        path = os.path.join(self._dir(), f"mesh_{idx}.ply")
        mesh.export(path)
        return path

    def visualize_voxel(self, output, batch):
        """Occupied-voxel box mesh (if_nerf_mesh.py:36-47 via VoxelGrid)."""
        cube = np.asarray(output["cube"])
        th = 1.0 / self.cfg.test.mesh_th
        occ = np.argwhere(cube > th)
        verts, faces = voxel_boxes(occ)
        idx = int(np.asarray(batch["frame_index"]))
        path = os.path.join(self._dir(), f"voxels_{idx}.ply")
        Trimesh(verts, faces).export(path)
        return path


_BOX_VERTS = np.array(
    [[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)], np.float64
)
_BOX_FACES = np.array(
    [
        [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
        [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
        [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],
    ],
    np.int64,
)


def voxel_boxes(occ_coords):
    """One unit cube per occupied voxel coordinate (N, 3)."""
    n = len(occ_coords)
    if n == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    verts = (occ_coords[:, None, :] + _BOX_VERTS[None]).reshape(-1, 3)
    faces = (_BOX_FACES[None] + (np.arange(n) * 8)[:, None, None]).reshape(-1, 3)
    return verts, faces
