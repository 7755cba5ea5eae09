"""Mesh export (a trimesh replacement for the save paths), the port's own
copy of gpnerf_tpu/utils/mesh_io.py.

The reference wraps marching-cubes output in `trimesh.Trimesh` and exports
.ply (its BaseRender.py:271, demo_render.py:373, evaluators/
if_nerf_mesh.py:49-60); this module provides a minimal mesh container, a
binary PLY writer and reader, and an OBJ writer."""

from __future__ import annotations

import struct

import numpy as np


class Trimesh:
    def __init__(self, vertices, faces):
        self.vertices = np.asarray(vertices, np.float64)
        self.faces = np.asarray(faces, np.int64)

    def export(self, path):
        if str(path).endswith(".ply"):
            write_ply(path, self.vertices, self.faces)
        elif str(path).endswith(".obj"):
            write_obj(path, self.vertices, self.faces)
        else:
            raise ValueError(f"unsupported mesh format: {path}")
        return path


def write_ply(path, vertices, faces):
    """Binary little-endian PLY."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {len(vertices)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(faces)}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(vertices.astype("<f4").tobytes())
        face_block = np.empty((len(faces), 13), np.uint8)
        face_block[:, 0] = 3
        face_block[:, 1:] = faces.astype("<i4").view(np.uint8).reshape(len(faces), 12)
        f.write(face_block.tobytes())


def write_obj(path, vertices, faces):
    with open(path, "w") as f:
        for v in vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in faces:
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")


def read_ply(path):
    """Reader for round-trip tests (binary little-endian, as written)."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        lines = header.decode("ascii").splitlines()
        nv = int([ln for ln in lines if ln.startswith("element vertex")][0].split()[-1])
        nf = int([ln for ln in lines if ln.startswith("element face")][0].split()[-1])
        verts = np.frombuffer(f.read(nv * 12), "<f4").reshape(nv, 3)
        faces = np.empty((nf, 3), np.int64)
        raw = f.read(nf * 13)
        for i in range(nf):
            n = raw[i * 13]
            assert n == 3
            faces[i] = struct.unpack_from("<3i", raw, i * 13 + 1)
    return verts.copy(), faces
