"""The synthetic performer and its cameras: the benchmark's frozen scene
generator.

Frozen copy of gpnerf_tpu_torch/data/synthetic.py at commit ffa1347 (the
scene the checkpoint artifacts/bench_ckpt.pth was trained on): a point-cloud
body of 6,890 points (the SMPL vertex count) whose arms swing and whose
body turns and moves with a continuous pose index, a ring of 12 posed
cameras at radius 2.7 m, and z-buffered splat renders as the images. Only
the numpy splat is kept (the port dispatches to a native kernel), so the
program and the reference read the same raw images made here. Added: any
camera on the ring's circle (`ring_camera`) and renders for a given K, R,
T (`render`).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

N_POINTS = 6890
RING_RADIUS = 2.7
FOCAL = 550.0
TARGET = (0.0, 0.9, 0.0)


def _lookat(cam_pos, target, up=(0.0, 1.0, 0.0)):
    """World->camera R, T with -y up convention (y-down image)."""
    cam_pos = np.asarray(cam_pos, np.float64)
    fwd = np.asarray(target, np.float64) - cam_pos
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)
    T = -R @ cam_pos
    return R.astype(np.float32), T.reshape(3, 1).astype(np.float32)


def ring_camera(ang, img_hw):
    """(K, R, T) of the camera at angle `ang` (radians) on the ring."""
    H, W = img_hw
    pos = np.array([RING_RADIUS * np.cos(ang), 0.9 + 0.25 * np.sin(3 * ang),
                    RING_RADIUS * np.sin(ang)])
    R, T = _lookat(pos, TARGET)
    K = np.array([[FOCAL, 0, W / 2.0], [0, FOCAL, H / 2.0], [0, 0, 1]], np.float32)
    return K, R, T


def make_cameras(n_cams, img_hw):
    """The ring's n_cams evenly spaced cameras: Ks, Rs, Ts stacked."""
    cams = [ring_camera(2 * np.pi * i / n_cams, img_hw) for i in range(n_cams)]
    return tuple(np.stack(c) for c in zip(*cams))


@lru_cache(maxsize=8)
def _canonical_template(seed=0):
    """Canonical body template: (N_POINTS, 3) positions, per-point part ids
    for articulation, and colors."""
    rng = np.random.default_rng(seed)

    def ellipsoid(n, center, radii):
        v = rng.normal(size=(n, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        r = rng.uniform(0.75, 1.0, size=(n, 1)) ** (1 / 3)
        return center + v * r * radii

    def capsule(n, p0, p1, radius):
        t = rng.uniform(0, 1, size=(n, 1))
        axis = np.asarray(p1) - np.asarray(p0)
        v = rng.normal(size=(n, 3))
        v -= (v @ (axis / np.linalg.norm(axis)))[:, None] * (axis / np.linalg.norm(axis))
        v /= np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-9)
        return np.asarray(p0) + t * axis + v * radius * rng.uniform(0.6, 1.0, size=(n, 1))

    parts = [
        (ellipsoid(2400, (0, 1.05, 0), (0.16, 0.30, 0.11)), 0),  # torso
        (ellipsoid(800, (0, 1.52, 0), (0.10, 0.11, 0.10)), 0),  # head
        (capsule(900, (-0.18, 1.30, 0), (-0.48, 1.05, 0), 0.045), 1),  # L arm
        (capsule(900, (0.18, 1.30, 0), (0.48, 1.05, 0), 0.045), 2),  # R arm
        (capsule(945, (-0.09, 0.75, 0), (-0.11, 0.08, 0), 0.06), 3),  # L leg
        (capsule(945, (0.09, 0.75, 0), (0.11, 0.08, 0), 0.06), 4),  # R leg
    ]
    pts = np.concatenate([p for p, _ in parts]).astype(np.float32)
    pid = np.concatenate([np.full(len(p), i) for p, i in parts])
    assert len(pts) == N_POINTS
    lo, hi = pts.min(0), pts.max(0)
    u = (pts - lo) / (hi - lo + 1e-9)
    colors = np.stack(
        [0.25 + 0.7 * u[:, 1], 0.3 + 0.5 * u[:, 0], 0.55 + 0.4 * u[:, 2]], axis=-1
    ).astype(np.float32)
    return pts, pid.astype(np.int32), np.clip(colors, 0, 1)


def canonical_body(frame_index, seed=0):
    """Articulated canonical body at a pose index: the arms swing with it."""
    pts, pid, colors = _canonical_template(seed)
    pts = pts.copy()
    swing = 0.6 * np.sin(0.35 * frame_index)
    for part, sign in ((1, 1.0), (2, -1.0)):
        m = pid == part
        shoulder = np.array([0.18 * (-1 if part == 1 else 1), 1.30, 0], np.float32)
        rel = pts[m] - shoulder
        a = sign * swing
        rot = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]],
                       np.float32)
        pts[m] = rel @ rot.T + shoulder
    return pts, colors


def body_pose(frame_index):
    """World pose of the canonical body: Rh (3,3), Th (1,3); world =
    canonical @ Rh^T + Th."""
    yaw = 0.12 * frame_index
    Rh = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]],
                  np.float32)
    Th = np.array([[0.15 * np.sin(0.1 * frame_index), 0.0, 0.1 * np.cos(0.13 * frame_index)]],
                  np.float32)
    return Rh, Th


def splat_render(world_pts, colors, K, R, T, img_hw, radius=3):
    """Z-buffered point-splat render: img float32 [0,1] (H,W,3), mask uint8."""
    H, W = img_hw
    cam = world_pts @ R.T + T.reshape(1, 3)
    z = cam[:, 2]
    front = z > 1e-6
    pix = cam @ K.T
    pix = pix[:, :2] / np.maximum(pix[:, 2:], 1e-9)
    px = np.round(pix[:, 0]).astype(np.int64)
    py = np.round(pix[:, 1]).astype(np.int64)
    offs = np.arange(-radius, radius + 1)
    oy, ox = np.meshgrid(offs, offs, indexing="ij")
    disc = (ox**2 + oy**2) <= radius**2
    ox, oy = ox[disc], oy[disc]
    n_off = len(ox)
    xs = px[:, None] + ox[None]
    ys = py[:, None] + oy[None]
    ok = front[:, None] & (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    idx = (ys * W + xs)[ok]
    z_rep = np.broadcast_to(z[:, None], (len(z), n_off))[ok]
    col_rep = np.broadcast_to(colors[:, None, :], (len(z), n_off, 3))[ok]
    zbuf = np.full(H * W, np.inf, np.float32)
    np.minimum.at(zbuf, idx, z_rep)
    win = z_rep <= zbuf[idx] * (1 + 1e-4)
    img = np.zeros((H * W, 3), np.float32)
    img[idx[win]] = col_rep[win]
    mask = (zbuf < np.inf).astype(np.uint8)
    return img.reshape(H, W, 3), mask.reshape(H, W)


class Scene:
    """The performer at pose indices, rendered by any camera; renders are
    kept per (pose, camera), so both sides of a run read one image."""

    def __init__(self, img_hw, seed=0):
        self.img_hw = tuple(img_hw)
        self.seed = seed
        self._renders = {}

    def vertices_world(self, frame):
        can, colors = canonical_body(frame, self.seed)
        Rh, Th = body_pose(frame)
        return can @ Rh.T + Th, colors, Rh, Th

    def render(self, frame, K, R, T):
        key = (float(frame), K.tobytes(), R.tobytes(), T.tobytes())
        if key not in self._renders:
            world, colors, _, _ = self.vertices_world(frame)
            self._renders[key] = splat_render(world, colors, K, R, T, self.img_hw)
        return self._renders[key]
