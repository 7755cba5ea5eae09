"""Synthetic fixture dataset: a procedural articulated "human" scene.

Provides the exact batch contract of the real datasets
(reference libs/datasets/ZjumocapDataset.py:286-519) without any data
on disk: a deterministic point-cloud body (torso + head + 4 limbs, ~SMPL
vertex count), a ring of posed cameras, and z-buffered splat renders as
ground-truth images. Used by the test suite and the benchmark harness
(SURVEY.md §4: the reference has no tests; this is our fixture).

The body articulates with the frame index (swinging arms, body yaw /
translation through the world) so the task exercises the canonical-frame
logic (Rh / Th) and generalization across "poses".
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

N_POINTS = 6890  # match SMPL vertex count so head shapes match production


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


def make_cameras(n_cams=24, radius=2.7, img_hw=(512, 512), focal=550.0):
    H, W = img_hw
    Ks, Rs, Ts = [], [], []
    for i in range(n_cams):
        ang = 2 * np.pi * i / n_cams
        pos = np.array(
            [radius * np.cos(ang), 0.9 + 0.25 * np.sin(3 * ang), radius * np.sin(ang)]
        )
        R, T = _lookat(pos, (0.0, 0.9, 0.0))
        K = np.array(
            [[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1]], np.float32
        )
        Ks.append(K)
        Rs.append(R)
        Ts.append(T)
    return np.stack(Ks), np.stack(Rs), np.stack(Ts)


@lru_cache(maxsize=8)
def _canonical_template(seed=0):
    """Deterministic canonical body template: (N_POINTS, 3) positions and
    per-point part ids for articulation + colors."""
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
        v -= (v @ (axis / np.linalg.norm(axis)))[:, None] * (
            axis / np.linalg.norm(axis)
        )
        v /= np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-9)
        return np.asarray(p0) + t * axis + v * radius * rng.uniform(
            0.6, 1.0, size=(n, 1)
        )

    parts = [
        (ellipsoid(2400, (0, 1.05, 0), (0.16, 0.30, 0.11)), 0),  # torso
        (ellipsoid(800, (0, 1.52, 0), (0.10, 0.11, 0.10)), 0),  # head
        (capsule(900, (-0.18, 1.30, 0), (-0.48, 1.05, 0), 0.045), 1),  # L arm
        (capsule(900, (0.18, 1.30, 0), (0.48, 1.05, 0), 0.045), 2),  # R arm
        (capsule(945, (-0.09, 0.75, 0), (-0.11, 0.08, 0), 0.06), 3),  # L leg
        (capsule(945, (0.09, 0.75, 0), (0.11, 0.08, 0), 0.06), 4),  # R leg
    ]
    pts = np.concatenate([p for p, _ in parts]).astype(np.float32)
    pid = np.concatenate([np.full(len(p), i) for p, (_, i) in zip([q for q, _ in parts], parts)])
    assert len(pts) == N_POINTS
    # smooth position-based colors
    lo, hi = pts.min(0), pts.max(0)
    u = (pts - lo) / (hi - lo + 1e-9)
    colors = np.stack(
        [0.25 + 0.7 * u[:, 1], 0.3 + 0.5 * u[:, 0], 0.55 + 0.4 * u[:, 2]], axis=-1
    ).astype(np.float32)
    return pts, pid.astype(np.int32), np.clip(colors, 0, 1)


def canonical_body(frame_index, seed=0):
    """Articulated canonical body for a frame: arms swing with the frame."""
    pts, pid, colors = _canonical_template(seed)
    pts = pts.copy()
    swing = 0.6 * np.sin(0.35 * frame_index)
    for part, sign in ((1, 1.0), (2, -1.0)):
        m = pid == part
        shoulder = np.array([0.18 * (-1 if part == 1 else 1), 1.30, 0], np.float32)
        rel = pts[m] - shoulder
        a = sign * swing
        rot = np.array(
            [[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]],
            np.float32,
        )
        pts[m] = rel @ rot.T + shoulder
    return pts, colors


def body_pose(frame_index):
    """World pose of the canonical body: Rh (3,3), Th (1,3).
    world = canonical @ Rh^T + Th."""
    yaw = 0.12 * frame_index
    Rh = np.array(
        [[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]],
        np.float32,
    )
    Th = np.array([[0.15 * np.sin(0.1 * frame_index), 0.0, 0.1 * np.cos(0.13 * frame_index)]], np.float32)
    return Rh, Th


def splat_render(world_pts, colors, K, R, T, img_hw, radius=3):
    """Z-buffered point-splat render. Returns img float32 [0,1] (H,W,3) and
    uint8 mask. Uses the native C++ kernel when built."""
    H, W = img_hw
    cam = world_pts @ R.T + T.reshape(1, 3)
    z = cam[:, 2]
    front = z > 1e-6
    pix = (cam @ K.T)
    pix = pix[:, :2] / np.maximum(pix[:, 2:], 1e-9)
    px = np.round(pix[:, 0]).astype(np.int64)
    py = np.round(pix[:, 1]).astype(np.int64)

    from gpnerf_tpu_torch import native

    if native.available():
        return native.zsplat(
            px.astype(np.float64), py.astype(np.float64), z,
            np.ascontiguousarray(colors, np.float32), radius, (H, W),
        )

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


class SyntheticScene:
    """Caches per-(frame, cam) renders."""

    def __init__(self, n_cams=24, img_hw=(512, 512), seed=0):
        self.Ks, self.Rs, self.Ts = make_cameras(n_cams, img_hw=img_hw)
        self.img_hw = img_hw
        self.n_cams = n_cams
        self.seed = seed
        self._cache = {}

    def vertices_world(self, frame):
        can, colors = canonical_body(frame, self.seed)
        Rh, Th = body_pose(frame)
        return can @ Rh.T + Th, colors, Rh, Th, can

    def render_view(self, frame, cam):
        key = (frame, cam)
        if key not in self._cache:
            world, colors, _, _, _ = self.vertices_world(frame)
            img, mask = splat_render(
                world, colors, self.Ks[cam], self.Rs[cam], self.Ts[cam], self.img_hw
            )
            if len(self._cache) > 64:
                self._cache.clear()
            self._cache[key] = (img, mask)
        return self._cache[key]
