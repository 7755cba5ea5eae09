# Frozen copy of gpnerf_tpu_torch/data/geometry.py at commit ffa1347, the benchmark's plain
# reference: the port's hand-written kernels, registries and the paths no
# configuration of the benchmark runs are removed; nothing here is imported
# from the program.
"""Host-side (numpy) geometry kernels for the data pipeline.

Behavioral port of reference libs/datasets/data_utils.py:47-376 —
ray generation, 3D-bound 2D masks, ray/AABB slab intersection with the
THuman negative-direction handling, train/test ray sampling, view selection,
and the canonical-SMPL augmentation hook. cv2 is not available in this
environment; `fill_poly` uses PIL and `clear_msk_noise` approximates
cv2.findContours-area-0 removal by dropping tiny connected components
(scipy.ndimage.label) — both deviations are metric-invisible and noted here
for the parity audit.
"""

from __future__ import annotations

import numpy as np
from PIL import Image, ImageDraw
from scipy import ndimage


def get_rays(H, W, K, R, T):
    """World-space rays for every pixel (data_utils.py:47-63).
    Returns rays_o, rays_d of shape (H, W, 3); rays_d un-normalized."""
    R_inv = np.linalg.inv(R)
    Tc = -R_inv @ T
    rays_o = Tc.ravel()
    i, j = np.meshgrid(
        np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32), indexing="xy"
    )
    xy1 = np.stack([i, j, np.ones_like(i)], axis=2)
    pixel_camera = np.dot(xy1, np.linalg.inv(K).T)
    pixel_world = (pixel_camera @ R_inv.T) + Tc.reshape(1, 1, 3)
    rays_d = pixel_world - rays_o[None, None]
    rays_o = np.broadcast_to(rays_o, rays_d.shape)
    return rays_o.astype(np.float32), rays_d.astype(np.float32)


def get_bound_corners(bounds):
    min_x, min_y, min_z = bounds[0]
    max_x, max_y, max_z = bounds[1]
    return np.array(
        [
            [min_x, min_y, min_z],
            [min_x, min_y, max_z],
            [min_x, max_y, min_z],
            [min_x, max_y, max_z],
            [max_x, min_y, min_z],
            [max_x, min_y, max_z],
            [max_x, max_y, min_z],
            [max_x, max_y, max_z],
        ]
    )


def project(xyz, K, RT):
    """(data_utils.py:239-250). xyz (N,3), K (3,3), RT (3,4) -> (N,2)."""
    xyz = np.dot(xyz, RT[:, :3].T) + RT[:, 3:].T
    xyz = np.dot(xyz, K.T)
    return xyz[:, :2] / xyz[:, 2:]


def fill_poly(mask, pts, value=1):
    """cv2.fillPoly replacement via PIL (closed polygon, inclusive fill)."""
    img = Image.fromarray(mask)
    ImageDraw.Draw(img).polygon([(float(x), float(y)) for x, y in pts], fill=value)
    np.copyto(mask, np.asarray(img))
    return mask


def get_bound_2d_mask(bounds, K, RT, H, W):
    """Project the 3D AABB's 6 faces and rasterize (data_utils.py:82-93)."""
    corners_3d = get_bound_corners(bounds)
    corners_2d = np.round(project(corners_3d, K, RT)).astype(np.int64)
    mask = np.zeros((H, W), dtype=np.uint8)
    for face in (
        [0, 1, 3, 2, 0],
        [4, 5, 7, 6, 5],
        [0, 1, 5, 4, 0],
        [2, 3, 7, 6, 2],
        [0, 2, 6, 4, 0],
        [1, 3, 7, 5, 1],
    ):
        fill_poly(mask, corners_2d[face], 1)
    return mask


def get_near_far(bounds, ray_o, ray_d):
    """Ray/AABB slab intersection requiring exactly 2 hits, with the
    negative-direction sign handling for THuman (data_utils.py:96-130).
    Returns near, far (only for mask_at_box rays), mask_at_box (all rays).

    The numpy path alone (the port dispatches to its native C++ kernel)."""
    return _get_near_far_np(bounds, ray_o, ray_d)


def _get_near_far_np(bounds, ray_o, ray_d):
    bounds = bounds + np.array([-0.01, 0.01])[:, None]
    ray_d = ray_d.copy()
    nominator = bounds[None] - ray_o[:, None]
    ray_d[np.abs(ray_d) < 1e-5] = 1e-5
    d_intersect = (nominator / ray_d[:, None]).reshape(-1, 6)
    p_intersect = d_intersect[..., None] * ray_d[:, None] + ray_o[:, None]
    min_x, min_y, min_z, max_x, max_y, max_z = bounds.ravel()
    eps = 1e-6
    p_mask_at_box = (
        (p_intersect[..., 0] >= (min_x - eps))
        * (p_intersect[..., 0] <= (max_x + eps))
        * (p_intersect[..., 1] >= (min_y - eps))
        * (p_intersect[..., 1] <= (max_y + eps))
        * (p_intersect[..., 2] >= (min_z - eps))
        * (p_intersect[..., 2] <= (max_z + eps))
    )
    mask_at_box = p_mask_at_box.sum(-1) == 2
    p_intervals = p_intersect[mask_at_box][p_mask_at_box[mask_at_box]].reshape(-1, 2, 3)
    ray_o = ray_o[mask_at_box]
    ray_d = ray_d[mask_at_box]
    norm_ray = np.linalg.norm(ray_d, axis=1)
    neg_mask = (
        np.array(
            ((p_intervals[:, 0] - ray_o) * ray_d).sum(axis=1) < 0.0, dtype=np.int64
        )
        * -2
        + 1
    )
    d0 = np.linalg.norm(p_intervals[:, 0] - ray_o, axis=1) / norm_ray * neg_mask
    d1 = np.linalg.norm(p_intervals[:, 1] - ray_o, axis=1) / norm_ray * neg_mask
    near = np.minimum(d0, d1)
    far = np.maximum(d0, d1)
    return near, far, mask_at_box


def clear_msk_noise(msk, tag):
    """Remove degenerate mask components (data_utils.py:6-15 removes
    contours with cv2.contourArea == 0; components of <= 2 pixels always
    qualify — the approximation used here)."""
    flag = (msk == tag).astype(np.uint8)
    labels, n = ndimage.label(flag)
    if n:
        sizes = ndimage.sum_labels(flag, labels, index=np.arange(1, n + 1))
        kill = np.isin(labels, np.flatnonzero(sizes <= 2) + 1)
        msk = msk.copy()
        msk[kill] = 0
    return msk


def get_nearest_pose_ids(tar_cam_loc, ref_cam_locs, num_select, tar_id=-1):
    """Euclidean camera-center nearest views (data_utils.py:133-161)."""
    num_cams = len(ref_cam_locs)
    if num_cams <= 3:
        num_select = min(num_select, num_cams)
    else:
        num_select = min(num_select, num_cams - 1)
    dists = np.linalg.norm(tar_cam_loc - ref_cam_locs, axis=1)
    if tar_id >= 0:
        assert tar_id < num_cams
        dists[tar_id] = 1e3
    return np.argsort(dists)[:num_select]


def transform_can_smpl(xyz, rot_ratio=0.0):
    """Canonical-space rot/trans augmentation (data_utils.py:349-376) —
    disabled in the reference (rot_ratio defaults to 0 and is never
    overridden); the identity path is kept for contract parity."""
    center = np.zeros(3, np.float32)
    rot = np.eye(2, dtype=np.float32)
    trans = np.zeros(3, np.float32)
    if np.random.uniform() > rot_ratio:
        return xyz, center, rot, trans
    xyz = xyz.copy()
    rot_range = np.pi / 32
    t = np.random.uniform(-rot_range, rot_range)
    rot = np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]], np.float32)
    center = np.mean(xyz, axis=0)
    xyz = xyz - center
    xyz[:, [0, 2]] = np.dot(xyz[:, [0, 2]], rot.T)
    xyz = xyz + center
    x_trans = np.random.uniform(-0.05, 0.05)
    z_trans = np.random.uniform(-0.025, 0.025)
    trans = np.array([x_trans, 0, z_trans], np.float32)
    xyz = xyz + trans
    return xyz, center, rot, trans


def sample_ray(img, msk, K, R, T, bounds, nrays, split, body_sample_ratio):
    """Train/test ray sampling (data_utils.py:253-346).

    Train: loop until `nrays` sampled — body_sample_ratio from body-mask
    pixels, rest from the bound mask, deduplicated; only rays hitting the
    AABB are kept, so the returned count is <= nrays (the caller pads).
    Test: every pixel inside the bound mask.
    """
    H, W = img.shape[:2]
    ray_o_full, ray_d_full = get_rays(H, W, K, R, T)

    pose = np.concatenate([R, T.reshape(-1, 1)], axis=1)
    bound_mask = get_bound_2d_mask(bounds, K, pose, H, W)

    img = img.copy()
    img[bound_mask != 1] = 0
    if msk.ndim == 3:
        msk = msk[..., 0]
    msk = msk * bound_mask
    bound_mask = bound_mask.copy()
    bound_mask[msk == 100] = 0

    if split != "test":
        nsampled_rays = 0
        ray_o_list, ray_d_list, rgb_list = [], [], []
        near_list, far_list, coord_list = [], [], []
        mask_at_box_list, body_msk_list = [], []
        index_list = set()
        body_msk = clear_msk_noise(msk, 1)
        coord_body_all = np.argwhere(body_msk == 1)
        coord_bound_all = np.argwhere(bound_mask == 1)
        if len(coord_bound_all) == 0:
            raise ValueError("empty bound mask")
        while nsampled_rays < nrays:
            n_body = int((nrays - nsampled_rays) * body_sample_ratio)
            n_rand = (nrays - nsampled_rays) - n_body
            if len(coord_body_all) > 0:
                coord_body = coord_body_all[
                    np.random.randint(0, len(coord_body_all), n_body)
                ]
            else:
                coord_body = np.zeros((0, 2), np.int64)
            coord = coord_bound_all[np.random.randint(0, len(coord_bound_all), n_rand)]
            if len(coord_body) > 0:
                coord = np.concatenate([coord_body, coord], axis=0)

            # dedupe (reference's index-set logic, data_utils.py:301-308;
            # note it also swaps coord axes to (x, y) there — kept)
            cur_set = set((coord[:, 1] * W + coord[:, 0]).tolist())
            new_set = cur_set - index_list
            no_repeat = np.fromiter(new_set, dtype=np.int64, count=len(new_set))
            coord = coord[: len(no_repeat)]
            coord[:, 0] = no_repeat % W
            coord[:, 1] = no_repeat // W
            index_list.update(new_set)

            ray_o_ = ray_o_full[coord[:, 0], coord[:, 1]]
            ray_d_ = ray_d_full[coord[:, 0], coord[:, 1]]
            rgb_ = img[coord[:, 0], coord[:, 1]]
            out_body = (body_msk > 0).astype(np.float32)
            msk_ = out_body[coord[:, 0], coord[:, 1]]

            near_, far_, mask_at_box = get_near_far(bounds, ray_o_, ray_d_)

            ray_o_list.append(ray_o_[mask_at_box])
            ray_d_list.append(ray_d_[mask_at_box])
            rgb_list.append(rgb_[mask_at_box])
            body_msk_list.append(msk_[mask_at_box])
            near_list.append(near_)
            far_list.append(far_)
            coord_list.append(coord[mask_at_box])
            mask_at_box_list.append(mask_at_box[mask_at_box])
            nsampled_rays += len(near_)

        ray_o = np.concatenate(ray_o_list).astype(np.float32)
        ray_d = np.concatenate(ray_d_list).astype(np.float32)
        rgb = np.concatenate(rgb_list).astype(np.float32)
        out_body_msk = np.concatenate(body_msk_list).astype(np.float32)
        near = np.concatenate(near_list).astype(np.float32)
        far = np.concatenate(far_list).astype(np.float32)
        coord = np.concatenate(coord_list)
        mask_at_box = np.concatenate(mask_at_box_list)
    else:
        body_msk = clear_msk_noise(msk, 1)
        rgb = img.reshape(-1, img.shape[-1]).astype(np.float32)
        ray_o = ray_o_full.reshape(-1, 3).astype(np.float32)
        ray_d = ray_d_full.reshape(-1, 3).astype(np.float32)
        near, far, mask_at_box = get_near_far(bounds, ray_o, ray_d)
        near = near.astype(np.float32)
        far = far.astype(np.float32)
        out_body_msk = (body_msk > 0).astype(np.float32).reshape(-1)[mask_at_box]
        rgb = rgb[mask_at_box]
        ray_o = ray_o[mask_at_box]
        ray_d = ray_d[mask_at_box]
        coord = np.zeros([len(rgb), 2], np.int64)

    return rgb, ray_o, ray_d, near, far, coord, mask_at_box, out_body_msk
