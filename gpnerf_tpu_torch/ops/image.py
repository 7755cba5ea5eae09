"""Host-side image operations (cv2 replacements; a copy of
gpnerf_tpu/ops/image.py). These numpy/PIL/scipy equivalents cover every cv2 call the reference data pipeline and evaluators make:
resize (INTER_AREA / INTER_NEAREST / INTER_LINEAR), undistort, Rodrigues,
erode/dilate, boundingRect, imread/imwrite
(reference libs/datasets/ZjumocapDataset.py:68-86,356-379;
libs/evaluators/if_nerf.py:31-46; libs/trainers/BaseTrainer.py:269-308).
"""

from __future__ import annotations

import numpy as np
from PIL import Image
from scipy import ndimage


def imread(path):
    return np.asarray(Image.open(path))


def imwrite(path, img):
    """img: float [0,1] or uint8, RGB."""
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    Image.fromarray(img).save(path)


def resize(img, size, interpolation="area"):
    """size: (W, H) like cv2. interpolation: 'area'|'nearest'|'linear'."""
    W, H = size
    mode = {
        "area": Image.BOX,
        "nearest": Image.NEAREST,
        "linear": Image.BILINEAR,
    }[interpolation]
    arr = img
    squeeze = False
    if arr.ndim == 2:
        pass
    elif arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[..., 0]
        squeeze = True
    if arr.dtype in (np.float32, np.float64):
        out = np.asarray(Image.fromarray(arr.astype(np.float32), mode="F").resize((W, H), mode)) \
            if arr.ndim == 2 else np.stack(
                [
                    np.asarray(Image.fromarray(arr[..., c].astype(np.float32), mode="F").resize((W, H), mode))
                    for c in range(arr.shape[2])
                ],
                axis=-1,
            )
    else:
        out = np.asarray(Image.fromarray(arr).resize((W, H), mode))
    if squeeze and out.ndim == 2:
        out = out[..., None]
    return out


def rodrigues(rvec):
    """Rotation vector -> rotation matrix (cv2.Rodrigues).
    rvec: (3,), (3,1) or (1,3). Returns (3,3)."""
    r = np.asarray(rvec, dtype=np.float64).reshape(3)
    theta = np.linalg.norm(r)
    if theta < 1e-12:
        return np.eye(3, dtype=np.float64)
    k = r / theta
    K = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]], dtype=np.float64
    )
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def undistort(img, K, D):
    """cv2.undistort equivalent: for each undistorted pixel, apply the
    forward distortion model to find the source pixel and sample bilinearly
    (nearest for integer masks). D: (k1, k2, p1, p2[, k3])."""
    D = np.asarray(D, dtype=np.float64).ravel()
    if np.all(D == 0):
        return img
    k1, k2, p1, p2 = D[:4]
    k3 = D[4] if len(D) > 4 else 0.0
    H, W = img.shape[:2]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    x = (u - cx) / fx
    y = (v - cy) / fy
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2**2 + k3 * r2**3
    x_d = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    y_d = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    map_u = x_d * fx + cx
    map_v = y_d * fy + cy
    coords = np.stack([map_v.ravel(), map_u.ravel()])
    is_int = img.dtype == np.uint8
    order = 1 if not is_int else 0
    if img.ndim == 2:
        out = ndimage.map_coordinates(
            img.astype(np.float64), coords, order=order, mode="constant"
        ).reshape(H, W)
    else:
        out = np.stack(
            [
                ndimage.map_coordinates(
                    img[..., c].astype(np.float64), coords, order=order, mode="constant"
                ).reshape(H, W)
                for c in range(img.shape[2])
            ],
            axis=-1,
        )
    return out.astype(img.dtype)


def erode(mask, ksize):
    """cv2.erode with an all-ones (ksize, ksize) kernel."""
    return ndimage.binary_erosion(
        mask.astype(bool), structure=np.ones((ksize, ksize), bool)
    ).astype(mask.dtype)


def dilate(mask, ksize):
    return ndimage.binary_dilation(
        mask.astype(bool), structure=np.ones((ksize, ksize), bool)
    ).astype(mask.dtype)


def bounding_rect(mask):
    """cv2.boundingRect: (x, y, w, h) of the mask's nonzero extent."""
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return 0, 0, 0, 0
    x, y = int(xs.min()), int(ys.min())
    return x, y, int(xs.max()) - x + 1, int(ys.max()) - y + 1
