"""Image-quality evaluator (gpnerf_tpu/train/evaluator.py; reference
if_nerf.py:7-83): PSNR = -10 log10(mse) over the mask_at_box pixels, SSIM
(the skimage quirk, data_range 2.0) over the bounding-rect crop of the
reassembled image, optional side-by-side gt|pred JPEGs, and `summarize`
printing the means and saving results/<seq>/metrics.npy (the mse list).

`evaluate` takes a render dict of tensors (any device) and the host batch:
the training renderer's per-ray `rgb_map` over the padded box rays, or the
progressive renderer's image (`pred_chw`)."""

from __future__ import annotations

import os

import numpy as np
import torch

from gpnerf_tpu_torch.ops.image import bounding_rect, imwrite
from gpnerf_tpu_torch.ops.ssim import compare_ssim
from gpnerf_tpu_torch.render.demo import pred_img_hwc


def to_numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def scatter_rays_to_image(rgb_rows, mask_flat, H, W):
    """Per-ray values into an (H, W, 3) image at the mask pixels in scan
    order; only the leading min(n_rows, n_mask) mask pixels are written."""
    img = np.zeros((H * W, 3))
    idx = np.flatnonzero(mask_flat.reshape(-1))
    n = min(len(idx), len(rgb_rows))
    img[idx[:n]] = rgb_rows[:n]
    return img.reshape(H, W, 3)


def image_hw(cfg):
    return int(cfg.dataset.H * cfg.dataset.ratio), int(cfg.dataset.W * cfg.dataset.ratio)


def predicted_rows(output, batch, cfg):
    """(rgb_pred, rgb_gt) over the batch's n_rays valid rays, in scan order
    of the mask_at_box pixels."""
    n = int(np.asarray(batch["n_rays"]))
    if "pred_img" in output or "pred_chw" in output:
        H, W = image_hw(cfg)
        mask = np.asarray(batch["mask_at_box"]).reshape(H, W)
        rgb_pred = pred_img_hwc(output)[mask][:n]
    else:
        rgb_pred = to_numpy(output["rgb_map"])[:n]
    return rgb_pred, np.asarray(batch["rgb"])[:n]


class Evaluator:
    def __init__(self, cfg, seq_name):
        self.mse = []
        self.psnr = []
        self.ssim = []
        self.cfg = cfg
        self.seq_name = seq_name

    @staticmethod
    def psnr_metric(img_pred, img_gt):
        mse = np.mean((img_pred - img_gt) ** 2)
        return -10 * np.log(mse) / np.log(10)

    def ssim_metric(self, rgb_pred, rgb_gt, batch, save=True):
        H, W = image_hw(self.cfg)
        mask_at_box = np.asarray(batch["mask_at_box"]).reshape(H, W)
        img_pred = scatter_rays_to_image(rgb_pred, mask_at_box, H, W)
        img_gt = scatter_rays_to_image(rgb_gt, mask_at_box, H, W)
        if self.cfg.test.save_imgs and save:
            path = os.path.join(self.cfg.result_dir, self.seq_name)
            os.makedirs(path, exist_ok=True)
            name = f"{int(batch['frame_index'])}_cam{int(batch['cam_ind'])}.jpg"
            imwrite(os.path.join(path, name),
                    np.clip(np.concatenate((img_gt, img_pred), axis=1), 0, 1))
        x, y, w, h = bounding_rect(mask_at_box.astype(np.uint8))
        return compare_ssim(img_pred[y: y + h, x: x + w], img_gt[y: y + h, x: x + w],
                            multichannel=True)

    def evaluate(self, output, batch):
        rgb_pred, rgb_gt = predicted_rows(output, batch, self.cfg)
        self.mse.append(np.mean((rgb_pred - rgb_gt) ** 2))
        self.psnr.append(self.psnr_metric(rgb_pred, rgb_gt))
        self.ssim.append(self.ssim_metric(rgb_pred, rgb_gt, batch))

    def summarize(self):
        result_path = os.path.join(self.cfg.result_dir, self.seq_name, "metrics.npy")
        os.makedirs(os.path.dirname(result_path), exist_ok=True)
        metrics = {
            "mse": float(np.mean(self.mse)),
            "psnr": float(np.mean(self.psnr)),
            "ssim": float(np.mean(self.ssim)),
        }
        np.save(result_path, self.mse)
        for k in ("mse", "psnr", "ssim"):
            print(f"{k}: {metrics[k]}")
        self.mse, self.psnr, self.ssim = [], [], []
        return metrics
