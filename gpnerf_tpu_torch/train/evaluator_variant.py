"""Variant image evaluator (gpnerf_tpu/train/evaluator_variant.py;
reference test_if_nerf.py:1-85): the metrics of train/evaluator.py over
`output["rgb"]` (per-ray rows, numpy or tensors) with an optional
`output["mask_at_box"]` in place of the batch's. The reference wires it
into no code path; it completes the evaluator surface."""

from __future__ import annotations

import os

import numpy as np

from gpnerf_tpu_torch.ops.image import bounding_rect
from gpnerf_tpu_torch.ops.ssim import compare_ssim
from gpnerf_tpu_torch.train.evaluator import image_hw, scatter_rays_to_image, to_numpy


class Evaluator:
    def __init__(self, cfg, seq_name="variant"):
        self.cfg = cfg
        self.seq_name = seq_name
        self.mse, self.psnr, self.ssim = [], [], []

    @staticmethod
    def psnr_metric(img_pred, img_gt):
        mse = np.mean((img_pred - img_gt) ** 2)
        return -10 * np.log(mse) / np.log(10)

    def evaluate(self, output, batch):
        """mse and PSNR over the batch's n_rays rows (all rows without
        it), SSIM over the mask's bounding-rect crop of the reassembled
        images."""
        rgb_pred = to_numpy(output["rgb"])
        n = int(np.asarray(batch.get("n_rays", len(rgb_pred))))
        rgb_pred = rgb_pred[:n]
        rgb_gt = np.asarray(batch["rgb"])[:n]
        H, W = image_hw(self.cfg)
        mask = to_numpy(output.get("mask_at_box", batch["mask_at_box"])).reshape(H, W)
        self.mse.append(float(np.mean((rgb_pred - rgb_gt) ** 2)))
        self.psnr.append(float(self.psnr_metric(rgb_pred, rgb_gt)))
        img_pred = scatter_rays_to_image(rgb_pred, mask, H, W)
        img_gt = scatter_rays_to_image(rgb_gt, mask, H, W)
        x, y, w, h = bounding_rect(mask.astype(np.uint8))
        self.ssim.append(compare_ssim(img_pred[y: y + h, x: x + w], img_gt[y: y + h, x: x + w],
                                      multichannel=True))

    def summarize(self):
        """The means, printed; the mse list saved as
        result_dir/<seq_name>/metrics.npy."""
        metrics = {"mse": float(np.mean(self.mse)), "psnr": float(np.mean(self.psnr)),
                   "ssim": float(np.mean(self.ssim))}
        path = os.path.join(self.cfg.result_dir, self.seq_name)
        os.makedirs(path, exist_ok=True)
        np.save(os.path.join(path, "metrics.npy"), self.mse)
        for k, v in metrics.items():
            print(f"{k}: {v}")
        self.mse, self.psnr, self.ssim = [], [], []
        return metrics
