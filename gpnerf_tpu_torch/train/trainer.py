"""Trainer and evaluation loop (gpnerf_tpu/train/trainer.py; reference
BaseTrainer.py:55-308), on one device or data parallel over the ranks of a
process group.

One `train()` call is one epoch of `ep_iter` loader batches; a batch of
several frames (`dataset.img_num_per_gpu` > 1) is one optimizer step per
frame in the list's order, each counted, as the JAX package steps a list on
one device (train/trainer.py:142-161). Over several ranks the data-parallel
width is `tpu.dp_size` clamped to the ranks (render/base.resolved_dp); above
1 each step is parallel/dp.make_dp_train_step's, one frame per rank (each
rank's loader yields its own shard; its jitter draws are seeded with
cfg.seed + rank). Only rank 0 validates, writes scalars and saves
checkpoints. Every `valiter_interval` steps
(checked after each batch) `quick_val` renders one
eval frame and logs mse/psnr/ssim; after each epoch but the first (every
`save_interval`) a checkpoint in the reference .pth layout, with
best-model tracking (`model_best.pth`) and pruning beyond 30 epoch files.
Losses are read back every `print_freq` steps, where a non-finite loss
stops training. `evaluate()` runs the eval loader through the renderer it
was given (the training renderer's `render_eval_fn` or the progressive
renderer's `render_demo_fn`) and reports the metrics and the mean render
time per frame (device synchronized around each frame; the progressive
renderer's without its encoder).

Out of scope (NotImplementedError naming the keys): a data-parallel group
of some ranks only, several frames per step with several ranks
(render/base.check_train_scope); evaluating a batch of several frames
(`one_frame` raises, where the JAX package's evaluation fails too)."""

from __future__ import annotations

import datetime
import math
import os
import sys
import time

import numpy as np
import torch

from gpnerf_tpu_torch.data.loader import data_loop
from gpnerf_tpu_torch.ops.image import imwrite, resize
from gpnerf_tpu_torch.registry import register
from gpnerf_tpu_torch.render.base import (
    batch_to_device,
    check_train_scope,
    resolved_dp,
)
from gpnerf_tpu_torch.render.demo import pred_img_hwc, synchronize
from gpnerf_tpu_torch.train.checkpoint import save_checkpoint
from gpnerf_tpu_torch.train.evaluator import (
    Evaluator,
    image_hw,
    scatter_rays_to_image,
    to_numpy,
)
from gpnerf_tpu_torch.train.step import train_step
from gpnerf_tpu_torch.utils.dist import get_rank, get_world_size
from gpnerf_tpu_torch.utils.metric_logger import MetricLogger, SmoothedValue

MAX_EPOCH_FILES = 30


def one_frame(data):
    """`data` when the loader gave one frame. A list of frames (an eval
    loader batched by `dataset.img_num_per_gpu` > 1) raises
    NotImplementedError naming the key: the JAX package's quick_val and
    evaluate cannot take one either (its `to_device` calls `.items()`)."""
    if isinstance(data, list):
        raise NotImplementedError(
            f"dataset.img_num_per_gpu: an eval batch of {len(data)} frames; evaluation "
            "renders one frame per batch")
    return data


class Trainer:
    def __init__(self, cfg, render, criterion=None, optimizer=None, scheduler=None,
                 lr_schedule=None, logger=None, log_dir=None, performance_indicator="psnr",
                 last_iter=-1, generator=None):
        self.cfg = cfg
        self.render = render
        self.criterion = criterion
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.lr_schedule = lr_schedule
        self.logger = logger
        self.log_dir = os.path.join(log_dir, cfg.output_dir) if log_dir else None
        self.epoch = last_iter + 1
        self.PI = performance_indicator
        self.best_performance = 0.0
        self.is_best = False
        self.max_epoch = cfg.train.max_epoch
        self.model_name = cfg.render.file
        self.iter_count = 0
        self.device = next(render.parameters()).device
        self.rank = get_rank()
        self.generator = generator
        if generator is None and optimizer is not None:
            self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + self.rank)
        self.dp = 1
        if optimizer is not None:
            world = get_world_size()
            check_train_scope(cfg, world)
            self.dp = resolved_dp(cfg, world)
            if self.dp > 1:
                from gpnerf_tpu_torch.parallel.dp import make_dp_train_step

                self._step = make_dp_train_step(render, criterion, optimizer, scheduler)
            else:
                self._step = lambda batch, generator: train_step(
                    render, criterion, optimizer, scheduler, batch, generator=generator)
            if logger is not None:
                logger.info(f"data parallel over {self.dp} of {world} rank(s) "
                            f"(tpu.dp_size={cfg.tpu.dp_size}); this is rank {self.rank}")
        self.writer = None
        if optimizer is not None and self.log_dir and self.rank == 0:
            from gpnerf_tpu_torch.utils.logging_utils import ScalarWriter

            self.writer = ScalarWriter(self.log_dir)
            self.logger.info(f"max epochs = {self.max_epoch} ")

    # ------------------------------------------------------------------
    def _log_metrics(self, metric_logger, pending):
        """Read back the pending steps' metrics in one transfer; a
        non-finite loss stops training."""
        keys = list(pending[0][1])
        vals = torch.stack([torch.stack([m[k].float() for k in keys])
                            for _, m in pending]).cpu().numpy()
        for (it, _), row in zip(pending, vals):
            m = dict(zip(keys, row.tolist()))
            if not math.isfinite(m["loss"]):
                self.logger.info(f"Loss is {m['loss']}, stopping training")
                sys.exit(1)
            metric_logger.update(lr=self.lr_schedule(it), **m)

    def train(self, train_loader, eval_loader):
        self.evaluator = Evaluator(self.cfg, "eval")
        start_time = time.time()
        metric_logger = MetricLogger(delimiter="  ")
        metric_logger.add_meter("lr", SmoothedValue(window_size=1, fmt="{value:.6f}"))
        header = f"Epoch: [{self.epoch}]"
        print_freq = self.cfg.train.print_freq
        eval_data_iter = data_loop(eval_loader)
        if self.epoch > self.max_epoch:
            self.logger.info("Optimization is done!")
            sys.exit(0)
        self.render.train()
        pending = []  # (step index, metrics) not yet read back
        for data in metric_logger.log_every(train_loader, print_freq, header, self.logger):
            for frame in data if isinstance(data, list) else [data]:
                batch = batch_to_device(frame, self.device)
                metrics, _ = self._step(batch, generator=self.generator)
                pending.append((self.iter_count, metrics))
                self.iter_count += 1
            at_val = self.iter_count % self.cfg.train.valiter_interval == 0
            if len(pending) >= print_freq or at_val:
                self._log_metrics(metric_logger, pending)
                pending = []
            if at_val and self.cfg.train.val_when_train and self.rank == 0:
                performance = self.quick_val(eval_data_iter)
                if self.writer:
                    self.writer.add_scalar(self.PI, performance, self.iter_count)
                self.logger.info(f"Now: {self.PI} is {performance:.4f}")
        if pending:
            self._log_metrics(metric_logger, pending)
        log_stats = {
            **{f"train_{k}": m.global_avg for k, m in metric_logger.meters.items()},
            "epoch": self.epoch,
            "iter": self.iter_count,
        }
        if self.writer:
            for key, val in log_stats.items():
                self.writer.add_scalar(key, val, log_stats["iter"])

        if self.rank == 0 and self.epoch > 0 and self.epoch % self.cfg.train.save_interval == 0:
            self.save(eval_loader)
        self.logger.info("Training time {}".format(
            datetime.timedelta(seconds=int(time.time() - start_time))))
        self.epoch += 1

    def save(self, eval_loader):
        """The epoch checkpoint (reference BaseTrainer.py:154-199)."""
        if self.cfg.train.val_when_train:
            performance = self.quick_val(data_loop(eval_loader))
            if self.writer:
                self.writer.add_scalar(self.PI, performance, self.iter_count)
            self.is_best = performance > self.best_performance
            if self.is_best:
                self.best_performance = performance
            self.logger.info(f"Now: best {self.PI} is {self.best_performance}")
        else:
            performance = -1
        filename = f"{self.epoch}.pth" if self.cfg.train.save_every_checkpoint else "latest.pth"
        save_dir = os.path.join(self.log_dir, self.cfg.output_dir)
        save_checkpoint(
            {
                "epoch": self.epoch,
                "model": self.model_name,
                f"performance/{self.PI}": performance,
                "state_dict": {k: v.detach().cpu() for k, v in self.render.state_dict().items()},
                "optimizer": self.optimizer.state_dict(),
            },
            self.is_best, save_dir, filename=filename,
        )
        self.logger.info(f"save model to {save_dir}")
        epochs = [int(f.split(".")[0]) for f in os.listdir(save_dir)
                  if f not in ("latest.pth", "model_best.pth") and f.endswith(".pth")]
        if len(epochs) > MAX_EPOCH_FILES:
            os.remove(os.path.join(save_dir, f"{min(epochs)}.pth"))

    # ------------------------------------------------------------------
    def quick_val(self, eval_data_iter):
        """Render one eval frame and log its loss and metrics (reference
        BaseTrainer.py:207-252). Returns the performance indicator."""
        H, W = image_hw(self.cfg)
        val_data = one_frame(next(eval_data_iter))
        batch = batch_to_device(val_data, self.device)
        ret = self.render.render_eval_fn()(batch)
        image_stats = self.process_img(ret, val_data, W, H)
        val_stats = {k: float(v) for k, v in self.criterion(ret, batch, is_train=False).items()}
        self.evaluator.evaluate(ret, val_data)
        val_stats.update({"mse": self.evaluator.mse[-1], "psnr": self.evaluator.psnr[-1],
                          "ssim": self.evaluator.ssim[-1]})
        if self.writer:
            for k, v in val_stats.items():
                self.writer.add_scalar(f"eval_{k}", v, self.iter_count)
            for k, v in image_stats.items():
                self.writer.add_image(f"val_iter/{k}", v, self.iter_count)
        self.logger.info("rgb_loss: {:.4f}, mse: {:.4f}, psnr: {:.4f}, ssim: {:.4f}".format(
            val_stats["rgb_loss"], val_stats["mse"], val_stats["psnr"], val_stats["ssim"]))
        return val_stats[self.PI]

    # ------------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, eval_loader, result_path, is_vis=False):
        """Every eval frame through the renderer (reference
        BaseTrainer.py:255-280). Returns (metrics or None, mean seconds per
        frame); metrics carry `overflows_max` for a progressive render,
        whose frame time excludes the encoder, as the reference's rtime
        does: the first frame takes its split from `render.render` (its
        `etime` and `rtime`), and every later frame's time is the whole
        render's less that `etime` (the JAX package's frame-0 estimate)."""
        self.evaluator = Evaluator(self.cfg, self.cfg.test.test_seq)
        H, W = image_hw(self.cfg)
        os.makedirs(result_path, exist_ok=True)
        self.render.eval()
        is_demo = hasattr(self.render, "render_demo_fn")
        render_fn = self.render.render_demo_fn() if is_demo else self.render.render_eval_fn()
        total_time, etime, count, overflow_rows = 0.0, 0.0, 0, []
        for data in eval_loader:
            batch = batch_to_device(one_frame(data), self.device)
            if count == 0:  # untimed warm-up on the first frame
                render_fn(batch)
            if is_demo and count == 0:
                ret = self.render.render(batch)
                etime, rtime = ret["etime"], ret["rtime"]
            else:
                synchronize(self.device)
                t0 = time.perf_counter()
                ret = render_fn(batch)
                synchronize(self.device)
                rtime = max(time.perf_counter() - t0 - etime, 0.0)
            total_time += rtime
            if is_vis:
                imwrite(f"{result_path}/{count}.jpg", self.process_img(ret, data, W, H)["render_img"])
            self.evaluator.evaluate(ret, data)
            if "overflows" in ret:
                overflow_rows.append(to_numpy(ret["overflows"]))
            count += 1
        metrics = self.evaluator.summarize() if self.cfg.head.rgb.use_rgbhead else None
        if overflow_rows:
            ov = np.stack(overflow_rows)
            print(f"overflows(ray,perrayK,sigma,rgb): max={ov.max(axis=0).tolist()} "
                  f"mean={ov.mean(axis=0).tolist()}")
            if metrics is not None:
                metrics["overflows_max"] = ov.max(axis=0).tolist()
        avg = total_time / max(count, 1)
        if is_demo:
            print(f"avg encoder time (frame-0 estimate): {etime}s per sample")
            print(f"avg total render time (encoder excluded): {avg}s per sample")
        else:
            print(f"avg total render time: {avg}s per sample")
        return metrics, avg

    # ------------------------------------------------------------------
    @staticmethod
    def process_img(pred, batch, W, H):
        """src views | gt | pred side by side, halved (reference
        BaseTrainer.py:284-308)."""
        mask_at_box = np.asarray(batch["mask_at_box"]).reshape(H, W)
        n = int(np.asarray(batch["n_rays"]))
        if "pred_img" in pred or "pred_chw" in pred:
            pred_img = pred_img_hwc(pred)
        else:
            pred_img = scatter_rays_to_image(to_numpy(pred["rgb_map"])[:n, :3], mask_at_box, H, W)
        gt_img = scatter_rays_to_image(np.asarray(batch["rgb"])[:n, :3], mask_at_box, H, W)
        src_imgs = np.asarray(batch["src_imgs"])
        if src_imgs.dtype == np.uint8:
            src_imgs = src_imgs.astype(np.float32) / 255.0
        else:
            src_imgs = src_imgs * 0.5 + 0.5
        vis = np.hstack([*src_imgs, gt_img, pred_img])
        vis = resize(vis.astype(np.float32), (vis.shape[1] // 2, vis.shape[0] // 2), "area")
        return {"render_img": np.clip(vis, 0.0, 1.0)}


def build_trainer(cfg, **kwargs):
    return Trainer(cfg, **kwargs)


register("trainer", "BaseTrainer", build_trainer)
