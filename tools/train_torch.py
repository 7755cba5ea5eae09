"""Train with the PyTorch/CUDA port (gpnerf_tpu_torch) on one device.

    python tools/train_torch.py --cfg configs/synthetic.yaml [key value ...]

The same `--cfg` plus dotted-override surface as tools/train.py. Training
runs on the GPU. Only `device cpu` given on the command line selects the
CPU (for small runs: e.g. `device cpu encoder.name tiny dataset.H 128
dataset.W 128 train.n_rays 256 train.n_samples 8`); a YAML file's `device`
key is the JAX package's platform choice and does not move the port off the
card. Without a CUDA device and without `device cpu` the script raises.

The datasets are the registry's: the synthetic fixture, ZJU-MoCap
(`ZjumocapDataset`) and THuman (`CustomDataset`, whose neg-ray convention
a dataset name holding "thuman" turns on), as in configs/trainzju_valzju.yaml
and configs/trainthu_valzju.yaml. Switches the port does not implement
raise NotImplementedError naming the key (render/base.check_train_scope,
data/loader.build_batchsampler): bf16 training, the mesh branch, data
parallelism, several frames per step. Float32 is float32: TF32 is off for
matmuls and cuDNN convolutions.
"""

from __future__ import annotations

import argparse
import os
import random
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpnerf_tpu_torch.config import cfg as default_cfg, update_config  # noqa: E402


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="GP-NeRF training, PyTorch port")
    parser.add_argument("--cfg", dest="yaml_file", required=True,
                        help="experiment config file", type=str)
    parser.add_argument("opts", help="modify config via dotted key/value pairs",
                        default=None, nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def select_device(opts):
    """'cpu' when the overrides say `device cpu`; else 'cuda', which must
    exist."""
    import torch

    pairs = dict(zip(opts[0::2], opts[1::2])) if opts else {}
    if pairs.get("device") == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run on the GPU, or pass `device cpu` to run on "
                           "the CPU")
    return torch.device("cuda")


def build(cfg, device, logger):
    """Renderer, criterion, optimizer, schedule, loaders and Trainer for
    `cfg` on `device`, resumed from cfg.render.resume_path when
    cfg.train.resume is set."""
    from gpnerf_tpu_torch.data.loader import DataLoader, build_batchsampler
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.train.checkpoint import load_checkpoint
    from gpnerf_tpu_torch.train.step import make_optimizer

    render = get("render", cfg.render.file)(cfg, device=device)
    render.init_variables(cfg.seed)
    criterion = get("criterion", cfg.train.criterion_file)(cfg)
    train_ds = get("dataset", cfg.dataset.train.file)(cfg, is_train=True)
    eval_ds = get("dataset", cfg.dataset.test.file)(cfg, is_train=False)
    if cfg.dataset.img_num_per_gpu != 1:
        raise NotImplementedError(
            f"dataset.img_num_per_gpu={cfg.dataset.img_num_per_gpu}: the port trains one "
            "frame per step")
    train_loader = DataLoader(
        train_ds, build_batchsampler(cfg, train_ds, 1, True, seed=cfg.seed),
        num_workers=cfg.workers)
    eval_loader = DataLoader(eval_ds, build_batchsampler(cfg, eval_ds, 1, False))
    optimizer, scheduler, schedule = make_optimizer(render, cfg)
    last_epoch = load_checkpoint(cfg, render, optimizer)
    logger.info(f"total parameters: {sum(p.numel() for p in render.parameters())}")
    trainer = get("trainer", cfg.train.file)(
        cfg, render=render, criterion=criterion, optimizer=optimizer, scheduler=scheduler,
        lr_schedule=schedule, logger=logger, log_dir=cfg.log_dir,
        performance_indicator=cfg.pi, last_iter=last_epoch)
    if last_epoch >= 0:  # the schedule continues from the resumed epoch
        for _ in range((last_epoch + 1) * cfg.train.ep_iter):
            scheduler.step()
    return trainer, train_loader, eval_loader


def main(argv=None):
    args = parse_args(argv)
    cfg = default_cfg.clone()
    update_config(cfg, args)
    device = select_device(args.opts)

    import torch

    from gpnerf_tpu_torch.utils.logging_utils import create_logger

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    random.seed(cfg.seed)
    np.random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)
    logger, _ = create_logger(cfg, rank=0, phase="train")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    logger.info(f"device: {device} ({name}), torch {torch.__version__}")
    logger.info(str(cfg))
    trainer, train_loader, eval_loader = build(cfg, device, logger)
    try:
        while True:  # Trainer.train exits the process after max_epoch
            trainer.train(train_loader, eval_loader)
    finally:
        train_loader.close()


if __name__ == "__main__":
    main()
