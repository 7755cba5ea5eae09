"""Evaluate a checkpoint with the PyTorch/CUDA port (gpnerf_tpu_torch).

    python tools/inference_torch.py --cfg configs/trainzju_valzju.yaml \
        render.file demo_render render.resume_path <ckpt> \
        dataset.test.sampler FrameSampler [key value ...]

The surface of tools/inference.py: `--cfg` plus dotted overrides. The
renderer named by `render.file` (the progressive `demo_render` or
`BaseRender`) loads `render.resume_path` strictly, the test split runs
through `Trainer.evaluate`, and the script prints the mse/psnr/ssim means,
the overflow counters of a progressive render and the mean render time per
frame; with `test.is_vis` it writes each frame's src | gt | pred image under
`result_dir/test.test_seq`, and with `test.profile` it first logs
`Renderer.profile`'s per-stage times of the first frame.

Evaluation runs on the GPU. Only `device cpu` given on the command line
selects the CPU; a YAML file's `device` key is the JAX package's platform
choice and does not move the port off the card. Without a CUDA device and
without `device cpu` the script raises. Float32 is float32: TF32 is off for
matmuls and cuDNN convolutions.
"""

from __future__ import annotations

import json
import os
import random
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpnerf_tpu_torch.config import cfg as default_cfg, update_config  # noqa: E402
from train_torch import parse_args, select_device  # noqa: E402


def main(argv=None):
    args = parse_args(argv)
    cfg = default_cfg.clone()
    update_config(cfg, args)
    device = select_device(args.opts)

    import torch

    from gpnerf_tpu_torch.data.loader import DataLoader, build_batchsampler
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render.base import batch_to_device
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model
    from gpnerf_tpu_torch.utils.logging_utils import create_logger

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    random.seed(cfg.seed)
    np.random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)
    logger, _ = create_logger(cfg, rank=0, phase="eval")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    logger.info(f"device: {device} ({name}), torch {torch.__version__}")
    if cfg.dataset.img_num_per_gpu != 1:
        raise NotImplementedError(
            f"dataset.img_num_per_gpu={cfg.dataset.img_num_per_gpu}: the port renders one "
            "frame per batch")

    render = get("render", cfg.render.file)(cfg, device=device)
    eval_dataset = get("dataset", cfg.dataset.test.file)(cfg, is_train=False)
    eval_loader = DataLoader(eval_dataset, build_batchsampler(cfg, eval_dataset, 1, False))
    load_eval_model(cfg.render.resume_path, render)
    render.eval()
    trainer = get("trainer", cfg.train.file)(cfg, render=render, logger=logger,
                                             performance_indicator=cfg.pi)
    if cfg.test.profile and hasattr(render, "profile"):
        first = batch_to_device(next(iter(eval_loader)), device)
        prof = render.profile(first)
        logger.info("time_slots: %s", json.dumps(
            {k: round(float(v), 4) for k, v in prof["time_slots"].items()}))
        logger.info("etime: %.4f rtime: %.4f", prof["etime"], prof["rtime"])

    result_path = os.path.join(cfg.result_dir, cfg.test.test_seq)
    trainer.evaluate(eval_loader, result_path, cfg.test.is_vis)


if __name__ == "__main__":
    main()
