"""Training-step benchmark of the PyTorch/CUDA port: the step time and a
short loss curve for a given `tpu.train_dtype` (tools/train_bench.py's
surface and JSON line).

    python tools/train_bench_torch.py [--iters N] [cfg overrides...]

configs/synthetic.yaml at head.sigma.code_dim 32 unless overridden, the
BaseRender train step (train/step.py) from seeded parameters, AdamW, over
8 train batches cycled. One untimed warm-up step, then `--iters` steps
timed with CUDA events around the loop. Run it once with `tpu.train_dtype
float32` and once with `bfloat16` to compare them. Runs on the GPU; only
`device cpu` on the command line selects the CPU (timed by the host clock
there), and without a CUDA device and without it the script raises.

Prints one JSON line: {"dtype", "device" (the card's name), "power_limit_w",
"iters", "s_per_it", "first_loss", "last10_mean_loss", "losses": [...]}.
TF32 is off for matmuls and cuDNN convolutions.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from gpnerf_tpu_torch.config import cfg as default_cfg  # noqa: E402
from train_torch import select_device  # noqa: E402


def power_limit_w():
    """The card's power limit in watts as nvidia-smi reports it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30).stdout
        return float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cfg = default_cfg.clone()
    cfg.defrost()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "synthetic.yaml"))
    cfg.head.sigma.code_dim = 32
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    device = select_device(args.opts)

    import torch

    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render.base import batch_to_device
    from gpnerf_tpu_torch.train.step import make_optimizer, train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    np.random.seed(0)
    random.seed(0)
    torch.manual_seed(0)
    ds = get("dataset", cfg.dataset.train.file)(cfg, is_train=True)
    render = get("render", "BaseRender")(cfg, device=device).init_variables(0)
    criterion = get("criterion", cfg.train.criterion_file)(cfg)
    opt, sched, _ = make_optimizer(render, cfg)
    batches = [batch_to_device(ds[i % len(ds)], device) for i in range(8)]
    gen = torch.Generator(device=device).manual_seed(cfg.seed)

    def step(b):
        return train_step(render, criterion, opt, sched, b, generator=gen)[0]["loss"]

    step(batches[0])  # warm-up, untimed
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    losses = [step(batches[i % len(batches)]) for i in range(args.iters)]
    if cuda:
        end.record()
        torch.cuda.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        seconds = time.perf_counter() - t0
    losses = torch.stack(losses).tolist()
    out = {
        "dtype": cfg.tpu.train_dtype,
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "power_limit_w": power_limit_w() if cuda else None,
        "iters": args.iters,
        "s_per_it": round(seconds / args.iters, 4),
        "first_loss": round(losses[0], 5),
        "last10_mean_loss": round(float(np.mean(losses[-10:])), 5),
        "losses": [round(x, 5) for x in losses],
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
