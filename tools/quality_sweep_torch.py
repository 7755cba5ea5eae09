"""Full-test-set quality sweep of the PyTorch/CUDA port's progressive
renderer (tools/quality_sweep.py's surface).

Renders every item of the synthetic test set at 512x512 with the trained
checkpoint `artifacts/bench_ckpt.pth` (`render.file demo_render`,
`head.sigma.code_dim 32`), on the bench frame protocol with n_frames=None
(stride 1, both RNGs seeded with the item's index, so every mode renders
the same (frame, view) list; utils/bench_frames.py caches the frames under
artifacts/frame_cache_torch/). Prints one JSON line per frame (`i`,
`psnr`, `ssim`, `overflows`, `counts`) and then the summary line (`n`,
`psnr_mean`, `ssim_mean`, `psnr_min`, `max_overflows`, `wall_s`,
`overrides`), rounded as the JAX tool rounds them.

Usage:
    python tools/quality_sweep_torch.py [dotted.cfg overrides ...]
e.g.
    python tools/quality_sweep_torch.py tpu.tap_window 32
    python tools/quality_sweep_torch.py tpu.sigma_cap 524288

It runs on the GPU; `device cpu` among the overrides selects the CPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))


def sweep(cfg, render, frames, device, overrides=(), out=sys.stdout):
    """Render each host frame of `frames` with `render` on `device`, score
    it with train/evaluator.Evaluator and print the per-frame lines and the
    summary line to `out`. Returns (rows, summary)."""
    import torch

    from gpnerf_tpu_torch.render.base import batch_to_device
    from gpnerf_tpu_torch.train.evaluator import Evaluator

    is_demo = hasattr(render, "render_demo_fn")
    fn = render.render_demo_fn() if is_demo else render.render_eval_fn()
    ev = Evaluator(cfg, "sweep")
    rows = []
    t_start = time.time()
    with torch.no_grad():
        for i, b in enumerate(frames):
            ret = fn(batch_to_device(b, device))
            ev.evaluate(ret, b)
            rows.append({
                "i": i,
                "psnr": round(float(ev.psnr[-1]), 4),
                "ssim": round(float(ev.ssim[-1]), 5),
                "overflows": (ret["overflows"].tolist() if "overflows" in ret else [0] * 4),
                "counts": ret["counts"].tolist() if "counts" in ret else [0] * 3,
            })
            print(json.dumps(rows[-1]), file=out, flush=True)
    summary = {
        "n": len(rows),
        "psnr_mean": round(float(np.mean(ev.psnr)), 4),
        "ssim_mean": round(float(np.mean(ev.ssim)), 5),
        "psnr_min": round(float(np.min(ev.psnr)), 4),
        "max_overflows": np.max([r["overflows"] for r in rows], axis=0).tolist(),
        "wall_s": round(time.time() - t_start, 1),
        "overrides": list(overrides),
    }
    print(json.dumps(summary), file=out, flush=True)
    return rows, summary


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    import torch

    from gpnerf_tpu_torch.config import cfg as default_cfg
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model
    from gpnerf_tpu_torch.utils.bench_frames import get_bench_frames
    from train_torch import select_device

    device = select_device(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = default_cfg.clone()
    cfg.defrost()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "synthetic.yaml"))
    cfg.dataset.H = 512
    cfg.dataset.W = 512
    cfg.dataset.ratio = 1.0
    cfg.head.sigma.code_dim = 32
    cfg.render.file = "demo_render"
    if argv:
        cfg.merge_from_list(argv)
    cfg.freeze()
    frames = get_bench_frames(cfg, n_frames=None)
    render = get("render", cfg.render.file)(cfg, device=device)
    load_eval_model(os.path.join(ROOT, "artifacts", "bench_ckpt.pth"), render)
    render.eval()
    sweep(cfg, render, frames, device, overrides=argv)


if __name__ == "__main__":
    main()
