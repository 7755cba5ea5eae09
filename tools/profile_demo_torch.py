"""Stage profiler of the PyTorch/CUDA port's progressive renderer
(tools/profile_demo.py's surface).

    python tools/profile_demo_torch.py [ckpt.pth] [--async] [device cpu]

configs/synthetic.yaml at 512x512, `head.sigma.code_dim 32`, the demo
renderer. Loads the checkpoint (default artifacts/bench_ckpt.pth) when it
exists; otherwise it draws fresh parameters and first warms the masked
BatchNorms' running statistics with 25 train-mode volume passes, as the JAX
tool does, so that the occupancy is not empty.

Prints, with the JAX tool's lines: each prefix of the `stop_stage` ladder
(render/demo.py PROFILE_LADDER, timed by `Renderer.profile`: the op-by-op
stages, since the fused kernel has no stage boundaries inside it) with its
total and its delta from the previous prefix; the encoder's time (etime);
the end-to-end `render_demo_fn` time with the last frame's overflows.

Frames: the first 4 test items; with `--async` the 8 distinct frames of the
bench protocol (utils/bench_frames.py), and the encoder and the end-to-end
render are each timed as one loop over the 8 frames between two CUDA events,
with no synchronization per frame (the mean per frame is printed). Without
`--async` each frame is synchronized and the least time is printed.

It runs on the GPU; `device cpu` selects the CPU (host clock).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))


def warm_batchnorm(render, batch, passes=25):
    """Move the sparse stack's running statistics off their initial values:
    `passes` train-mode volume passes on `batch` (no parameter moves)."""
    import torch

    from gpnerf_tpu_torch.render.base import prepare_frame, src_norm

    with torch.no_grad():
        featmaps = render.encoder(src_norm(batch["src_imgs"]))
        pre = prepare_frame(batch, featmaps, render.max_out_sh, neg_ray=render.neg_ray_val)
        for _ in range(passes):
            render.nerfhead.volume(pre["smpl_feat"], pre["vertex_rows"], pre["grids"], train=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    use_async = "--async" in argv
    args = [a for a in argv if a != "--async"]
    opts = args[-2:] if args[-2:] == ["device", "cpu"] else []
    args = args[:len(args) - len(opts)]
    ckpt = args[0] if args else os.path.join(ROOT, "artifacts", "bench_ckpt.pth")

    import torch

    from gpnerf_tpu_torch.config import cfg as default_cfg
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render import base
    from gpnerf_tpu_torch.render.base import batch_to_device, src_norm
    from gpnerf_tpu_torch.render.demo import PROFILE_LADDER
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model
    from gpnerf_tpu_torch.utils.bench_frames import get_bench_frames
    from train_torch import select_device

    device = select_device(opts)
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
    cfg.freeze()

    render = get("render", cfg.render.file)(cfg, device=device)
    if use_async:
        frames = get_bench_frames(cfg, 8)
    else:
        np.random.seed(0)
        ds = get("dataset", cfg.dataset.test.file)(cfg, is_train=False)
        frames = [ds[i] for i in range(4)]
    dev = [batch_to_device(b, device) for b in frames]
    if os.path.exists(ckpt):
        load_eval_model(ckpt, render)
    else:
        fresh = base.build_render(cfg, device="cpu").init_variables(0)
        render.load_state_dict(fresh.state_dict())
        warm_batchnorm(render, dev[0])
    render.eval()

    prof = render.profile(dev)
    prev = 0.0
    for stage in PROFILE_LADDER:
        t = prof["totals"][stage] * 1e3
        print(f"{str(stage):12s} total {t:7.1f} ms  delta {t - prev:7.1f} ms", flush=True)
        prev = t

    run = render.render_demo_fn()
    enc = lambda b: render.encoder(src_norm(b["src_imgs"]))  # noqa: E731

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def time_loop(fn):
        """Mean ms per frame of one unsynchronized loop over the frames,
        between two CUDA events (the host clock on the CPU); the last
        output."""
        fn(dev[0])
        fn(dev[1 % len(dev)])
        sync()
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            outs = [fn(b) for b in dev]
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / len(dev), outs[-1]
        t0 = time.perf_counter()
        outs = [fn(b) for b in dev]
        return (time.perf_counter() - t0) * 1e3 / len(dev), outs[-1]

    def time_each(fn):
        """Least synchronized ms over the frames; the last output."""
        fn(dev[0])
        ts = []
        for b in dev:
            sync()
            t0 = time.perf_counter()
            out = fn(b)
            sync()
            ts.append((time.perf_counter() - t0) * 1e3)
        return min(ts), out

    timer = time_loop if use_async else time_each
    with torch.no_grad():
        t, _ = timer(enc)
        print(f"encoder (etime) {t:7.1f} ms", flush=True)
        t, ret = timer(run)
    print(f"end-to-end      {t:7.1f} ms  overflows {ret['overflows'].tolist()}", flush=True)


if __name__ == "__main__":
    main()
