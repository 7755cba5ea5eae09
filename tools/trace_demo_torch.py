"""Device time per kernel of the PyTorch/CUDA port's fused progressive render
(tools/trace_demo.py's surface).

Renders the first 8 bench frames (utils/bench_frames.py) through
`render_demo_fn`, the fused fast path as configured, twice warm and then
once under `torch.profiler` (utils/profiling.py `trace`, which writes the
Chrome trace into results/trace_demo_torch/), and prints the device time
aggregated by kernel name (utils/profiling.py `kernel_table`), largest
first: for each of the top n_top kernels its ms per frame, its launches per
frame, its total ms over the frames and its name; then the device-busy
total per frame and the share the top rows cover, and the next 20 rows.

Usage:
    python tools/trace_demo_torch.py [ckpt.pth] [n_top] [dotted.cfg overrides ...]

configs/synthetic.yaml at 512x512, `head.sigma.code_dim 32`, the demo
renderer, then the overrides; the checkpoint defaults to
artifacts/bench_ckpt.pth, n_top to 40. It runs on the GPU; `device cpu`
among the overrides selects the CPU, where the table holds each op's self
CPU time instead. Without a card and without `device cpu` it raises.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TRACE_DIR = os.path.join(ROOT, "results", "trace_demo_torch")


def capture(render, frames, device, trace_dir=TRACE_DIR):
    """Render `frames` (device batches) twice warm, then once under the
    profiler, which writes its trace into `trace_dir`; returns
    `kernel_table` of the profiled pass."""
    from gpnerf_tpu_torch.render.demo import synchronize
    from gpnerf_tpu_torch.utils.profiling import kernel_table, trace

    run = render.render_demo_fn()
    run(frames[0])
    run(frames[1 % len(frames)])
    synchronize(device)
    with trace(trace_dir) as prof:
        for b in frames:
            run(b)
        synchronize(device)
    return kernel_table(prof, device.type)


def report(rows, n_frames, n_top=40, out=sys.stdout):
    """Print the top `n_top` rows of `kernel_table` per frame, the busy
    total and the next 20 rows."""
    def line(name, ms, count):
        print(f"{ms / n_frames:9.4f} ms/frame  x{count / n_frames:<7.1f} {ms:10.3f} ms total"
              f"  {name[:110]}", file=out)

    grand = sum(ms for _, ms, _ in rows)
    top, tail = rows[:n_top], rows[n_top:]
    for r in top:
        line(*r)
    acc = sum(ms for _, ms, _ in top)
    print(f"   busy {grand / n_frames:.3f} ms/frame over {n_frames} frames; top-{n_top} covers "
          f"{acc / max(grand, 1e-9) * 100:.0f}%; tail {len(tail)} kernels "
          f"x{sum(c for *_, c in tail) / n_frames:.1f} launches = "
          f"{sum(ms for _, ms, _ in tail) / n_frames:.3f} ms/frame", file=out)
    print("   -- tail top 20 --", file=out)
    for r in tail[:20]:
        line(*r)
    out.flush()


def main(argv=None, n_frames=8):
    argv = sys.argv[1:] if argv is None else list(argv)
    ckpt = argv[0] if argv else os.path.join(ROOT, "artifacts", "bench_ckpt.pth")
    n_top = int(argv[1]) if len(argv) > 1 else 40
    opts = argv[2:]

    import torch

    from bench_torch import bench_cfg, card_of, launch_counts
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render.base import batch_to_device
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model
    from gpnerf_tpu_torch.utils.bench_frames import get_bench_frames
    from gpnerf_tpu_torch.utils.dist import select_device

    device = select_device(opts)  # the card, or `device cpu`; never a fallback
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = bench_cfg(opts)
    name, smi = card_of(device)
    render = get("render", cfg.render.file)(cfg, device=device)
    load_eval_model(ckpt, render)
    render.eval()
    frames = [batch_to_device(b, device) for b in get_bench_frames(cfg, n_frames)]
    rows = capture(render, frames, device)
    print(f"== device: {name}" + (f" ({smi})" if smi else "")
          + f" (per-frame ms over {len(frames)} frames; trace in {TRACE_DIR})", flush=True)
    report(rows, len(frames), n_top)
    print(f"# kernel launches {json.dumps(launch_counts())}", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
