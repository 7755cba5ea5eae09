"""Bandwidth roofline of the PyTorch/CUDA port's progressive renderer
(tools/roofline.py's surface).

    python tools/roofline_torch.py [--json out.json] [dotted.cfg overrides ...]

configs/synthetic.yaml at 512x512, `head.sigma.code_dim 32`, the demo
renderer, the trained checkpoint artifacts/bench_ckpt.pth (the port's
`load_eval_model`) and the first 8 frames of the bench protocol
(utils/bench_frames.py); dotted overrides follow. For every prefix of the
stop-stage ladder (render/demo.py STOP_STAGES, op by op) and the whole
render, then for the configured fused program, it prints the stage's time,
its bytes and FLOPs (utils/roofline.py `counting`: the eager ops' operands
and results, each hand-written kernel by its declared cost), the achieved
GB/s and TFLOP/s of its delta and that rate's share of the card's HBM peak
(utils/roofline.py `ladder`; no rate where the delta lies within the
spread of its two timings, `noise`). The JSON also carries the device, the
card's name and power limit as nvidia-smi gives them, `peak_GBps` and
`peak_TFLOPs` for `tpu.matmul_dtype`.

It runs on the GPU; `device cpu` among the overrides selects the CPU, where
the counts hold and the rates and shares are None (a CPU time says nothing
of the card). Without a card and without `device cpu` it raises.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _fmt(v, width, spec):
    return f"{'None' if v is None else format(v, spec):>{width}s}"


def main(argv=None, n_frames=8):
    argv = sys.argv[1:] if argv is None else list(argv)
    json_out = None
    if "--json" in argv:
        i = argv.index("--json")
        json_out = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]

    import torch

    from bench_torch import bench_cfg, card_of
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render.base import batch_to_device
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model
    from gpnerf_tpu_torch.utils import roofline
    from gpnerf_tpu_torch.utils.bench_frames import get_bench_frames
    from gpnerf_tpu_torch.utils.dist import select_device

    device = select_device(argv)  # the card, or `device cpu`; never a fallback
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = bench_cfg(argv)
    name, smi = card_of(device)

    host = get_bench_frames(cfg, n_frames)
    frames = [batch_to_device(b, device) for b in host]
    render = get("render", cfg.render.file)(cfg, device=device)
    load_eval_model(os.path.join(ROOT, "artifacts", "bench_ckpt.pth"), render)
    render.eval()
    enc = render.encode_fn()
    feats = [enc(b["src_imgs"]) for b in frames]

    out = roofline.ladder(render, frames, feats)
    for r in out["ladder"]:
        print(f"{r['stage']:12s} {r['total_ms']:8.2f} ms  d {r['delta_ms']:7.2f} ms"
              f" (noise {_fmt(r['noise_ms'], 5, '.2f')})"
              f"  {r['delta_GB']:7.3f} GB  {_fmt(r['achieved_GBps'], 7, '.1f')} GB/s"
              f"  {_fmt(r['pct_bw_roof'], 6, '.1f')}% bw-roof"
              f"  {r['delta_GFLOP']:8.1f} GF {_fmt(r['achieved_TFLOPs'], 6, '.2f')} TF/s",
              flush=True)
    p = out["production"]
    print(f"production   {p['total_ms']:8.2f} ms  {p['total_GB']:7.3f} GB"
          f"  {_fmt(p['achieved_GBps'], 7, '.1f')} GB/s  {_fmt(p['pct_bw_roof'], 6, '.1f')}%"
          f" bw-roof  {p['total_GFLOP']:8.1f} GF  ({p['stage']}; kernels {p['kernels']} "
          f"declared {p['kernel_GB']:.3f} GB; host<->card {p['transfer_GB']:.4f} GB)", flush=True)
    peak_bw = roofline.peak_bytes_per_s(name)
    peak_fl = roofline.peak_flop_per_s(name, cfg.tpu.matmul_dtype)
    if peak_bw is None:
        why = "on the CPU" if device.type == "cpu" else f"no published peak for {name!r}"
        print(f"# shares of the roof left out: {why} (utils/roofline.py HBM_BYTES_PER_S)",
              file=sys.stderr)
    result = {
        "device": name,
        "nvidia_smi": smi,
        "peak_GBps": None if peak_bw is None else peak_bw / 1e9,
        "peak_TFLOPs": None if peak_fl is None else peak_fl / 1e12,
        "matmul_dtype": cfg.tpu.matmul_dtype,
        "frames": n_frames,
        **out,
        "overrides": argv,
    }
    if json_out:
        with open(json_out, "w") as f:
            json.dump(result, f, indent=1)
        print(f"# wrote {json_out}", flush=True)
    return result


if __name__ == "__main__":
    main()
