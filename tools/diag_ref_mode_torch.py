"""Per-pixel diagnosis of the reference-semantics mode's quality against the
tight cull on the PyTorch/CUDA port (tools/diag_ref_mode.py's surface).

Renders the same bench frames (utils/bench_frames.py) through two
configurations of configs/synthetic.yaml at 512x512, `head.sigma.code_dim
32`, `samples_per_ray 64` and `sigma_cap 2621440`, with the trained
checkpoint artifacts/bench_ckpt.pth, through `Renderer.render_demo_fn`:
  (a) the tight cull at K = 64, drop-free;
  (b) the reference semantics (masks3d sum-over-levels blanket, all rays,
      all samples: `tight_cull False`, `tap_window 0`, `merge_lowres_src
      False`, `ray_cap 65536`, `rgb_cap 1048576`).
Each frame's squared error over the evaluator's `mask_at_box` pixels is
split into the pixels covered by
  * both modes (`both`: the same rays, different sample culls),
  * only the reference blanket (`ref_only`: the fringe rays its loose splat
    admits, which the tight mode leaves background),
  * only the tight cull (`tight_only`);
the pixels neither mode covers are background in both images.

If the gap lives in `ref_only`, the reproduction is faithful and the
reference's own blanket costs the dB (faint fog over near-background pixels
that the ground truth masks to 0); if it lives in `both`, the sample-cull
semantics deviate.

Prints one JSON line per frame (`frame`, and for each band `px`,
`mse_tight`, `mse_ref`, `sse_tight`, `sse_ref`), then `{"total": {band:
{"px", "sse_tight", "sse_ref"}}}` with the sums rounded to 3 decimals: the
JAX tool's keys and rounding. The kernel wrappers' launch counts go to
stderr (`# kernel launches {...}`).

Usage:
    python tools/diag_ref_mode_torch.py [n_frames] [dotted.cfg overrides ...]

n_frames defaults to 4; the overrides apply to both modes. It runs on the
GPU; `device cpu` among the overrides selects the CPU, where small sizes
and caps keep it short, e.g. `dataset.H 128 dataset.W 128 tpu.ray_cap 9216
tpu.sigma_cap 1048576 tpu.rgb_cap 262144`. Without a card and without
`device cpu` it raises.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CKPT = os.path.join(ROOT, "artifacts", "bench_ckpt.pth")
# the reference semantics' overrides, on top of the shared configuration
REF_CAPS = {"ray_cap": 65536, "rgb_cap": 1048576}
BANDS = ("both", "ref_only", "tight_only")


def mode_cfg(ref, size=512, opts=(), **caps):
    """The port's configuration of mode (a) (`ref` False) or (b) at
    size x size; `caps` (tpu keys, e.g. ray_cap) replace the tool's caps
    in either mode, then the dotted overrides `opts` apply."""
    from gpnerf_tpu_torch.config import cfg as default_cfg

    cfg = default_cfg.clone()
    cfg.defrost()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "synthetic.yaml"))
    cfg.dataset.H = size
    cfg.dataset.W = size
    cfg.dataset.ratio = 1.0
    cfg.head.sigma.code_dim = 32
    cfg.render.file = "demo_render"
    cfg.tpu.samples_per_ray = 64
    cfg.tpu.sigma_cap = 2621440
    if ref:
        cfg.tpu.tight_cull = False
        cfg.tpu.tap_window = 0
        cfg.tpu.merge_lowres_src = False
        for k, v in REF_CAPS.items():
            cfg.tpu[k] = v
    for k, v in caps.items():
        cfg.tpu[k] = v
    if opts:
        cfg.merge_from_list(list(opts))
    cfg.freeze()
    return cfg


def render_outs(cfg, host, device):
    """(image (H, W, 3), covered pixels (H, W)) of each host frame rendered
    by `cfg`'s renderer with the trained checkpoint."""
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render.base import batch_to_device
    from gpnerf_tpu_torch.render.demo import pred_img_hwc
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model

    render = get("render", cfg.render.file)(cfg, device=device)
    load_eval_model(CKPT, render)
    render.eval()
    fn = render.render_demo_fn()
    outs = []
    for b in host:
        ret = fn(batch_to_device(b, device))
        img = pred_img_hwc(ret)
        outs.append((img, ret["mask_at_box"].cpu().numpy().reshape(img.shape[:2])))
    return outs


def decompose(host, tight_outs, ref_outs):
    """The per-frame band lines and the total line (diag_ref_mode.py:93-130)
    of the two modes' (image, covered pixels) pairs against the host
    frames' ground truth."""
    lines = []
    agg = {k: [] for k in BANDS}
    for i, b in enumerate(host):
        ti, tm = tight_outs[i]
        ri, rm = ref_outs[i]
        gt = np.asarray(b["tar_img"], np.float32)
        if gt.max() > 1.5:
            gt = gt / 255.0
        mab = np.asarray(b["mask_at_box"]).reshape(tm.shape)
        gt = gt * mab[..., None]  # the evaluator masks the background
        tm = tm & mab
        rm = rm & mab
        bands = {"both": tm & rm, "ref_only": rm & ~tm, "tight_only": tm & ~rm}
        err_t = ((ti - gt) ** 2).sum(-1)
        err_r = ((ri - gt) ** 2).sum(-1)
        line = {"frame": i}
        for k, m in bands.items():
            n = int(m.sum())
            line[k] = {
                "px": n,
                "mse_tight": float(err_t[m].mean()) if n else 0.0,
                "mse_ref": float(err_r[m].mean()) if n else 0.0,
                # the total squared error the band contributes per mode
                "sse_tight": float(err_t[m].sum()),
                "sse_ref": float(err_r[m].sum()),
            }
            agg[k].append((line[k]["sse_tight"], line[k]["sse_ref"], n))
        lines.append(line)
    lines.append({"total": {
        k: {
            "px": int(sum(n for _, _, n in v)),
            "sse_tight": round(sum(a for a, _, _ in v), 3),
            "sse_ref": round(sum(r for _, r, _ in v), 3),
        }
        for k, v in agg.items()
    }})
    return lines


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    n_frames = 4
    if argv and argv[0].isdigit():
        n_frames, argv = int(argv[0]), argv[1:]

    import torch

    from bench_torch import launch_counts
    from gpnerf_tpu_torch.utils.bench_frames import get_bench_frames
    from gpnerf_tpu_torch.utils.dist import select_device

    device = select_device(argv)  # the card, or `device cpu`; never a fallback
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg_t = mode_cfg(False, opts=argv)
    cfg_r = mode_cfg(True, opts=argv)
    host = get_bench_frames(cfg_t, n_frames)
    tight_outs = render_outs(cfg_t, host, device)
    ref_outs = render_outs(cfg_r, host, device)
    for line in decompose(host, tight_outs, ref_outs):
        print(json.dumps(line), flush=True)
    print(f"# kernel launches {json.dumps(launch_counts())}", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
