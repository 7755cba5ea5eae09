"""The reference-semantics mode's point-stage cost, op by op, on the
PyTorch/CUDA port (tools/diag_ref_points.py's surface).

The stop-stage ladder (tools/roofline_torch.py) times each stage as the
difference of two whole-frame prefixes, which the host's pace moves by
several milliseconds; this tool times each point-stage op alone on the real
pipeline's own arrays:

  * the frame stage runs once per frame (`Renderer._frame_stage`), and its
    tables are the ones the ops read;
  * `Renderer._point_stages`, the entry point ahead of the fused dispatch,
    is wrapped so that the ray pipeline hands it the exact compacted point
    set the renderer would feed the point stages (`pts_c`, `dhw_c`, and
    `sig_ok` before the occupancy verdict of the query is folded in), and
    the render ends there (`capture_points`);
  * each op is timed over the distinct frames with CUDA events, warm
    first, then the best of `reps` passes, in ms per frame (`time_op`).

Ops: `octet_query` (the folded multi-scale sigma query of the `sigma_q`
stage), `octet_l1_only` (its level-1 octet trilerp), `coarse_nearest_only`
(its coarse nearest rows), `proj_quad_current` (the split projection
gather of the `cull` stage, as the op-by-op point stages call it),
`proj_rgb_only` and `proj_feat_only` (its two table samples alone), each
table sample dequantized as the point stages sample it (the JAX tool leaves
the scales out of the three samples alone, so that its uint8 level-1
trilerp computes in uint8), and
`heads_op_by_op` (mean and variance over the views, the density and the
color heads on the gathered features, in the point stages' chunks).

Prints `# P = ...` (points per frame), `# blanket occupied voxels/frame`
(`blanket_voxels`: the demand that sizes `tpu.splat_cap`), one line per op,
and `{"P": ..., "ms": {op: ms per frame}}`.

Usage:
    python tools/diag_ref_points_torch.py [n_frames] [dotted.cfg overrides ...]

configs/synthetic.yaml at 512x512, `head.sigma.code_dim 32`, the demo
renderer with REF_OVERRIDES and then the overrides, the trained checkpoint
artifacts/bench_ckpt.pth and the first n_frames (default 4) bench frames.
It runs on the GPU; `device cpu` among the overrides selects the CPU (the
host clock; small sizes and caps keep it short, e.g. `dataset.H 128
dataset.W 128 tpu.ray_cap 9216 tpu.sigma_cap 1048576 tpu.rgb_cap 262144`).
Without a card and without `device cpu` it raises.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CKPT = os.path.join(ROOT, "artifacts", "bench_ckpt.pth")
REF_OVERRIDES = [
    "tpu.tight_cull", "False",
    "tpu.samples_per_ray", "64",
    "tpu.tap_window", "0",
    "tpu.merge_lowres_src", "False",
    "tpu.ray_cap", "57344",
    "tpu.sigma_cap", "2293760",
    "tpu.rgb_cap", "1048576",
]


def ref_cfg(opts=()):
    """configs/synthetic.yaml at 512^2, code_dim 32, the demo renderer,
    REF_OVERRIDES, then the dotted overrides `opts`."""
    from gpnerf_tpu_torch.config import cfg as default_cfg

    cfg = default_cfg.clone()
    cfg.defrost()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "synthetic.yaml"))
    cfg.dataset.H = 512
    cfg.dataset.W = 512
    cfg.dataset.ratio = 1.0
    cfg.head.sigma.code_dim = 32
    cfg.render.file = "demo_render"
    cfg.merge_from_list(REF_OVERRIDES + list(opts))
    cfg.freeze()
    return cfg


class _Captured(Exception):
    """Raised by the wrapped point stages: the render ends at the tap."""


def capture_points(render, batch, featmaps):
    """One frame through the frame stage and the ray pipeline up to the
    point stages. Returns (pre, tables, points): the frame stage's per-frame
    inputs and gather tables, and {"pts_c" (P, 3), "dhw_c" (P, 3),
    "sig_ok" (P,) bool} as the ray pipeline hands them to
    `Renderer._point_stages`; the instance's wrapper is removed in every
    case."""
    import torch

    points = {}

    def tap(batch, pre, tables, pts_c, dhw_c, sig_ok, mask_from_query, stop_stage=None):
        points.update(pts_c=pts_c, dhw_c=dhw_c, sig_ok=sig_ok)
        raise _Captured

    with torch.no_grad():
        pre, tables, rd = render._frame_stage(batch, featmaps)
        render._point_stages = tap
        try:
            render._ray_pipeline(batch, pre, tables, rd)
        except _Captured:
            pass
        finally:
            del render._point_stages
    if not points:
        raise RuntimeError("the ray pipeline ended before the point stages")
    return pre, tables, points


def blanket_voxels(render, batch, featmaps):
    """Occupied voxels of the frame's sum-over-levels occupancy field
    (`masks3d > OCCUPANCY_THRESHOLD`, models/sparse_net.py
    `occupancy_volume`): the voxels the blanket splats, the demand that
    sizes `tpu.splat_cap`, counted before any `splat_cap` compaction."""
    import torch

    from gpnerf_tpu_torch.models.sparse_net import occupancy_volume
    from gpnerf_tpu_torch.render.base import prepare_frame
    from gpnerf_tpu_torch.render.demo import OCCUPANCY_THRESHOLD

    with torch.no_grad():
        pre = prepare_frame(batch, featmaps, render.max_out_sh, neg_ray=render.neg_ray_val)
        level_feats = render.nerfhead.volume(pre["smpl_feat"], pre["vertex_rows"], pre["grids"])
        m3 = occupancy_volume(level_feats, pre["grids"])
    return int((m3 > OCCUPANCY_THRESHOLD).sum())


def octet_query(render, tables, out_sh, dhw):
    """The multi-scale sigma query of the point stages (P, 64)."""
    head = render.nerfhead.sigmahead
    vols, scales = tables["octet_vols"], tables["octet_scales"]
    if tables["folded"]:
        return head.query_sigma_feat_octet_folded(*vols, dhw, out_sh, scales=scales)
    return head.query_sigma_feat_octet(vols, dhw, out_sh, scales=scales)


def octet_l1_only(table, scale, out_sh, dhw):
    """The level-1 octet table's trilinear rows alone, dequantized by
    `scale` as the sigma query samples them (P, C)."""
    from gpnerf_tpu_torch.ops.grid_sample import trilinear_octet_rows

    frac = dhw / out_sh.to(dhw.dtype)
    size = out_sh // 2
    return trilinear_octet_rows(table, frac * (size - 1).to(dhw.dtype), size, scale=scale)


def coarse_nearest_only(table, scale, out_sh, dhw):
    """The coarse NearestTable's rows alone, dequantized by `scale` (P, C)."""
    from gpnerf_tpu_torch.ops.grid_sample import NearestTable, nearest_rows

    if not isinstance(table, NearestTable):
        raise ValueError("coarse_nearest_only needs the nearest coarse table "
                         "(tpu.coarse_nearest, tpu.merge_coarse_octet)")
    frac = dhw / out_sh.to(dhw.dtype)
    size = out_sh // table.div
    if table.interleave > 1:
        size = table.interleave * (size - 1) + 1
    return nearest_rows(table, frac * (size - 1).to(dhw.dtype), size, scale=scale)


def _split_tables(tables):
    if "feat_quad" not in tables:
        raise ValueError("the projection ops need the split tables "
                         "(tpu.merge_lowres_src False, tpu.merge_src_feat False)")
    return tables


def proj_quad_current(render, pts, KE, tables, hw):
    """The split projection gather of the op-by-op point stages:
    (rgb_feat (P, V, 3 + C), view mask (P, V))."""
    from gpnerf_tpu_torch.ops.projection import project_and_gather_quad

    t = _split_tables(tables)
    return project_and_gather_quad(
        pts, KE, t["src_quad"], t["feat_quad"], *hw, neg_ray=render.neg_ray_val,
        src_scale=t["src_scale"], feat_scale=t["feat_scale"])


def _norm_pixels(render, pts, KE, hw):
    from gpnerf_tpu_torch.ops.projection import compute_projections, normalize_pixels

    pixel, _ = compute_projections(pts, KE, neg_ray=render.neg_ray_val)
    return normalize_pixels(pixel, *hw)


def proj_rgb_only(render, pts, KE, tables, hw):
    """The source-color table's sample alone (P, V, 3)."""
    from gpnerf_tpu_torch.ops.grid_sample import bilinear_quad_nhwc_pv

    t = _split_tables(tables)
    return bilinear_quad_nhwc_pv(t["src_quad"], _norm_pixels(render, pts, KE, hw), *hw,
                                 scale=t["src_scale"])


def proj_feat_only(render, pts, KE, tables, hw):
    """The feature table's sample alone, dequantized (P, V, C)."""
    from gpnerf_tpu_torch.ops.grid_sample import bilinear_quad_nhwc_pv

    t = _split_tables(tables)
    fq = t["feat_quad"]
    return bilinear_quad_nhwc_pv(fq, _norm_pixels(render, pts, KE, hw),
                                 fq.shape[1] - 1, fq.shape[2] - 1, scale=t["feat_scale"])


def heads_op_by_op(render, rgb_feat, mask, tables, out_sh, dhw, sig_ok):
    """The sigma query, mean and variance over the views, then the density
    (zero where `sig_ok` is not) and color heads over the point stages'
    chunks: (sigma (P,) float32, rgb (P, 3))."""
    import torch

    from gpnerf_tpu_torch.models.heads import fused_mean_variance
    from gpnerf_tpu_torch.render.demo import HEAD_CHUNK

    head = render.nerfhead.rgbhead
    sigma_feat = octet_query(render, tables, out_sh, dhw)
    mean, var = fused_mean_variance(rgb_feat)
    nvo = mask.sum(dim=-1, keepdim=True)
    P = rgb_feat.shape[0]
    chunks = [slice(s, min(P, s + HEAD_CHUNK)) for s in range(0, P, HEAD_CHUNK)]
    sigma = torch.cat([head.density(sigma_feat[c], mean[c, 0], var[c, 0], nvo[c])[:, 0]
                       for c in chunks])
    sigma = torch.where(sig_ok, sigma.float(), 0.0)
    rgb = torch.cat([head.color(rgb_feat[c, None], mean[c, None], var[c, None])[:, 0]
                     for c in chunks])
    return sigma, rgb


def time_op(name, fn, inputs, device, reps=2):
    """Best ms per frame of `fn(*args)` over the frames' `inputs`: one warm
    pass, then `reps` passes between CUDA events (the host clock on the
    CPU). Prints and returns it."""
    import torch

    from bench_torch import Timer

    timer = Timer(device)
    best = None
    with torch.no_grad():
        for args in inputs:
            fn(*args)
        timer.sync()
        for _ in range(reps):
            a = timer.mark()
            for args in inputs:
                fn(*args)
            dt = timer.ms(a, timer.mark()) / len(inputs)
            best = dt if best is None else min(best, dt)
    print(f"{name:34s} {best:8.2f} ms/frame", flush=True)
    return best


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    n = 4
    if argv and argv[0].isdigit():
        n, argv = int(argv[0]), argv[1:]

    import torch

    from bench_torch import card_of
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render.base import batch_to_device
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model
    from gpnerf_tpu_torch.utils.bench_frames import get_bench_frames
    from gpnerf_tpu_torch.utils.dist import select_device

    device = select_device(argv)  # the card, or `device cpu`; never a fallback
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ref_cfg(argv)
    name, smi = card_of(device)
    print(f"# device {name}" + (f" ({smi})" if smi else ""), flush=True)

    host = get_bench_frames(cfg, n)
    render = get("render", cfg.render.file)(cfg, device=device)
    load_eval_model(CKPT, render)
    render.eval()
    dev = [batch_to_device(b, device) for b in host]
    enc = render.encode_fn()
    feats = [enc(b["src_imgs"]) for b in dev]
    frames = [capture_points(render, b, f) for b, f in zip(dev, feats)]
    P = frames[0][2]["pts_c"].shape[0]
    print(f"# P = {P} compacted points/frame, {n} frames", flush=True)
    counts = [blanket_voxels(render, b, f) for b, f in zip(dev, feats)]
    print(f"# blanket occupied voxels/frame: max {max(counts)} {counts}", flush=True)

    hw = tuple(host[0]["src_imgs"].shape[1:3])
    rows = [(pre, tables, pts, torch.tensor(pre["out_sh"], device=device))
            for pre, tables, pts in frames]
    ms = {}
    ms["octet_query"] = time_op(
        "octet query (folded)", lambda t, o, d: octet_query(render, t, o, d),
        [(t, o, p["dhw_c"]) for _, t, p, o in rows], device)
    ms["octet_l1_only"] = time_op(
        "  l1 octet trilerp only", octet_l1_only,
        [(t["octet_vols"][0], t["octet_scales"][0], o, p["dhw_c"]) for _, t, p, o in rows], device)
    ms["coarse_nearest_only"] = time_op(
        "  coarse nearest rows only", coarse_nearest_only,
        [(t["octet_vols"][1], t["octet_scales"][1], o, p["dhw_c"]) for _, t, p, o in rows], device)
    proj_in = [(render, p["pts_c"], pre["KE"], t, hw) for pre, t, p, _ in rows]
    ms["proj_quad_current"] = time_op("proj gather quad (split tables)", proj_quad_current,
                                      proj_in, device)
    ms["proj_rgb_only"] = time_op("  src rgb quad only", proj_rgb_only, proj_in, device)
    ms["proj_feat_only"] = time_op("  feat quad only", proj_feat_only, proj_in, device)
    with torch.no_grad():
        gathered = [proj_quad_current(*args) for args in proj_in]
    ms["heads_op_by_op"] = time_op(
        "heads (meanvar+density+color)", heads_op_by_op,
        [(render, rf, m, t, o, p["dhw_c"], p["sig_ok"])
         for (rf, m), (_, t, p, o) in zip(gathered, rows)], device)
    print(json.dumps({"P": int(P), "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
