#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gpnerf_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py              # the smoke test
    python3 chip_smoke.py --profile    # plus a torch.profiler kernel table

Phases, each fatal on failure:
  1. device and power limit; build every CUDA kernel from
     gpnerf_tpu_torch/csrc/: the six instantiations of the point-stage
     kernel, the quad-lerp kernels and the row gather (one nvcc each, all
     started together);
  2. each kernel against its plain PyTorch version on the card: seeded
     random inputs (the quad lerps at a ragged P for int8 and float32 rows
     and the row gather at the microbenchmark's shape, bitwise), then the
     inputs captured from one rendered frame at the main-path shape (the
     point-stage plain version runs in chunks of points);
  3. end to end at 512^2 (configs/synthetic.yaml, trained checkpoint)
     through `render_demo_fn`, with launch counts, zero-overflow and PSNR
     checks: 3 frames of the bench protocol in the fast mode, 2 in the
     reference-semantics mode (blanket cull, K = 64, ray_cap 57344, split
     tables), and one frame each of that mode's variants (frame_mode,
     sigma_query_cull, int4_feat, kernel_octet off) and of the fast mode
     with kernel_octet off; the frame_mode image must equal the
     sigma_query_cull image. Plus, for the fast and the reference mode, a
     128^2 frame rendered on the card and on the CPU (plain versions) that
     must agree;
  3b. the op-by-op point stages (pallas_point off): 3 frames of the fast
     mode through the quad-lerp kernel (exactly one launch per frame, no
     point-stage launch), held against the fused fast mode's image; the
     kernel on the frame's captured rows against plain and against its flat
     channel-major twin, bitwise; one frame each of the torch-op routes
     (pallas_lerp off, proj_vp_order) and of the op-by-op reference mode;
     `Renderer.profile`; the gather microbenchmark
     (gpnerf_tpu_torch/utils/bench_gather.py) through the row-gather kernel;
     a 128^2 op-by-op frame on the card against the CPU;
  4. CUDA-event timings of the whole render, of its stage prefixes
     (encoder; + frame stage; + ray pipeline and image) and of each kernel
     instantiation beside its bound;
  3c. THuman's neg-ray convention on 3 bench frames of the
     `thuman-synthetic` fixture (the scene through OpenGL-style cameras,
     negative ray t-spans): the fast mode on 3 frames and the reference mode
     on 1, with the checks, captured-input kernel comparisons and timings of
     phase 3, and the op-by-op fast mode on 1 frame (one quad-lerp launch,
     bitwise against plain, its image against the fused neg frame's);
  5. the training path at full width (render/base.py BaseRender,
     train/step.py, train/trainer.py): from the trained checkpoint, 3
     warm-up and 20 timed AdamW steps (1024 rays x 64 samples, float32) on
     distinct batches, s/it from CUDA events, peak device memory, the first
     and last loss; every loss finite, no pyramid overflow, parameters and
     running statistics moved; the eval render of one test frame (PSNR >=
     20 dB) and `Trainer.evaluate` of it through the progressive renderer,
     which launches the point-stage kernel (form (a)); `--profile` adds
     the train step's kernel table and idle share; then the same under
     neg-ray on the `thuman-synthetic` splits (3 warm-up and 5 timed
     steps, the eval render's PSNR);
  6. the inference CLI (tools/inference_torch.py) in a process of its own
     on configs/synthetic.yaml with the trained checkpoint: exit 0 and PSNR
     >= 20 dB;
  7. one JSON line listing the kernels, the card's name and power limit,
     and the final JSON status line.

TF32 is off for matmuls and cuDNN convolutions throughout, so float32
products are float32 on both devices.
Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import math
import os
import random
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "artifacts", "bench_ckpt.pth")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores


def log(*a):
    print(*a, flush=True)


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


NEG = "thuman-synthetic"  # the synthetic scene through OpenGL-style cameras


def make_cfg(size, matmul_dtype, neg=False):
    """configs/synthetic.yaml at size^2 with the trained checkpoint's
    code_dim; `neg` serves the scene in THuman's neg-ray convention."""
    from gpnerf_tpu_torch.config import cfg as base

    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "synthetic.yaml"))
    cfg.dataset.H = size
    cfg.dataset.W = size
    cfg.dataset.ratio = 1.0
    cfg.head.sigma.code_dim = 32
    cfg.render.file = "demo_render"
    cfg.tpu.matmul_dtype = matmul_dtype
    if neg:
        cfg.dataset.train.name = NEG
        cfg.dataset.test.name = NEG
    cfg.freeze()
    return cfg


def cuda_ms(fn, reps, with_host=False):
    """Mean milliseconds of `fn()` over `reps` calls between CUDA events,
    after one warm call; with_host also returns the mean host time to
    enqueue a call (when it matches the event time, the host bounds)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    torch.cuda.synchronize()
    dev_ms = start.elapsed_time(end) / reps
    return (dev_ms, host_ms) if with_host else dev_ms


def compare_point_stages(kern, plain, what):
    """Hold the kernel's (alpha, rgb[, occm]) against the plain version's
    with the tolerances of tests/test_pallas_point.py:83-103; the occupancy
    verdict must agree exactly. Returns stats."""
    import torch

    a, rgb = kern[:2]
    a_ref, rgb_ref = plain[:2]
    check(len(kern) == len(plain), f"{what}: output count")
    check(torch.isfinite(a).all() and torch.isfinite(rgb).all(), f"{what}: non-finite")
    da = (a - a_ref).abs()
    check(bool((da <= 0.08 + 0.3 * a_ref.abs()).all()), f"{what}: alpha beyond atol 0.08 rtol 0.3")
    check(float(da.mean()) < 5e-3, f"{what}: mean |d alpha| {float(da.mean())}")
    alive, alive_ref = a > 1e-14, a_ref > 1e-14
    agree = alive == alive_ref
    flips = int((~agree).sum())
    check(flips < 0.01 * a.numel(), f"{what}: {flips} alive-boundary flips")
    dr = (rgb - rgb_ref).abs()[agree]
    check(bool((dr <= 0.08).all()), f"{what}: rgb beyond atol 0.08")
    check(float(dr.mean()) < 5e-3, f"{what}: mean |d rgb| {float(dr.mean())}")
    check(bool(alive[a_ref > 0.05].all() and alive_ref[a > 0.05].all()),
          f"{what}: decisively-alive points disagree")
    stats = {
        "max_abs_d_alpha": float(da.max()), "mean_abs_d_alpha": float(da.mean()),
        "max_abs_d_rgb": float(dr.max()), "mean_abs_d_rgb": float(dr.mean()),
        "alive_flips": flips, "points": a.numel(),
    }
    if len(kern) == 3:
        check(bool((kern[2] == plain[2]).all()), f"{what}: occupancy verdicts differ")
        stats["occ_pass_share"] = float(kern[2].mean())
    log(f"# {what}: " + json.dumps(stats))
    return stats


def random_point_inputs(form, P, device, seed=0):
    """Seeded random inputs of one instantiation (a key of
    gpnerf_tpu_torch.ops.point_stages.FORMS) at P points, made on the
    device. Returns (tabs, feats, vmask, sig_ok, kwargs)."""
    import torch

    from gpnerf_tpu_torch.ops.point_stages import C, C0, C1, CF, CS, V

    proj, use_feats, occ = form
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*s):
        return torch.rand(*s, generator=g, device=device)

    def ints(lo, hi, *s, dtype):
        return torch.randint(lo, hi, s, generator=g, device=device, dtype=dtype)

    def w4():
        return rand(V, 4, P) * (rand(V, 4, P) > 0.1)

    if proj == "merged_i8":
        tabs = ((ints(-127, 128, V * P, 4 * C, dtype=torch.int8), w4(), 0.02 + rand(C) * 0.05),)
    else:
        feat_rows = (ints(0, 256, V * P, 2 * CF, dtype=torch.uint8) if proj == "split_i4"
                     else ints(-127, 128, V * P, 4 * CF, dtype=torch.int8))
        tabs = (
            (ints(0, 256, V * P, 4 * CS, dtype=torch.uint8), w4(),
             torch.full((CS,), 1.0 / 255.0, device=device)),
            (feat_rows, w4(), 0.02 + rand(CF) * 0.05),
        )
    kw, feats = {}, None
    if use_feats:
        feats = torch.randn(P, C0 + C1, generator=g, device=device) * 0.5
    else:
        gw0 = rand(8, P)
        g0 = ints(0, 256, P, 8 * C0, dtype=torch.uint8)
        if occ:  # empty level-1 cells, so the occupancy cull bites
            g0 = g0 * (rand(P, 1) > 0.4).to(torch.uint8)
        kw["geom_tabs"] = (
            (g0, gw0 / gw0.sum(0), 0.01 + rand(C0) * 0.03),
            (ints(-127, 128, P, C1, dtype=torch.int8), (rand(1, P) > 0.05).float(),
             0.01 + rand(C1) * 0.03),
        )
        if occ:
            kw["occ_geom"] = True
    vmask = (rand(V, P) > 0.15).float()
    sig_ok = (rand(P) > 0.2).to(torch.uint8)
    return tabs, feats, vmask, sig_ok, kw


def plain_in_chunks(call, chunk=262144):
    """`point_stages_tabs_plain` on the inputs of one wrapper call, run over
    chunks of points (it materialises (V, P, 4, C) floats: several GB at the
    reference-mode shape) and concatenated."""
    import torch

    from gpnerf_tpu_torch.ops.point_stages import point_stages_tabs_plain

    tabs, feats, vmask, sig_ok, weights, kw = call
    nv, P = vmask.shape
    outs = []
    for s in range(0, P, chunk):
        e = min(P, s + chunk)
        t = tuple((r.reshape(nv, P, -1)[:, s:e].reshape(nv * (e - s), -1), w[:, :, s:e], sc)
                  for r, w, sc in tabs)
        k = dict(kw)
        if "geom_tabs" in kw:
            k["geom_tabs"] = tuple((r[s:e], w[:, s:e], sc) for r, w, sc in kw["geom_tabs"])
        outs.append(point_stages_tabs_plain(
            t, None if feats is None else feats[s:e], vmask[:, s:e], sig_ok[s:e], weights, **k))
    return tuple(torch.cat(o) for o in zip(*outs))


def point_stage_cost(call, outs):
    """(bytes, bound ms, bound_by) of one point-stage call: each input read
    once and each output written once, over HBM; MLP multiply-adds at the
    bf16 tensor-core rate plus the f32 lerps, whichever bound is larger."""
    import torch

    tabs, feats, vmask, sig_ok, weights, kw = call
    geom = kw.get("geom_tabs", ())
    tensors = [vmask, sig_ok.to(torch.uint8), weights.flat, *outs]
    for t in (*tabs, *geom):
        tensors += list(t)
    if feats is not None:
        tensors.append(feats)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    V, P = vmask.shape
    Cp = sum(t[2].shape[0] for t in tabs)
    macs = sum(w.shape[0] * w.shape[1] for w, _ in weights.layers)
    macs += (V - 1) * sum(w.shape[0] * w.shape[1] for w, _ in weights.layers[5:9])  # per-view MLPs
    lerp = sum(V * t[2].shape[0] * 2 * t[1].shape[1] for t in tabs) + 4 * V * Cp
    lerp += sum(g[0].shape[1] * 2 + g[2].shape[0] for g in geom)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = P * (2 * macs / BF16_FLOP_PER_S + lerp / F32_FLOP_PER_S)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    return nbytes, max(t_bytes, t_ops) * 1e3, bound_by


def same_bits(a, b):
    """Bitwise equality of two tensors of one float dtype."""
    import torch

    bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        torch.equal(a.contiguous().view(bits), b.contiguous().view(bits)))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def lerp_cost(rows, w4, scale, out):
    """(bytes, bound ms, bound_by) of one quad lerp: inputs read and output
    written once over HBM; 9 float32 operations per output value."""
    nb = nbytes(rows, w4, scale, out)
    t_bytes, t_ops = nb / HBM_BYTES_PER_S, 9 * out.numel() / F32_FLOP_PER_S
    return nb, max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def psnr_of(ret, host_batch):
    """PSNR over the mask_at_box pixels (train/evaluator.py semantics)."""
    import numpy as np

    pred = ret["pred_chw"].permute(1, 2, 0).float().cpu().numpy()
    H, W = pred.shape[:2]
    n = int(host_batch["n_rays"])
    mask = np.asarray(host_batch["mask_at_box"]).reshape(H, W)
    rgb_pred = pred[mask][:n]
    rgb_gt = np.asarray(host_batch["rgb"])[:n]
    return float(-10.0 * math.log10(float(np.mean((rgb_pred - rgb_gt) ** 2))))


def profile_render(fn, batches, card, frame_ms):
    """torch.profiler over one pass of the frames: device time by kernel
    (device-side events only) and the device's idle share against the
    unprofiled frame time, printed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches:
            fn(b)
        torch.cuda.synchronize()
    n = len(batches)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in events) / 1e3 / n
    lines = [f"# profile on {card}: kernels busy {busy:.3f} ms per frame of "
             f"{frame_ms:.3f} ms, idle share {1.0 - busy / frame_ms:.3f}; "
             f"{sum(e.count for e in events) / n:.0f} kernel launches per frame; "
             "by kernel (ms per frame, launches per frame):"]
    # host-device synchronizations inside one frame (each drains the queue)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn(batches[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    lines.insert(1, f"# profile: {syncs} synchronizing calls per frame "
                    "(torch.cuda.set_sync_debug_mode)")
    for e in events:
        lines.append(f"#   {e.self_device_time_total / 1e3 / n:9.4f} ms "
                     f"{e.count / n:6.1f}x  {e.key[:110]}")
    for line in lines[:41]:
        log(line)


REF_MODE = {
    # the reference-semantics mode of the repository's benchmark: blanket
    # cull, all 64 samples, no tap window, split tables, caps sized drop-free
    "tight_cull": False, "samples_per_ray": 64, "tap_window": 0,
    "merge_lowres_src": False, "ray_cap": 57344, "sigma_cap": 2293760,
    "rgb_cap": 1048576,
}


def make_render(size, matmul_dtype, device, neg=False, **tpu):
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model

    cfg = make_cfg(size, matmul_dtype, neg)
    cfg.defrost()
    for k, v in tpu.items():
        cfg.tpu[k] = v
    cfg.freeze()
    render = get("render", cfg.render.file)(cfg, device=device)
    load_eval_model(CKPT, render)
    return cfg, render


def card_vs_cpu_128(name, max_tol, **tpu):
    """The same 128^2 frame on the card and on the CPU (plain versions),
    float32 config: masks, counts and images must agree (|d| median < 2e-3,
    at most 0.1% of the values beyond 0.05, none beyond max_tol)."""
    import numpy as np
    import torch

    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render.base import batch_to_device

    outs = {}
    for d in ("cuda", "cpu"):
        cfg_s, r = make_render(128, "float32", d, **tpu)
        if d == "cuda":
            np.random.seed(0)
            random.seed(0)
            small = get("dataset", cfg_s.dataset.test.file)(cfg_s, is_train=False)[0]
        o = r.render_demo_fn()(batch_to_device(small, d))
        outs[d] = {k: v.cpu() for k, v in o.items()}
    g, c = outs["cuda"], outs["cpu"]
    same_mask = float((g["mask_at_box"] == c["mask_at_box"]).float().mean())
    m = g["mask_at_box"] & c["mask_at_box"]
    d_img = (g["pred_chw"].reshape(3, -1)[:, m] - c["pred_chw"].reshape(3, -1)[:, m]).abs()
    log(f"# 128^2 {name} card vs CPU: mask agreement {same_mask:.6f}, counts {g['counts'].tolist()} vs "
        f"{c['counts'].tolist()}, overflows {g['overflows'].tolist()}, |d pred| median "
        f"{float(d_img.median()):.2e} max {float(d_img.max()):.2e}")
    check(same_mask > 0.999, f"128^2 {name} card vs CPU: ray masks differ")
    check(int(g["overflows"][0]) == 0, f"128^2 {name}: ray overflow")
    n_s, n_c = int(g["counts"][1]), int(c["counts"][1])
    check(abs(n_s - n_c) <= 0.001 * n_c, f"128^2 {name} card vs CPU: sample counts differ")
    check(float(d_img.median()) < 2e-3 and float((d_img > 0.05).float().mean()) <= 1e-3
          and float(d_img.max()) < max_tol, f"128^2 {name} card vs CPU: images differ")


def train_phase(card, profile, neg=False):
    """Phase 5: the training path at full width (configs/synthetic.yaml:
    512^2, ResNet34-UNet, code_dim 32, 1024 rays x 64 samples, float32)
    from the trained checkpoint: warm-up steps, then timed steps on distinct
    batches through `train.step.train_step`; the whole-image eval render of
    one test frame; `Trainer.evaluate` of that frame through the progressive
    renderer (kernel 1, form (a)). Returns the point-stage launches of that
    evaluation (counts set to 0 just before the path). With `neg`, the
    same on the `thuman-synthetic` splits (THuman's neg-ray convention in
    the train and the eval render), 5 timed steps, no `Trainer.evaluate`;
    returns 0."""
    import numpy as np
    import torch

    from gpnerf_tpu_torch.data.loader import DataLoader
    from gpnerf_tpu_torch.ops import point_stages as ps
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render.base import batch_to_device
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model
    from gpnerf_tpu_torch.train.criterion import Criterion
    from gpnerf_tpu_torch.train.evaluator import Evaluator, predicted_rows
    from gpnerf_tpu_torch.train.step import make_optimizer, train_step
    from gpnerf_tpu_torch.train.trainer import Trainer

    n_warm, n_timed = 3, (5 if neg else 20)
    what = "training, neg-ray" if neg else "training"
    cfg = make_cfg(512, "bfloat16", neg)
    cfg.defrost()
    cfg.render.file = "BaseRender"
    cfg.result_dir = os.path.join(ROOT, "results", "chip_smoke")
    cfg.freeze()
    t0 = time.perf_counter()
    np.random.seed(0)
    random.seed(0)
    train_ds = get("dataset", cfg.dataset.train.file)(cfg, is_train=True)
    host = [train_ds[i] for i in range(n_warm + n_timed)]
    test_ds = get("dataset", cfg.dataset.test.file)(cfg, is_train=False)
    test_host = test_ds[0]
    size = f"{cfg.dataset.H}^2"
    log(f"# {what}: built {len(host)} train batches and 1 test frame at {size} on the host "
        f"in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    batches = [batch_to_device(b, dev) for b in host]
    test_batch = batch_to_device(test_host, dev)

    render = load_eval_model(CKPT, get("render", cfg.render.file)(cfg, device=dev))
    check(render.neg_ray_train == render.neg_ray_val == neg, f"{what}: neg-ray flags")
    evaluator = Evaluator(cfg, "chip_smoke")

    def eval_psnr():
        ret = render.render_eval_fn()(test_batch)
        pred, gt = predicted_rows(ret, test_host, cfg)
        check(bool(np.isfinite(pred).all()), "render_eval_fn: non-finite rgb")
        return evaluator.psnr_metric(pred, gt)

    psnr_before = eval_psnr()
    opt, sched, _ = make_optimizer(render, cfg)
    crit = Criterion(cfg)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    params0 = [p.detach().clone() for p in render.parameters()]
    stats0 = {k: v.clone() for k, v in render.state_dict().items() if "running" in k}

    ps.LAUNCHES.clear()
    metrics = [train_step(render, crit, opt, sched, b, generator=gen)[0] for b in batches[:n_warm]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(n_timed)]
    t0 = time.perf_counter()
    for (start, end), b in zip(events, batches[n_warm:]):
        start.record()
        metrics.append(train_step(render, crit, opt, sched, b, generator=gen)[0])
        end.record()
    torch.cuda.synchronize()
    wall_s = (time.perf_counter() - t0) / n_timed
    peak = torch.cuda.max_memory_allocated()
    step_s = sorted(s.elapsed_time(e) / 1e3 for s, e in events)
    losses = [float(m["loss"]) for m in metrics]
    overflows = [int(m["overflow"]) for m in metrics]
    log(f"# {what} on {card}: {n_timed} timed steps after {n_warm} warm-up, "
        f"{cfg.train.n_rays} rays x {cfg.train.n_samples} samples, {size}, float32: s/it min {step_s[0]:.4f} median {step_s[n_timed // 2]:.4f} "
        f"max {step_s[-1]:.4f} (CUDA events per step; host loop {wall_s:.4f} s/it), peak device "
        f"memory {peak / 2**30:.3f} GiB, loss first {losses[0]:.5f} last {losses[-1]:.5f}, "
        f"pyramid overflows max {max(overflows)}")
    check(all(math.isfinite(x) for x in losses), f"{what}: non-finite loss in {losses}")
    check(max(overflows) == 0, f"{what}: pyramid overflows {overflows}")
    moved = sum(not torch.equal(p, q) for p, q in zip(render.parameters(), params0))
    stats = {k: v for k, v in render.state_dict().items() if "running" in k}
    moved_stats = sum(not torch.equal(stats[k], v) for k, v in stats0.items())
    log(f"# {what}: {moved} of {len(params0)} parameter tensors and {moved_stats} of "
        f"{len(stats0)} running-statistics tensors moved")
    check(moved >= len(params0) - 2 and moved_stats == len(stats0),
          f"{what}: parameters or running statistics did not move")
    if profile and not neg:
        profile_steps(lambda b: train_step(render, crit, opt, sched, b, generator=gen),
                      batches[:3], card, step_s[n_timed // 2] * 1e3)

    psnr_after = eval_psnr()
    log(f"# {what}: render_eval_fn on test frame 0 ({int(test_host['n_rays'])} rays): PSNR "
        f"{psnr_before:.3f} dB before the steps, {psnr_after:.3f} dB after")
    check(psnr_after >= 20.0, f"{what}: eval PSNR {psnr_after:.3f} < 20 dB")
    if neg:
        return 0

    cfg_d = cfg.clone()
    cfg_d.defrost()
    cfg_d.render.file = "demo_render"
    cfg_d.freeze()
    demo = get("render", cfg_d.render.file)(cfg_d, device=dev)
    demo.load_state_dict(render.state_dict(), strict=True)
    del render, opt, batches
    loader = DataLoader(test_ds, [[0]], prefetch=0)
    result_path = os.path.join(cfg.result_dir, "evaluate")
    metrics_d, avg_s = Trainer(cfg_d, render=demo).evaluate(loader, result_path)
    launches = dict(ps.LAUNCHES)
    log(f"# training: Trainer.evaluate through demo_render, test frame 0: PSNR "
        f"{metrics_d['psnr']:.3f} dB, SSIM {metrics_d['ssim']:.4f}, overflows "
        f"{metrics_d['overflows_max']}, {avg_s * 1e3:.3f} ms per frame; launches over the "
        f"training path: {json.dumps(launches)}")
    check(launches == {"a": 2}, f"training path: point-stage launches {launches}, expected 2 "
                                "of form a (a warm-up and a timed render)")
    check(metrics_d["psnr"] >= 20.0, f"Trainer.evaluate PSNR {metrics_d['psnr']:.3f} < 20 dB")
    o = metrics_d["overflows_max"]
    check(o[0] == 0 and o[2] == 0 and o[3] == 0, f"Trainer.evaluate overflows {o}")
    return launches.get("a", 0)


def profile_steps(step, batches, card, step_ms):
    """torch.profiler over one train step per batch: device busy time per
    step and the idle share against the timed step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches:
            step(b)
        torch.cuda.synchronize()
    n = len(batches)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in events) / 1e3 / n
    log(f"# profile on {card}: train step, kernels busy {busy:.3f} ms per step of {step_ms:.3f} ms, "
        f"idle share {1.0 - busy / step_ms:.3f}; {sum(e.count for e in events) / n:.0f} kernel "
        "launches per step; by kernel (ms per step, launches per step):")
    for e in events[:25]:
        log(f"#   {e.self_device_time_total / 1e3 / n:9.4f} ms {e.count / n:6.1f}x  {e.key[:110]}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "gpnerf_tpu_torch")):
        print("gpnerf_tpu_torch/ not found: run chip_smoke.py from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    profile = "--profile" in sys.argv[1:]

    from gpnerf_tpu_torch.ops import point_stages as ps
    from gpnerf_tpu_torch.ops import quad_lerp as ql
    from gpnerf_tpu_torch.ops import row_gather as rg
    from gpnerf_tpu_torch.render import demo as demo_mod
    from gpnerf_tpu_torch.utils import bench_gather
    from gpnerf_tpu_torch.render.base import batch_to_device, src_norm
    from gpnerf_tpu_torch.utils.bench_frames import get_bench_frames

    # ---- phase 1: device, build ----
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    log(f"# device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    builds = {form: ps.start_build(form) for form in ps.FORMS}
    lerp_build, gather_build = ql.start_build(), rg.start_build()
    for form, proc in builds.items():
        ps.load_library(form, proc)
    ql.load_library(lerp_build)
    rg.load_library(gather_build)
    log(f"# built {len(builds)} instantiation(s) of csrc/point_stages.cu, csrc/quad_lerp.cu and "
        f"csrc/row_gather.cu in {time.perf_counter() - t0:.1f} s")
    build_logs = [(name, ps.BUILD_LOG.get(form)) for form, name in ps.FORMS.items()]
    build_logs += [("quad_lerp", ql.BUILD_LOG.get("quad_lerp")),
                   ("row_gather", rg.BUILD_LOG.get("row_gather"))]
    for name, entry in build_logs:
        for line in (entry or {}).get("output", "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"#   ptxas [{name}] {line.strip()}")
    for form, name in ps.FORMS.items():
        blocks, smem = ps.occupancy(form)
        log(f"#   occupancy [{name}] {blocks} block(s) per SM, "
            f"{smem} bytes of dynamic shared memory per block")
        check(blocks >= 1, f"point_stages[{name}]: no block fits on an SM ({blocks})")

    # ---- phase 2a: every instantiation vs plain on seeded random inputs ----
    cfg, render = make_render(512, "bfloat16", "cuda")
    weights = ps.pack_head_weights(render.nerfhead, fold_nch=render.nerfhead.spconv_out_dim[0])
    for form, name in ps.FORMS.items():
        # the fast-mode shape for its form, a ragged size for the others
        # (their main-path shape is checked on captured inputs below)
        P = cfg.tpu.samples_per_ray * cfg.tpu.ray_cap if name == "a" else 500003
        tabs, feats, vmask, sig_ok, kw = random_point_inputs(form, P, dev)
        before = ps.LAUNCHES[name]
        k_out = ps.fused_point_stages_tabs(tabs, feats, vmask, sig_ok, weights, **kw)
        torch.cuda.synchronize()
        check(ps.LAUNCHES[name] == before + 1, f"form {name}: wrapper did not launch its kernel")
        compare_point_stages(k_out, plain_in_chunks((tabs, feats, vmask, sig_ok, weights, kw)),
                             f"point_stages[{name}] vs plain, random inputs, P={P}")
        del tabs, feats, vmask, sig_ok, kw, k_out

    # ---- phase 2b: quad lerps and row gather vs plain, seeded random inputs ----
    g = torch.Generator(device=dev).manual_seed(1)
    Pl, Cl = 100003, ps.C  # ragged: no multiple of any tile
    w4r = torch.rand(ps.V, 4, Pl, generator=g, device=dev)
    w4r = w4r * (torch.rand(ps.V, 4, Pl, generator=g, device=dev) > 0.1)
    w4r_flat = w4r.permute(1, 0, 2).reshape(4, -1).contiguous()
    scr = 0.02 + 0.05 * torch.rand(Cl, generator=g, device=dev)
    for rows_r in (torch.randint(-127, 128, (ps.V * Pl, 4 * Cl), generator=g, device=dev,
                                 dtype=torch.int8),
                   torch.randn(ps.V * Pl, 4 * Cl, generator=g, device=dev)):
        for odt in (torch.bfloat16, torch.float32):
            what = f"rows {rows_r.dtype} -> {odt}, P={Pl}"
            before = dict(ql.LAUNCHES)
            o_vcp = ql.quad_lerp_rows_vcp(rows_r, w4r, scr, out_dtype=odt)
            o_cm = ql.quad_lerp_rows_cm(rows_r, w4r_flat, scr, out_dtype=odt)
            torch.cuda.synchronize()
            check(ql.LAUNCHES["quad_lerp_rows_vcp"] == before.get("quad_lerp_rows_vcp", 0) + 1
                  and ql.LAUNCHES["quad_lerp_rows_cm"] == before.get("quad_lerp_rows_cm", 0) + 1,
                  f"quad lerp wrappers did not launch their kernels ({what})")
            p_vcp = ql.quad_lerp_rows_vcp_plain(rows_r, w4r, scr, out_dtype=odt)
            check(same_bits(o_vcp, p_vcp), f"quad_lerp_rows_vcp differs from plain ({what})")
            check(same_bits(o_cm, ql.quad_lerp_rows_cm_plain(rows_r, w4r_flat, scr, out_dtype=odt)),
                  f"quad_lerp_rows_cm differs from plain ({what})")
            log(f"# quad_lerp_rows_vcp and quad_lerp_rows_cm vs plain, random inputs, {what}: bitwise equal")
    del rows_r, w4r, w4r_flat, o_vcp, o_cm, p_vcp
    rs = torch.Generator(device=dev).manual_seed(2)
    g_table = torch.randn(bench_gather.TABLE_ROWS, bench_gather.CHANNELS, generator=rs, device=dev)
    g_idx = torch.randint(0, bench_gather.TABLE_ROWS, (8 * 1024 * 1024,), generator=rs, device=dev,
                          dtype=torch.int32)
    before = rg.LAUNCHES["row_gather"]
    g_out = rg.row_gather(g_table, g_idx)
    torch.cuda.synchronize()
    check(rg.LAUNCHES["row_gather"] == before + 1, "row_gather wrapper did not launch its kernel")
    check(same_bits(g_out, rg.row_gather_plain(g_table, g_idx)), "row_gather differs from plain")
    log(f"# row_gather vs plain, table {tuple(g_table.shape)} f32, {g_idx.numel()} int32 indices: bitwise equal")
    gather_err = float((g_out - rg.row_gather_plain(g_table, g_idx)).abs().max())

    # ---- phase 3: end to end at 512^2 on bench-protocol frames ----
    t0 = time.perf_counter()
    host = get_bench_frames(cfg, 3)
    log(f"# built 3 bench frames at 512^2 on the host in {time.perf_counter() - t0:.1f} s")
    batches = [batch_to_device(b, dev) for b in host]
    pos_batches, pos_host = batches, host
    kernels, images = [], {}  # one `kernels` entry per instantiation

    def run_mode(title, form_name, n_frames, render, stages=False, frames=None):
        """Drive one render mode over the first n_frames bench frames (of
        `frames`, (device batches, host batches), else the positive ones),
        check it, compare and time its kernel instantiation on the inputs
        captured from frame 0. Appends to `kernels`; returns (frame ms,
        PSNRs)."""
        batches, host = frames or (pos_batches, pos_host)
        fn = render.render_demo_fn()
        captured = []
        real = demo_mod.fused_point_stages_tabs

        def capture(tabs, feats, vmask, sig_ok, weights, **kw):
            captured.append((tabs, feats, vmask, sig_ok.to(torch.uint8), weights, kw))
            return real(tabs, feats, vmask, sig_ok, weights, **kw)

        demo_mod.fused_point_stages_tabs = capture
        try:
            fn(batches[0])  # warm (allocator) and capture the kernel's inputs
        finally:
            demo_mod.fused_point_stages_tabs = real
        torch.cuda.synchronize()

        ps.LAUNCHES.clear()
        rets = [fn(b) for b in batches[:n_frames]]
        torch.cuda.synchronize()
        launches = dict(ps.LAUNCHES)
        log(f"# {title}: main path launches over {n_frames} frame(s): {json.dumps(launches)}")
        check(launches == {form_name: n_frames},
              f"{title}: launches {launches}, expected {n_frames} of form {form_name}")
        psnrs = []
        for i, (r, hb) in enumerate(zip(rets, host)):
            ov = r["overflows"].tolist()
            counts = r["counts"].tolist()
            check(ov[0] == 0 and ov[2] == 0 and ov[3] == 0, f"{title} frame {i}: overflows {ov}")
            if not render.tight_cull:
                check(ov[1] == 0, f"{title} frame {i}: K = S drops nothing, got {ov}")
            check(bool(torch.isfinite(r["pred_chw"]).all()), f"{title} frame {i}: non-finite image")
            check(tuple(r["pred_chw"].shape) == (3, 512, 512), f"{title} frame {i}: shape")
            psnrs.append(psnr_of(r, hb))
            log(f"# {title} frame {i}: overflows(ray,perrayK,sigma,rgb)={ov} "
                f"counts(rays,sigma,rgb)={counts} PSNR {psnrs[-1]:.3f} dB")
            check(psnrs[-1] >= 20.0, f"{title} frame {i}: PSNR {psnrs[-1]:.3f} < 20 dB")
        images[title] = rets[0]["pred_chw"]

        # kernel vs plain on the inputs captured from frame 0, then timings
        call = captured[0]
        tabs, feats, vmask, sig_ok, weights, kw = call
        P = vmask.shape[-1]
        k_out = ps.fused_point_stages_tabs(tabs, feats, vmask, sig_ok, weights, **kw)
        torch.cuda.synchronize()
        stats = compare_point_stages(
            k_out, plain_in_chunks(call), f"point_stages[{form_name}] vs plain, {title} frame 0 inputs, P={P}")
        n = n_frames
        it = iter(range(10**9))
        # each rep renders the next of the distinct frames
        frame_ms, host_ms = cuda_ms(lambda: fn(batches[next(it) % n]), 3 * n, with_host=True)
        line = (f"# timing on {card}: {title} whole render {frame_ms:.3f} ms/frame "
                f"(host enqueue {host_ms:.3f} ms/frame)")
        if stages:
            enc_ms = cuda_ms(lambda: render.encoder(src_norm(batches[next(it) % n]["src_imgs"])), 3 * n)
            upto_ms = cuda_ms(lambda: render._frame_stage(
                batches[next(it) % n], render.encoder(src_norm(batches[next(it) % n]["src_imgs"]))), 3 * n)
            line += (f", encoder {enc_ms:.3f} ms, frame stage {upto_ms - enc_ms:.3f} ms, ray pipeline "
                     f"+ image {frame_ms - upto_ms:.3f} ms (stage-prefix differences of CUDA-event means)")
        kern_ms = cuda_ms(lambda: ps.fused_point_stages_tabs(tabs, feats, vmask, sig_ok, weights, **kw),
                          20 if P < 10**6 else 5)
        plain_ms = cuda_ms(lambda: plain_in_chunks(call), 5 if P < 10**6 else 1)
        nbytes, bound_ms, bound_by = point_stage_cost(call, k_out)
        log(line + f"; point_stages[{form_name}] kernel {kern_ms:.3f} ms at P={P}, plain {plain_ms:.3f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB), "
            f"mean PSNR {sum(psnrs) / len(psnrs):.3f} dB")
        if profile and stages:
            profile_render(fn, batches[:n], card, frame_ms)
        name = f"point_stages[{form_name}]"
        for k in kernels:
            if k["name"] == name:  # a second mode through the same instantiation
                k["launches"] += launches[form_name]
                return frame_ms, psnrs
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "gpnerf_tpu_torch/csrc/point_stages.cu",
            "replaces": "gpnerf_tpu/ops/pallas_point.py:426",
            "launches": launches[form_name],
            "max_abs_err": max(stats["max_abs_d_alpha"], stats["max_abs_d_rgb"]),
            "ms": kern_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
        })
        return frame_ms, psnrs

    run_mode("fast mode", "a", 3, render, stages=True)
    run_mode("fast mode, kernel_octet off", "a+b", 1,
             make_render(512, "bfloat16", "cuda", kernel_octet=False)[1])
    render_fast = render
    del render
    run_mode("reference mode", "c", 2, make_render(512, "bfloat16", "cuda", **REF_MODE)[1], stages=True)
    for title, form_name, extra in (
        ("reference mode, frame_mode", "c+e", {"frame_mode": True}),
        ("reference mode, sigma_query_cull", "c+e", {"sigma_query_cull": True}),
        ("reference mode, int4_feat", "c+d", {"int4_feat": True}),
        ("reference mode, kernel_octet off", "b+c", {"kernel_octet": False}),
    ):
        run_mode(title, form_name, 1, make_render(512, "bfloat16", "cuda", **REF_MODE, **extra)[1])
        torch.cuda.empty_cache()
    # the windowless frame and the dense slots under the same trilinear cull
    # evaluate the same kernel on the same surviving samples
    m = (images["reference mode, frame_mode"] - images["reference mode, sigma_query_cull"]).abs()
    d_ref = (images["reference mode, frame_mode"] - images["reference mode"]).abs()
    log(f"# frame_mode vs dense slots + sigma_query_cull, frame 0: |d pred| max {float(m.max()):.2e}; "
        f"vs dense slots under the tap alone: mean {float(d_ref.mean()):.2e} max {float(d_ref.max()):.2e} "
        "(the tap keeps the blanket's fringe samples)")
    check(float(m.max()) < 1e-3, "frame_mode and dense slots + sigma_query_cull images differ")

    # ---- phase 3b: the op-by-op point stages ----
    def run_opbyop(title, n_frames, render, lerp_launches, frames=None):
        """Drive an op-by-op mode over the first n_frames frames (of
        `frames`, as run_mode) with the counts at 0, check launches,
        overflows and PSNR. Returns the rets."""
        batches, host = frames or (pos_batches, pos_host)
        fn = render.render_demo_fn()
        fn(batches[0])  # warm
        torch.cuda.synchronize()
        ps.LAUNCHES.clear()
        ql.LAUNCHES.clear()
        rets = [fn(b) for b in batches[:n_frames]]
        torch.cuda.synchronize()
        launches = {**ps.LAUNCHES, **ql.LAUNCHES}
        log(f"# {title}: main path launches over {n_frames} frame(s): {json.dumps(launches)}")
        want = {"quad_lerp_rows_vcp": lerp_launches} if lerp_launches else {}
        check(launches == want, f"{title}: launches {launches}, expected {want}")
        for i, (r, hb) in enumerate(zip(rets, host)):
            ov, counts = r["overflows"].tolist(), r["counts"].tolist()
            check(ov[0] == 0 and ov[2] == 0 and ov[3] == 0, f"{title} frame {i}: overflows {ov}")
            if not render.tight_cull:
                check(ov[1] == 0, f"{title} frame {i}: K = S drops nothing, got {ov}")
            check(bool(torch.isfinite(r["pred_chw"]).all()), f"{title} frame {i}: non-finite image")
            check(tuple(r["pred_chw"].shape) == (3, 512, 512), f"{title} frame {i}: shape")
            psnr = psnr_of(r, hb)
            log(f"# {title} frame {i}: overflows(ray,perrayK,sigma,rgb)={ov} "
                f"counts(rays,sigma,rgb)={counts} PSNR {psnr:.3f} dB")
            check(psnr >= 20.0, f"{title} frame {i}: PSNR {psnr:.3f} < 20 dB")
        return rets

    def image_gap(title, img, ref_title, max_tol, mean_tol):
        d = (img - images[ref_title]).abs()
        log(f"# {title} vs {ref_title}, frame 0: |d pred| median {float(d.median()):.2e} "
            f"mean {float(d.mean()):.2e} max {float(d.max()):.2e}")
        check(float(d.max()) < max_tol and float(d.mean()) < mean_tol,
              f"{title} image differs from {ref_title}")

    op_render = make_render(512, "bfloat16", "cuda", pallas_point=False)[1]
    captured = []
    real_vcp = ql.quad_lerp_rows_vcp

    def capture_vcp(rows, w4, scale, **kw):
        captured.append((rows, w4, scale, kw))
        return real_vcp(rows, w4, scale, **kw)

    ql.quad_lerp_rows_vcp = capture_vcp
    try:
        op_render.render_demo_fn()(batches[0])
    finally:
        ql.quad_lerp_rows_vcp = real_vcp
    torch.cuda.synchronize()
    check(len(captured) == 1, "op-by-op fast mode: one quad lerp per frame")
    op_title = "op-by-op fast mode"
    rets = run_opbyop(op_title, 3, op_render, 3)
    images[op_title] = rets[0]["pred_chw"]
    # against the fused kernel: bf16 dot inputs with float32 accumulation
    # there, every layer output rounded to bf16 here
    image_gap(op_title, images[op_title], "fast mode", 0.1, 5e-4)
    n = 3
    it = iter(range(10**9))
    op_fn = op_render.render_demo_fn()
    op_ms, op_host_ms = cuda_ms(lambda: op_fn(batches[next(it) % n]), 3 * n, with_host=True)
    log(f"# timing on {card}: {op_title} whole render {op_ms:.3f} ms/frame "
        f"(host enqueue {op_host_ms:.3f} ms/frame)")
    if profile:
        profile_render(op_fn, batches[:n], card, op_ms)

    # the lerp kernels on the rows captured from frame 0
    l_rows, l_w4, l_scale, l_kw = captured[0]
    l_out = ql.quad_lerp_rows_vcp(l_rows, l_w4, l_scale, **l_kw)
    l_plain = ql.quad_lerp_rows_vcp_plain(l_rows, l_w4, l_scale, **l_kw)
    check(same_bits(l_out, l_plain), "quad_lerp_rows_vcp differs from plain on the frame's rows")
    lV, lC, lP = l_out.shape
    l_w4_flat = l_w4.permute(1, 0, 2).reshape(4, lV * lP).contiguous()
    ql.LAUNCHES.clear()
    cm_out = ql.quad_lerp_rows_cm(l_rows, l_w4_flat, l_scale, **l_kw)
    torch.cuda.synchronize()
    cm_launches = ql.LAUNCHES["quad_lerp_rows_cm"]
    check(cm_launches == 1, "quad_lerp_rows_cm did not launch its kernel")
    check(same_bits(cm_out, l_out.permute(1, 0, 2).reshape(lC, lV * lP)),
          "quad_lerp_rows_cm differs from the transposed quad_lerp_rows_vcp output")
    check(same_bits(cm_out, ql.quad_lerp_rows_cm_plain(l_rows, l_w4_flat, l_scale, **l_kw)),
          "quad_lerp_rows_cm differs from plain on the frame's rows")
    log(f"# quad_lerp_rows_vcp vs plain and quad_lerp_rows_cm vs both, {op_title} frame 0 rows "
        f"{tuple(l_rows.shape)} {l_rows.dtype} -> {tuple(l_out.shape)} {l_out.dtype}: bitwise equal")
    for name, line, fn_k, fn_p, out_k, out_p, launches in (
        ("quad_lerp_rows_vcp", 125,
         lambda: ql.quad_lerp_rows_vcp(l_rows, l_w4, l_scale, **l_kw),
         lambda: ql.quad_lerp_rows_vcp_plain(l_rows, l_w4, l_scale, **l_kw), l_out, l_plain, 3),
        ("quad_lerp_rows_cm", 70,
         lambda: ql.quad_lerp_rows_cm(l_rows, l_w4_flat, l_scale, **l_kw),
         lambda: ql.quad_lerp_rows_cm_plain(l_rows, l_w4_flat, l_scale, **l_kw),
         cm_out, l_plain.permute(1, 0, 2).reshape(lC, lV * lP), cm_launches),
    ):
        k_ms, p_ms = cuda_ms(fn_k, 20), cuda_ms(fn_p, 5)
        nb, bound_ms, bound_by = lerp_cost(l_rows, l_w4, l_scale, out_k)
        log(f"# timing on {card}: {name} kernel {k_ms:.4f} ms at rows {tuple(l_rows.shape)}, plain "
            f"{p_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}, {nb / 1e6:.1f} MB)")
        kernels.append({
            "name": name, "route": "cuda", "source": "gpnerf_tpu_torch/csrc/quad_lerp.cu",
            "replaces": f"gpnerf_tpu/ops/pallas_lerp.py:{line}", "launches": launches,
            "max_abs_err": float((out_k.float() - out_p.float()).abs().max()),
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes the lerp
        })
    del captured, l_rows, l_w4, l_w4_flat, l_out, l_plain, cm_out

    # the torch-op routes of the merged table: every product and partial sum
    # rounded to bf16, where the kernel accumulates in float32
    for title, extra in (("op-by-op fast mode, pallas_lerp off", {"pallas_lerp": False}),
                         ("op-by-op fast mode, proj_vp_order", {"pallas_lerp": False,
                                                                "proj_vp_order": True})):
        r = make_render(512, "bfloat16", "cuda", pallas_point=False, **extra)[1]
        rets = run_opbyop(title, 1, r, 0)
        image_gap(title, rets[0]["pred_chw"], op_title, 0.1, 5e-4)
        images[title] = rets[0]["pred_chw"]
    check(bool(torch.equal(images["op-by-op fast mode, pallas_lerp off"],
                           images["op-by-op fast mode, proj_vp_order"])),
          "the (P, V) and (V, P) gather orders give different images")

    # Renderer.profile on the fast mode: the op-by-op stage ladder
    # five reps per frame: a program's time is the least of its reps, and
    # the slots are differences of those, so host noise must be outlasted
    prof = render_fast.profile(batches[:3], reps=5)
    slots = prof["time_slots"]
    log(f"# profile on {card}: fast mode, 3 frames, ms: etime {prof['etime'] * 1e3:.3f} rtime "
        f"{prof['rtime'] * 1e3:.3f} rtime_production {prof['rtime_production'] * 1e3:.3f} time_slots "
        + json.dumps({k: round(v * 1e3, 4) for k, v in slots.items()}))
    check(set(slots) == {"bc_attn", "sigma_attn", "sigma_c", "sp_encode", "bc_time", "bf_sigma",
                         "sigma_f", "bf_rgb", "rgb_f", "bc_render"}, "profile: slot names")
    check(render_fast.pallas_point, "profile left pallas_point off")
    # stage prefixes grow along the ladder; the host sets the fast mode's
    # frame time and varies by milliseconds between runs of one program, so
    # a slot may read up to 2 ms low
    check(all(math.isfinite(v) and v > -2e-3 for v in slots.values()) and slots["sp_encode"] > 0
          and prof["rtime"] > slots["sp_encode"] and prof["rtime_production"] > 0,
          f"profile: stage times do not grow along the ladder: {slots}")
    del render_fast

    # op-by-op reference mode: split tables through project_and_gather_quad
    title = "op-by-op reference mode"
    op_ref = make_render(512, "bfloat16", "cuda", pallas_point=False, **REF_MODE)[1]
    rets = run_opbyop(title, 1, op_ref, 0)
    image_gap(title, rets[0]["pred_chw"], "reference mode", 0.2, 5e-4)
    ref_ms = cuda_ms(lambda: op_ref.render_demo_fn()(batches[0]), 3)
    log(f"# timing on {card}: {title} whole render {ref_ms:.3f} ms/frame (frame 0, 3 reps)")
    del rets, op_ref
    torch.cuda.empty_cache()

    # the gather microbenchmark, through the row-gather kernel
    rg.LAUNCHES.clear()
    bench = bench_gather.run("cuda")
    gather_launches = rg.LAUNCHES["row_gather"]
    for k, v in bench.items():
        if k.endswith("_ms") or k.endswith("_gb_s"):
            log(f"# bench_gather on {card}: {k} {v:.4f}")
    check(bench["kernel_launches"] == 1 and gather_launches >= 1,
          f"bench_gather: row_gather launches {gather_launches}")
    k_ms = cuda_ms(lambda: rg.row_gather(g_table, g_idx), 20)
    p_ms = cuda_ms(lambda: rg.row_gather_plain(g_table, g_idx), 5)
    lib_ms = cuda_ms(lambda: torch.index_select(g_table, 0, g_idx), 20)
    nb = nbytes(g_table, g_idx, g_out)
    log(f"# timing on {card}: row_gather kernel {k_ms:.4f} ms at {g_idx.numel()} rows of "
        f"{g_table.shape[1]} f32, plain {p_ms:.4f} ms, index_select {lib_ms:.4f} ms, bound "
        f"{nb / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes, {nb / 1e6:.1f} MB)")
    kernels.append({
        "name": "row_gather", "route": "cuda", "source": "gpnerf_tpu_torch/csrc/row_gather.cu",
        "replaces": "tools/bench_gather.py:84", "launches": gather_launches,
        "max_abs_err": gather_err, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": nb / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": lib_ms,
    })
    del g_table, g_idx, g_out

    # ---- phase 3c: THuman's neg-ray convention ----
    t0 = time.perf_counter()
    neg_host = get_bench_frames(make_cfg(512, "bfloat16", neg=True), 3)
    log(f"# built 3 {NEG} bench frames at 512^2 on the host in {time.perf_counter() - t0:.1f} s")
    check(all((b["near"][: int(b["n_rays"])] < 0).all() for b in neg_host),
          f"{NEG}: ray t-spans are not negative")
    neg_frames = ([batch_to_device(b, dev) for b in neg_host], neg_host)
    neg_fast = make_render(512, "bfloat16", "cuda", neg=True)[1]
    check(neg_fast.neg_ray_val, "neg-ray fast mode: neg_ray_val off")
    run_mode("neg-ray fast mode", "a", 3, neg_fast, stages=True, frames=neg_frames)
    del neg_fast
    run_mode("neg-ray reference mode", "c", 1,
             make_render(512, "bfloat16", "cuda", neg=True, **REF_MODE)[1], stages=True,
             frames=neg_frames)
    torch.cuda.empty_cache()
    title = "neg-ray op-by-op fast mode"
    neg_op = make_render(512, "bfloat16", "cuda", neg=True, pallas_point=False)[1]
    captured = []
    ql.quad_lerp_rows_vcp = capture_vcp
    try:
        neg_op.render_demo_fn()(neg_frames[0][0])
    finally:
        ql.quad_lerp_rows_vcp = real_vcp
    check(len(captured) == 1, f"{title}: one quad lerp per frame")
    rets = run_opbyop(title, 1, neg_op, 1, frames=neg_frames)
    image_gap(title, rets[0]["pred_chw"], "neg-ray fast mode", 0.1, 5e-4)
    l_rows, l_w4, l_scale, l_kw = captured[0]
    check(same_bits(ql.quad_lerp_rows_vcp(l_rows, l_w4, l_scale, **l_kw),
                    ql.quad_lerp_rows_vcp_plain(l_rows, l_w4, l_scale, **l_kw)),
          f"quad_lerp_rows_vcp differs from plain on the {title} frame's rows")
    log(f"# quad_lerp_rows_vcp vs plain, {title} frame 0 rows {tuple(l_rows.shape)} "
        f"{l_rows.dtype}: bitwise equal")
    for k in kernels:
        if k["name"] == "quad_lerp_rows_vcp":
            k["launches"] += 1
    del captured, l_rows, l_w4, rets, neg_op, neg_frames
    torch.cuda.empty_cache()

    # ---- small-input reference: 128^2 on the card and on the CPU ----
    card_vs_cpu_128("op-by-op fast mode", 0.05, ray_cap=16384, pallas_point=False)
    card_vs_cpu_128("fast mode", 0.05, ray_cap=16384)
    # reference mode: rays of image row 0 project onto source row y = 0.0 to
    # the last bit, where the rounding of the projection product decides the
    # in-bounds test and a view flips in or out for a few pixels
    card_vs_cpu_128("reference mode", 0.15, **{**REF_MODE, "ray_cap": 9216})

    # ---- phase 5: the training path ----
    torch.cuda.empty_cache()
    eval_launches = train_phase(card, profile)
    for k in kernels:
        if k["name"] == "point_stages[a]":
            k["launches"] += eval_launches
    torch.cuda.empty_cache()
    train_phase(card, profile, neg=True)
    torch.cuda.empty_cache()

    # ---- phase 6: the inference CLI, a process of its own ----
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "inference_torch.py"), "--cfg",
         os.path.join(ROOT, "configs", "synthetic.yaml"), "render.file", "demo_render",
         "render.resume_path", CKPT, "dataset.test.sampler", "FrameSampler",
         "head.sigma.code_dim", "32", "result_dir", os.path.join(ROOT, "results", "chip_smoke_cli")],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(cli.returncode == 0, f"inference CLI exited {cli.returncode}: {cli.stderr[-3000:]}")
    for line in cli.stdout.splitlines():
        if line.startswith(("mse: ", "psnr: ", "ssim: ", "overflows", "avg ")):
            log(f"# inference CLI: {line}")
    cli_psnr = float([x for x in cli.stdout.splitlines() if x.startswith("psnr: ")][-1].split()[1])
    log(f"# inference CLI on {card}: tools/inference_torch.py --cfg configs/synthetic.yaml "
        f"(FrameSampler, 2 frames at 512^2) exited 0 in {time.perf_counter() - t0:.1f} s, "
        f"PSNR {cli_psnr:.3f} dB")
    check(cli_psnr >= 20.0, f"inference CLI PSNR {cli_psnr:.3f} < 20 dB")

    log(f"# total {time.perf_counter() - t_all:.1f} s")
    check(len(kernels) == 9 and all(k["launches"] >= 1 for k in kernels),
          f"kernels line: {[(k['name'], k['launches']) for k in kernels]}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
