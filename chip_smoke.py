#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gpnerf_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py              # the smoke test
    python3 chip_smoke.py --profile    # plus a torch.profiler kernel table

Phases, each fatal on failure:
  1. device and power limit; build every CUDA kernel of the fast render
     path from gpnerf_tpu_torch/csrc/ (one nvcc per source, started
     together);
  2. each kernel against its plain PyTorch version on the card: seeded
     random inputs at the main-path shape, then the inputs captured from
     one rendered frame;
  3. end to end: 3 frames of the bench protocol at 512^2 (configs/
     synthetic.yaml, trained checkpoint) through the fast-mode
     `render_demo_fn`, with launch counts, zero-overflow and PSNR checks,
     plus a 128^2 frame rendered on the card and on the CPU (plain
     versions) that must agree;
  4. CUDA-event timings of the whole render, of its stage prefixes
     (encoder; + frame stage; + ray pipeline and image) and of each kernel;
  5. one JSON line listing the kernels, the card's name and power limit,
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


def make_cfg(size, matmul_dtype):
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
    """Hold the kernel's (alpha, rgb) against the plain version's with the
    tolerances of tests/test_pallas_point.py:83-103. Returns stats."""
    import torch

    a, rgb = kern
    a_ref, rgb_ref = plain
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
    log(f"# {what}: " + json.dumps(stats))
    return stats


def random_point_inputs(P, device, seed=0):
    """Seeded random inputs of the point-stage kernel at P points, made on
    the device (the form the fast render path feeds it)."""
    import torch

    from gpnerf_tpu_torch.ops.point_stages import C, C0, C1, V

    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*s):
        return torch.rand(*s, generator=g, device=device)

    def ints(lo, hi, *s, dtype):
        return torch.randint(lo, hi, s, generator=g, device=device).to(dtype)

    rows = ints(-127, 128, V * P, 4 * C, dtype=torch.int8)
    w4 = rand(V, 4, P) * (rand(V, 4, P) > 0.1)
    pscale = 0.02 + rand(C) * 0.05
    gw0 = rand(8, P)
    geom = (
        (ints(0, 256, P, 8 * C0, dtype=torch.uint8), gw0 / gw0.sum(0), 0.01 + rand(C0) * 0.03),
        (ints(-127, 128, P, C1, dtype=torch.int8), (rand(1, P) > 0.05).float(), 0.01 + rand(C1) * 0.03),
    )
    vmask = (rand(V, P) > 0.15).float()
    sig_ok = rand(P) > 0.2
    return rows, w4, pscale, geom, vmask, sig_ok


def point_stage_cost(args, outs):
    """(bytes, bound ms) of one point-stage call: each input read once and
    each output written once, over HBM; MLP multiply-adds at the bf16
    tensor-core rate plus the f32 lerps, whichever bound is larger."""
    import torch

    rows, w4, pscale, geom, vmask, sig_ok, weights = args
    tensors = [rows, w4, pscale, vmask, sig_ok.to(torch.uint8), weights.flat, *outs]
    for g in geom:
        tensors += list(g)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    P = w4.shape[-1]
    macs = sum(w.shape[0] * w.shape[1] for w, _ in weights.layers)
    macs += 2 * sum(w.shape[0] * w.shape[1] for w, _ in weights.layers[5:9])  # per-view MLPs run V=3 times
    V, T, Cp = w4.shape[0], w4.shape[1], pscale.shape[0]
    lerp = V * Cp * (2 * T) + sum(g[0].shape[1] * 2 + g[2].shape[0] for g in geom) + 4 * V * Cp
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = P * (2 * macs / BF16_FLOP_PER_S + lerp / F32_FLOP_PER_S)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    return nbytes, max(t_bytes, t_ops) * 1e3, bound_by


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


def main():
    import numpy as np
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

    from gpnerf_tpu_torch.ops import point_stages as ps
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render import demo as demo_mod
    from gpnerf_tpu_torch.render.base import batch_to_device, src_norm
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model
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
    builds = {}
    cmd, _ = ps.build_command()
    os.makedirs(ps.BUILD_DIR, exist_ok=True)
    builds["point_stages"] = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    ps.load_library(builds["point_stages"])
    log(f"# built {len(builds)} kernel(s) in {time.perf_counter() - t0:.1f} s")
    for line in ps.BUILD_LOG.get("output", "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"#   ptxas {line.strip()}")

    # ---- renderer with the trained checkpoint (shipped bf16 config) ----
    cfg = make_cfg(512, "bfloat16")
    render = get("render", cfg.render.file)(cfg, device="cuda")
    load_eval_model(CKPT, render)
    weights = ps.pack_head_weights(render.nerfhead, fold_nch=render.nerfhead.spconv_out_dim[0])

    # ---- phase 2a: kernel vs plain on seeded random inputs ----
    P = cfg.tpu.samples_per_ray * cfg.tpu.ray_cap
    rnd = random_point_inputs(P, dev)
    k_out = ps.fused_point_stages(*rnd, weights)
    torch.cuda.synchronize()
    compare_point_stages(k_out, ps.point_stages_plain(*rnd, weights),
                         f"point_stages vs plain, random inputs, P={P}")
    del rnd, k_out

    # ---- phase 3: end to end at 512^2, 3 bench-protocol frames ----
    t0 = time.perf_counter()
    host = get_bench_frames(cfg, 3)
    log(f"# built 3 bench frames at 512^2 on the host in {time.perf_counter() - t0:.1f} s")
    batches = [batch_to_device(b, dev) for b in host]
    fn = render.render_demo_fn()
    captured = []
    real_fused = demo_mod.fused_point_stages

    def capture(*args):
        captured.append(args)
        return real_fused(*args)

    demo_mod.fused_point_stages = capture
    try:
        fn(batches[0])  # warm (allocator, library load) and capture inputs
    finally:
        demo_mod.fused_point_stages = real_fused
    torch.cuda.synchronize()

    ps.fused_point_stages.launches = 0
    rets = [fn(b) for b in batches]
    torch.cuda.synchronize()
    launches = {"point_stages": ps.fused_point_stages.launches}
    log(f"# main path launches over {len(batches)} frames: {json.dumps(launches)}")
    for name, n in launches.items():
        check(n == len(batches), f"{name} launched {n} times for {len(batches)} frames")
    psnrs = []
    for i, (r, hb) in enumerate(zip(rets, host)):
        ov = r["overflows"].tolist()
        counts = r["counts"].tolist()
        check(ov[0] == 0 and ov[2] == 0 and ov[3] == 0, f"frame {i}: overflows {ov}")
        check(bool(torch.isfinite(r["pred_chw"]).all()), f"frame {i}: non-finite image")
        check(tuple(r["pred_chw"].shape) == (3, 512, 512), f"frame {i}: shape")
        psnrs.append(psnr_of(r, hb))
        log(f"# frame {i}: overflows(ray,perrayK,sigma,rgb)={ov} counts(rays,sigma,rgb)={counts} "
            f"PSNR {psnrs[-1]:.3f} dB")
        check(psnrs[-1] >= 20.0, f"frame {i}: PSNR {psnrs[-1]:.3f} < 20 dB")

    # ---- phase 2b: kernel vs plain on the inputs captured from frame 0 ----
    args = captured[0]
    real_args = args[:5] + (args[5].to(torch.uint8),) + args[6:]
    k_out = ps.fused_point_stages(*real_args)
    p_out = ps.point_stages_plain(*real_args)
    torch.cuda.synchronize()
    real_stats = compare_point_stages(k_out, p_out, f"point_stages vs plain, frame 0 inputs, P={args[1].shape[-1]}")
    max_err = max(real_stats["max_abs_d_alpha"], real_stats["max_abs_d_rgb"])

    # ---- small-input reference: the same 128^2 frame on the card and on the
    # CPU (plain versions), float32 config ----
    cfg_s = make_cfg(128, "float32")
    cfg_s.defrost()
    cfg_s.tpu.ray_cap = 16384
    cfg_s.freeze()
    np.random.seed(0)
    random.seed(0)
    small = get("dataset", cfg_s.dataset.test.file)(cfg_s, is_train=False)[0]
    outs = {}
    for d in ("cuda", "cpu"):
        r = get("render", "demo_render")(cfg_s, device=d)
        load_eval_model(CKPT, r)
        o = r.render_demo_fn()(batch_to_device(small, d))
        outs[d] = {k: v.cpu() for k, v in o.items()}
    g, c = outs["cuda"], outs["cpu"]
    same_mask = float((g["mask_at_box"] == c["mask_at_box"]).float().mean())
    m = g["mask_at_box"] & c["mask_at_box"]
    d_img = (g["pred_chw"].reshape(3, -1)[:, m] - c["pred_chw"].reshape(3, -1)[:, m]).abs()
    log(f"# 128^2 card vs CPU: mask agreement {same_mask:.6f}, counts {g['counts'].tolist()} vs "
        f"{c['counts'].tolist()}, |d pred| median {float(d_img.median()):.2e} max {float(d_img.max()):.2e}")
    check(same_mask > 0.999, "128^2 card vs CPU: ray masks differ")
    check(float(d_img.median()) < 2e-3 and float(d_img.max()) < 0.05,
          "128^2 card vs CPU: images differ")
    del outs, g, c

    # ---- phase 4: timings (CUDA events, warm) ----
    n = len(batches)
    it = iter(range(10**9))
    # each rep renders the next of the distinct frames
    frame_ms, host_ms = cuda_ms(lambda: fn(batches[next(it) % n]), 3 * n, with_host=True)
    enc_ms = cuda_ms(lambda: render.encoder(src_norm(batches[next(it) % n]["src_imgs"])), 3 * n)

    def upto_frame_stage(b):
        return render._frame_stage(b, render.encoder(src_norm(b["src_imgs"])))

    upto_ms = cuda_ms(lambda: upto_frame_stage(batches[next(it) % n]), 3 * n)
    log(f"# stages on {card}: encoder {enc_ms:.3f} ms, frame stage "
        f"{upto_ms - enc_ms:.3f} ms, ray pipeline + image {frame_ms - upto_ms:.3f} ms "
        f"(stage-prefix differences of CUDA-event means over distinct frames)")
    kern_ms = cuda_ms(lambda: ps.fused_point_stages(*real_args), 20)
    plain_ms = cuda_ms(lambda: ps.point_stages_plain(*real_args), 5)
    if "--profile" in sys.argv[1:]:
        profile_render(fn, batches, card, frame_ms)
    nbytes, bound_ms, bound_by = point_stage_cost(real_args, k_out)
    log(f"# timing on {card}: whole render {frame_ms:.3f} ms/frame "
        f"(host enqueue {host_ms:.3f} ms/frame, encoder {enc_ms:.3f} ms), point_stages kernel {kern_ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB), "
        f"mean PSNR {sum(psnrs) / len(psnrs):.3f} dB")
    kernels = [{
        "name": "point_stages",
        "route": "cuda",
        "source": "gpnerf_tpu_torch/csrc/point_stages.cu",
        "replaces": "gpnerf_tpu/ops/pallas_point.py:426",
        "launches": launches["point_stages"],
        "max_abs_err": max_err,
        "ms": kern_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]
    log(f"# total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
