#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gpnerf_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py              # the smoke test
    python3 chip_smoke.py --profile    # plus a torch.profiler kernel table
    python3 chip_smoke.py --all-keys   # plus every point-stage key the
                                       # renderer's switches reach (~10 min)
    python3 chip_smoke.py --dp-only    # phase 7c alone (data parallelism;
                                       # NCCL across two cards, if present)

Phases, each fatal on failure:
  1. device and power limit; build every CUDA kernel from
     gpnerf_tpu_torch/csrc/: the point-stage kernel for FORMS' 32 keys
     (ops/point_stages.py: projection row types by geometry layouts, 3
     views) and the cover set (`cover_keys`: every row type, geometry table
     spec and occ_geom pairing the renderer's switch space reaches, forms
     (a) and (c) at 2, 4 and 8 views), with --all-keys also the other keys
     of that space (`reachable_kernel_keys`, 336 in all); the quad-lerp
     kernels and the row gather (one nvcc each, up to 6 per core at once);
     each library's ptxas registers and spills, blocks per SM, threads and
     shared memory per block;
  2. each kernel against its plain PyTorch version on the card: seeded
     random inputs (the quad lerps at a ragged P for int8 and float32 rows
     and the row gather at the microbenchmark's shape, bitwise; the keys
     beyond FORMS at the fast mode's P = 319,488, timed beside their
     bounds, with --all-keys written to results/chip_smoke/all_keys.json), then
     the inputs captured from one rendered frame at the main-path shape
     (the point-stage plain version runs in chunks of points);
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
  3n. the shipped `tpu.matmul_dtype bfloat16` on real bf16 tensors: the
     fast (3 frames), reference (2) and op-by-op fast (1) modes in bf16
     and, in the same call, in float32, each with its kernel launches, zero
     ray / sigma / rgb overflows, PSNR >= 20 dB, ms per frame and the
     encoder's ms from CUDA events on one line per mode, and bf16 feature
     maps; `render_demo_scan_fn` over the 3 fast frames, its counters and
     checksums equal to the per-frame loop's, and its ms per frame beside
     the loop's over 5 calls each in turns (min / median / max; with
     --profile a trace of one call of each); the native 128^2 fast frame
     on the card against the CPU. The kernel keys
     the bf16 renders reach are those of phases 3-3k, each held against
     its plain version there (the `@bf16` FORMS take the bf16 (P, F)
     feature); `--all-keys` holds every key of the switch space, the 192
     that bf16 reaches among them;
  3d. the paper configs' projection tables (split, under the tight cull) on
     3 frames with per-frame CUDA-event times, and one frame each of the
     other table choices and switch pairs, every point-stage instantiation
     held against its plain version on its frame's captured inputs:
     merge_src_feat and quantize_proj off (merged: a:bf16; split:
     c:u8/bf16), sigma_query_cull in the fast mode (a+e; split tables c+e),
     int4_feat on split tables (c+d), the reference mode's frame_mode +
     int4_feat (c+d+e), int4_feat + kernel_octet off (b+c+d) and merged
     tables (a), float source images (c:bf16/i8), and under float32
     merge_src_feat (a:f32), quantize_proj off (c:u8/f32) and float
     sources (c:f32/i8);
  3g. the geometry-table switches (ops/point_stages.GEOMS): one frame of the
     fast mode (form (a)) per switch value, coarse_nearest 1 and 0,
     fold_coarse_fc off, merge_coarse_octet off, l1_nearest 1, 2 and 11,
     int4_coarse, pack_octet_u32, dense_conv, quantize_volume off (and
     under float32); one frame of each in-kernel layout under the paper
     tables (form (c)); l1_nearest 1 with sigma_query_cull (a+e): each
     frame's PSNR, overflows, colored points, ms per frame and the form
     launched, its library held against plain on the captured inputs,
     timed beside its bound;
  3h. the global sigma compaction (dense_slots off) on 3 frames each: at
     configs/synthetic.yaml's caps (sig_cap 294,912 against 319,488 slots),
     every frame without a drop equal to phase 3's dense-slot frame; at
     sigma_cap 98304, which must overflow on every frame (PSNR beside the
     uncapped frames'); and the blanket cull with samples_per_ray 32 < 64,
     dense and compacted (equal where nothing drops): overflows, counts,
     PSNR, ms per frame and form (a) or (c) held against its plain version
     on each path's captured inputs and timed beside its bound;
  3w. the windowed occupancy tap: 3 frames of the fast mode without splat
     bins (the tap over 32 grid samples from each ray's front depth), one
     frame each of its frame_mode (a+e; held to 15 dB, as JAX's semantics
     lose 3.3 dB there), sigma_query_cull (a+e) and dense_slots off, and
     of the blanket cull with tap_window 32 and samples_per_ray 32 (form
     c): overflows, PSNR >= 20 dB, ms per frame,
     one launch per frame under the key named, the library against plain
     on frame 0's captured inputs; one neg-ray frame without bins (window
     off) in phase 3c; a 128^2 windowed frame on the card and on the CPU
     with equal integers;
  3m. the mesh path (`head.rgb.use_rgbhead False`, float32): both
     renderers' `render_mesh` on bench frame 0 at the config's voxel size
     (grid points and chunks, device ms of the volume stage and of the
     chunk loop, host ms of marching cubes, a non-empty mesh), their
     thresholded alpha clouds interleaving within 2 voxels, and each
     renderer's alpha cube at 128^2 and 0.02 m on the card against the
     CPU's;
  3n. Neural Body's point-network kernel (csrc/nbody_points.cu) on frame 0
     of the cell `nbody-zju-views` (its seeded scene, poses and checkpoint):
     one request through `render_demo` launches it once; its raw against
     the plain version's on the same inputs (error over each channel's
     range: mean < 1e-5, largest < 1e-2); CUDA-event times of the kernel,
     the plain version and the torch path it replaced, beside its bound;
  3k. switch sets and view counts whose kernel is built from the key: 3
     frames each of the paper tables with sigma_query_cull and
     coarse_nearest 0 (c+e@coarse-octet) and of merge_src_feat with
     sigma_query_cull (a:bf16+e), one frame each of l1_nearest 1 with
     coarse_nearest 0 (a mixed geometry layout) and quantize_proj off with
     coarse_nearest 0 (merged bf16 rows beside the coarse octet table), all
     >= 20 dB; the fast mode at 4 views (3 frames), 2 and 8 (1 each) with
     the checkpoint's heads and a seeded first rgb_fc layer (no PSNR gate),
     frame 0 against the op-by-op render of the same weights on the card
     (integers bitwise, |d pred| median <= 2e-3); each key's library held
     against plain on its frame's captured inputs and timed;
  3b. the op-by-op point stages (pallas_point off): 3 frames of the fast
     mode through the quad-lerp kernel (exactly one launch per frame, no
     point-stage launch), held against the fused fast mode's image; the
     kernel on the frame's captured rows against plain and against its flat
     channel-major twin, bitwise; one frame each of the torch-op routes
     (pallas_lerp off, proj_vp_order) and of the op-by-op reference mode;
     one frame under merge_src_feat, whose bf16 rows go through the
     quad-lerp kernel (bitwise against plain, timed);
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
  5b. bf16 mixed-precision training (`tpu.train_dtype bfloat16`: float32
     parameters, bf16 convolutions and Dense layers on real bf16 tensors):
     phase 5's 3 + 20 steps, s/it and peak memory beside phase 5's float32
     figures, its checks (every parameter still float32), the eval PSNR
     and `Trainer.evaluate` of the bf16-trained weights through the
     progressive renderer (form (a), {"a": 2} launches); `--profile` adds
     the bf16 step's kernel table; a `Trainer.train` epoch of 2 batches of
     2 frames (`dataset.img_num_per_gpu 2`); a 128^2 bf16 step on the card
     against the CPU, and the same comparison stage by stage (encoder,
     sparse stack, heads: outputs and gradients, bf16 and float32);
     tools/train_bench_torch.py --iters 10 for float32 and bfloat16, each in
     a process of its own;
  6. the inference CLI (tools/inference_torch.py) in a process of its own
     on configs/synthetic.yaml with the trained checkpoint: exit 0 and PSNR
     >= 20 dB;
  7. the checkpoint with spconv 2.x's sparse weight layout, loaded onto the
     card strict and as a resume, bitwise the 1.2.1 file's state; the tools:
     tools/quality_sweep_torch.py's sweep over the 3 bench frames (every
     key, >= 20 dB), one profiled request of bench frame 0 holding every
     render span and counter of utils/profiling.py, device_memory_stats, and
     tools/profile_demo_torch.py --async in a process of its own; data
     parallelism in two processes (this script with --dp-worker; NCCL, one
     rank per card, on a box of two cards or more, else gloo with both ranks
     on the one card): one DP train step at full width from the checkpoint,
     the ranks' parameters bitwise equal and within the step test's
     tolerance of one process averaging the two frames' gradients, its s/it
     beside phase 5's; the 2-rank progressive render of bench frame 0
     against the single-process one (integers bitwise, colors within 1e-4,
     kernel 1 launched on each rank);
  7d. the diagnostic tools, each in a process of its own on 2 bench frames
     at 512^2: tools/diag_ref_mode_torch.py (exit 0, the JAX tool's keys,
     each frame's bands within its mask_at_box; the phase renders both
     modes of the same frames itself, and in each mode the bands' squared
     error plus that of the pixels neither mode covers must equal the
     frame's over mask_at_box), tools/diag_ref_points_torch.py (exit 0, P
     the reference frame's, the seven op times positive) and
     tools/trace_demo_torch.py (exit 0, kernel 1 among its top rows); their
     kernel-1 launches join the kernels line;
  8. the port's bench, bench_torch.py, in a process of its own at its full
     protocol (10 bench frames at 512^2; the fast, reference-semantics and
     neg-ray modes): exit 0, one bare JSON fast line, in every mode of its
     record (BENCH_MODES_torch.json) zero ray, sigma and rgb overflows,
     PSNR >= 20 dB and kernel 1 launched once per frame, `mfu` within (0,
     1]; its three lines printed with the card's name and power limit;
  8r. the roofline: tools/roofline_torch.py in a process of its own on 2
     bench frames (8 with --profile): exit 0, a row for each of the 14
     stop stages and the whole render plus the production row, every
     delta_GB >= 0, every share of the HBM roof in (0, 100]; bench frame
     0's fast render counted (utils/roofline.py) on the card and on the
     CPU, bytes and FLOPs equal or within 1% with the differing ops
     printed; phase 8's fast line carrying `roofline` with `pct_hbm_roof`
     in (0, 100]; its lines with the card's name and power limit;
  9. one JSON line listing the kernels, the card's name and power limit,
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

from bench_torch import REF_MODE  # the bench's reference-semantics mode
from gpnerf_tpu_torch.utils import roofline

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "artifacts", "bench_ckpt.pth")
# the H100 SXM's published peaks (utils/roofline.py): HBM3, dense bf16
# tensor cores, float32 outside the tensor cores
HBM_BYTES_PER_S = roofline.HBM_BYTES_PER_S[roofline.H100]
BF16_FLOP_PER_S = roofline.PEAK_FLOP_PER_S[(roofline.H100, "bfloat16")]
F32_FLOP_PER_S = roofline.PEAK_FLOP_PER_S[(roofline.H100, "float32")]


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


def events_ms(fn):
    """Milliseconds of one call of `fn()` between CUDA events, the device
    idle before it."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def compare_point_stages(kern, plain, what, max_outliers=0):
    """Hold the kernel's (alpha, rgb[, occm]) against the plain version's
    with the tolerances of tests/test_pallas_point.py:83-103, every point
    within the per-point bounds (alpha, rgb, alive where the other side's
    alpha is decisive) but `max_outliers` of them for each; the occupancy
    verdict must agree exactly. Returns stats."""
    import torch

    a, rgb = kern[:2]
    a_ref, rgb_ref = plain[:2]
    check(len(kern) == len(plain), f"{what}: output count")
    check(torch.isfinite(a).all() and torch.isfinite(rgb).all(), f"{what}: non-finite")
    da = (a - a_ref).abs()
    outliers = int((~(da <= 0.08 + 0.3 * a_ref.abs())).sum())
    check(outliers <= max_outliers, f"{what}: alpha beyond atol 0.08 rtol 0.3 at {outliers} points")
    check(float(da.mean()) < 5e-3, f"{what}: mean |d alpha| {float(da.mean())}")
    alive, alive_ref = a > 1e-14, a_ref > 1e-14
    agree = alive == alive_ref
    flips = int((~agree).sum())
    check(flips < 0.01 * a.numel(), f"{what}: {flips} alive-boundary flips")
    dr = (rgb - rgb_ref).abs()[agree]
    rgb_outliers = int((~(dr <= 0.08)).any(dim=-1).sum())
    check(rgb_outliers <= max_outliers, f"{what}: rgb beyond atol 0.08 at {rgb_outliers} points")
    check(float(dr.mean()) < 5e-3, f"{what}: mean |d rgb| {float(dr.mean())}")
    decisive = int((~alive[a_ref > 0.05]).sum() + (~alive_ref[a > 0.05]).sum())
    check(decisive <= max_outliers, f"{what}: {decisive} decisively-alive points disagree")
    stats = {
        "max_abs_d_alpha": float(da.max()), "mean_abs_d_alpha": float(da.mean()),
        "max_abs_d_rgb": float(dr.max()), "mean_abs_d_rgb": float(dr.mean()),
        "alive_flips": flips, "points": a.numel(),
    }
    if max_outliers:
        stats["outliers"] = outliers + rgb_outliers
    if len(kern) == 3:
        check(bool((kern[2] == plain[2]).all()), f"{what}: occupancy verdicts differ")
        stats["occ_pass_share"] = float(kern[2].mean())
    log(f"# {what}: " + json.dumps(stats))
    return stats


def cover_keys():
    """Point-stage keys beyond FORMS that phase 1 builds and phase 2a holds
    against plain, so that with FORMS every projection row type stands in
    table position A and B, every geometry table spec the renderer's switch
    space reaches (`reachable_kernel_keys`) stands in every table position
    where it occurs there, occ_geom meets every table-0 spec, and forms (a)
    and (c) run at 2, 4 and 8 views (tests/test_torch_point_keys.py checks
    the cover). Phase 3k renders five of them."""
    from gpnerf_tpu_torch.ops.point_stages import Key

    bf4, f4 = ((8, 32, "bf16"),) * 4, ((8, 32, "f32"),) * 4
    return [
        *(Key(("i8",), "default", False, v) for v in (2, 4, 8)),
        *(Key(("u8", "i8"), "default", False, v) for v in (2, 4, 8)),
        Key(("i8",), "feats128", False, 8),  # F = 128 at 8 views: 7 warps fit
        Key(("u8", "i8"), "coarse-octet", True),
        Key(("bf16",), "default", True),
        Key(("i8",), ((1, 32, "u8"), (8, 64, "i8")), False),
        Key(("bf16",), "coarse-octet", False),
        Key(("u8", "f32"), "l1-nearest", False),
        Key(("f32",), "float32", True),
        Key(("bf16", "i4"), "default", False),
        Key(("i8",), "float", True),
        Key(("i8",), bf4, False),
        Key(("f32", "f32"), f4, False),
        Key(("i8",), ((8, 32, "bf16"), (8, 96, "f32")), False),
        Key(("u8", "u8"), "default", False),  # u8 feature rows: no switch forms them
    ]


SWITCHES = ("tight_cull", "frame_mode", "sigma_query_cull", "int4_feat", "kernel_octet",
            "merge_src_feat", "merge_lowres_src", "quantize_proj", "quantize_volume",
            "merge_coarse_octet", "fold_coarse_fc", "int4_coarse", "pack_octet_u32", "dense_conv")


def reachable_kernel_keys():
    """Every point-stage key (3 views) the Renderer constructor's switches
    select: the boolean SWITCHES, coarse_nearest 0-2, l1_nearest 0, 1, 2
    and 11, bfloat16 or float32, uint8 or float source images (336 keys,
    ~50 s of host time)."""
    import itertools

    import torch

    from gpnerf_tpu_torch.render.demo import Renderer

    keys = set()
    for bits in itertools.product((False, True), repeat=len(SWITCHES)):
        sw = dict(zip(SWITCHES, bits))
        for cn, l1, dt in itertools.product((0, 1, 2), (0, 1, 2, 11), (torch.bfloat16, None)):
            r = Renderer(None, None, voxel_size=(0.005,) * 3, n_samples=64,
                         samples_per_ray=13 if sw["tight_cull"] else 64, compute_dtype=dt,
                         coarse_nearest=cn, l1_nearest=l1, **sw)
            keys.update((r.kernel_form(True), r.kernel_form(False)))
    return sorted(keys, key=str)


def build_point_keys(keys, jobs=32):
    """Build every key's libraries from csrc/point_stages.cu, the rows entry
    and the tables entry (`fetch`), `jobs` nvcc processes at a time, and
    load them; returns the seconds taken."""
    from gpnerf_tpu_torch.ops import point_stages as ps

    t0 = time.perf_counter()
    todo, running = [(k, f) for k in keys for f in (False, True)], []
    while todo or running:
        while todo and len(running) < jobs:
            key, fetch = todo.pop(0)
            running.append((key, fetch, ps.start_build(key, fetch)))
        done = [(k, f, p) for k, f, p in running if p is None or p.poll() is not None]
        if not done:
            time.sleep(0.05)
        for k, f, p in done:
            running.remove((k, f, p))
            ps.load_library(k, p, fetch=f)
    return time.perf_counter() - t0


def log_builds(keys):
    """Each key's ptxas registers / spills and its blocks per SM, threads
    and shared memory per block; fails where no block fits. Returns
    {name: {...}}."""
    from gpnerf_tpu_torch.ops import point_stages as ps

    out = {}
    for key in keys:
        name = ps.form_name(key)
        entry = {"ptxas": [line.strip() for line in ps.BUILD_LOG.get(key, {}).get("output", "")
                           .splitlines() if "registers" in line or "spill" in line],
                 "ptxas_tables_entry": [
                     line.strip() for line in ps.BUILD_LOG.get((key, True), {}).get("output", "")
                     .splitlines() if "registers" in line or "spill" in line]}
        entry["blocks_per_sm"], entry["smem_bytes"], entry["threads"] = ps.occupancy(key)
        for line in entry["ptxas"]:
            log(f"#   ptxas [{name}] {line}")
        for line in entry["ptxas_tables_entry"]:
            log(f"#   ptxas [{name}, tables entry] {line}")
        check(ps.occupancy(key, fetch=True) == (entry["blocks_per_sm"], entry["smem_bytes"],
                                                 entry["threads"]),
              f"point_stages[{name}]: the tables entry's occupancy differs from the rows entry's")
        log(f"#   occupancy [{name}] {entry['blocks_per_sm']} block(s) per SM of "
            f"{entry['threads']} threads, {entry['smem_bytes']} bytes of dynamic shared memory "
            "per block")
        check(entry["blocks_per_sm"] >= 1,
              f"point_stages[{name}]: no block fits on an SM ({entry['blocks_per_sm']})")
        out[name] = entry
    return out


def make_views_render(size, matmul_dtype, device, views, **tpu):
    """make_render at `views` source views (cam_num -1: the datasets offer
    every training camera): the trained checkpoint, with rgb_fc's first
    layer (views * 32 -> 32) seeded (normal, std 1 / sqrt(fan-in), as flax
    initialises Dense kernels) where the checkpoint's 3 views do not fit."""
    import torch

    from gpnerf_tpu_torch.registry import get

    cfg = make_cfg(size, matmul_dtype)
    cfg.defrost()
    cfg.src_view_num = views
    cfg.cam_num = -1
    for k, v in tpu.items():
        cfg.tpu[k] = v
    cfg.freeze()
    render = get("render", cfg.render.file)(cfg, device=device)
    ckpt = torch.load(CKPT, map_location="cpu", weights_only=False)
    state = dict(ckpt["state_dict"] if "state_dict" in ckpt else ckpt)
    if views != 3:
        g = torch.Generator().manual_seed(views)
        state["nerfhead.rgbhead.rgb_fc.0.weight"] = (
            torch.randn(32, views * 32, generator=g) / math.sqrt(views * 32))
    render.load_state_dict(state, strict=True)
    return cfg, render


def head_weights_of(render):
    """{F: PointWeights} of a render's heads: the sigma-feat weight of a
    96-wide geometry feature (folded coarse table) and of a 128-wide one
    (the checkpoint's own)."""
    from gpnerf_tpu_torch.ops import point_stages as ps

    nch = render.nerfhead.spconv_out_dim[0]
    return {96: ps.pack_head_weights(render.nerfhead, fold_nch=nch),
            128: ps.pack_head_weights(render.nerfhead)}


def random_point_inputs(form, P, device, seed=0):
    """Seeded random inputs of one instantiation (a
    gpnerf_tpu_torch.ops.point_stages.Key, or a tuple of its fields) at P
    points, made on the device. Returns (tabs, feats, vmask, sig_ok,
    kwargs)."""
    import torch

    from gpnerf_tpu_torch.ops.point_stages import C, CF, CS, geom_specs, make_key

    rows, layout, occ, V = make_key(*form)
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*s):
        return torch.rand(*s, generator=g, device=device)

    def ints(lo, hi, *s, dtype):
        return torch.randint(lo, hi, s, generator=g, device=device, dtype=dtype)

    def w4():
        return rand(V, 4, P) * (rand(V, 4, P) > 0.1)

    def table(kind, Ct):
        """(rows, w4, scale) of one projection table of Ct channels."""
        if kind == "i8":
            return ints(-127, 128, V * P, 4 * Ct, dtype=torch.int8), w4(), 0.02 + rand(Ct) * 0.05
        if kind == "i4":
            return ints(0, 256, V * P, 2 * Ct, dtype=torch.uint8), w4(), 0.02 + rand(Ct) * 0.05
        if kind == "u8":
            return (ints(0, 256, V * P, 4 * Ct, dtype=torch.uint8), w4(),
                    torch.full((Ct,), 1.0 / 255.0, device=device))
        vals = torch.randn(V * P, 4 * Ct, generator=g, device=device) * 0.5
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        return vals.to(dt), w4(), torch.ones(Ct, device=device)

    tabs = (table(rows[0], C),) if len(rows) == 1 else (table(rows[0], CS), table(rows[1], CF))
    kw, feats = {}, None
    specs = geom_specs(layout)
    if specs[0][2] in ("feat", "feat-bf16"):
        feats = torch.randn(P, specs[0][1], generator=g, device=device) * 0.5
        if specs[0][2] == "feat-bf16":
            feats = feats.to(torch.bfloat16)
    else:
        geom = []
        for i, (taps, ch, kind) in enumerate(specs):
            if kind in ("u8", "i8"):
                lo, hi, dt = (0, 256, torch.uint8) if kind == "u8" else (-127, 128, torch.int8)
                rows_g, sc = ints(lo, hi, P, taps * ch, dtype=dt), 0.01 + rand(ch) * 0.03
            else:  # float rows, unit scale
                rows_g = rand(P, taps * ch) * 0.5
                rows_g, sc = rows_g.to(torch.bfloat16 if kind == "bf16" else torch.float32), \
                    torch.ones(ch, device=device)
            if occ and i == 0:  # empty level-1 cells, so the occupancy cull bites
                rows_g = rows_g * (rand(P, 1) > 0.4).to(rows_g.dtype)
            w = rand(taps, P)
            w = w / w.sum(0) if taps > 1 else (w > 0.05).float()
            geom.append((rows_g, w, sc))
        kw["geom_tabs"] = tuple(geom)
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


def point_stage_cost(call):
    """(bytes, bound ms, bound_by) of one point-stage call: its declared
    cost (ops/point_stages.py `cost`: each input read once and each output
    written once) over HBM; the MLP FLOPs at the bf16 tensor-core rate plus
    the f32 lerps (`op_counts`), whichever bound is larger."""
    from gpnerf_tpu_torch.ops import point_stages as ps

    tabs, feats, vmask, sig_ok, weights, kw = call
    nbytes, _ = ps.cost(tabs, feats, vmask, sig_ok, weights, **kw)
    mma, f32 = ps.op_counts(tabs, vmask, weights, kw.get("geom_tabs", ()))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = mma / BF16_FLOP_PER_S + f32 / F32_FLOP_PER_S
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    return nbytes, max(t_bytes, t_ops) * 1e3, bound_by


def same_bits(a, b):
    """Bitwise equality of two tensors of one float dtype (plain equality
    of integer tensors)."""
    import torch

    if not a.is_floating_point():
        return a.dtype == b.dtype and bool(torch.equal(a, b))
    bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        torch.equal(a.contiguous().view(bits), b.contiguous().view(bits)))


def lerp_cost(rows, w4, scale, out):
    """(bytes, bound ms, bound_by) of one quad lerp: its declared cost
    (ops/quad_lerp.py `cost`: inputs read and output written once) over
    HBM; its float32 operations at the float32 rate."""
    from gpnerf_tpu_torch.ops import quad_lerp as ql

    nb, ops = ql.cost(rows, w4, scale, out.dtype)
    t_bytes, t_ops = nb / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
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


def profile_render(fn, batches, card, frame_ms, frames_per_call=1, what=None):
    """torch.profiler over one pass of `fn` over `batches` (each call
    renders `frames_per_call` frames): device time by kernel (device-side
    events only) and the device's idle share against the unprofiled frame
    time, printed per frame."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gpnerf_tpu_torch.utils.profiling import kernel_table

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches:
            fn(b)
        torch.cuda.synchronize()
    n = len(batches) * frames_per_call
    rows = kernel_table(prof)
    busy = sum(ms for _, ms, _ in rows) / n
    lines = [f"# profile on {card}{f' of {what}' if what else ''}: kernels busy {busy:.3f} ms per frame of "
             f"{frame_ms:.3f} ms, idle share {1.0 - busy / frame_ms:.3f}; "
             f"{sum(c for _, _, c in rows) / n:.0f} kernel launches per frame; "
             "by kernel (ms per frame, launches per frame):"]
    # host-device synchronizations inside one frame (each drains the queue)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn(batches[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught) / frames_per_call
    lines.insert(1, f"# profile: {syncs:g} synchronizing calls per frame "
                    "(torch.cuda.set_sync_debug_mode)")
    for name, ms, count in rows:
        lines.append(f"#   {ms / n:9.4f} ms {count / n:6.1f}x  {name[:110]}")
    for line in lines[:41]:
        log(line)


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


def card_vs_cpu_128(name, max_tol, exact=False, dtype="float32", med_tol=2e-3, share_tol=1e-3,
                    **tpu):
    """The same 128^2 frame on the card and on the CPU (plain versions),
    float32 config (or `dtype`): masks, counts and images must agree (|d|
    median < med_tol, at most share_tol of the values beyond 0.05, none
    beyond max_tol); with `exact` the ray set, the overflows and the ray
    and sigma-slot counts must be equal."""
    import numpy as np
    import torch

    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render.base import batch_to_device

    outs = {}
    for d in ("cuda", "cpu"):
        cfg_s, r = make_render(128, dtype, d, **tpu)
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
    if exact:
        for k in ("mask_at_box", "ray_pix_idx", "overflows"):
            check(torch.equal(g[k], c[k]), f"128^2 {name} card vs CPU: {k} differ")
        check(torch.equal(g["counts"][:2], c["counts"][:2]),
              f"128^2 {name} card vs CPU: ray or sigma-slot counts differ")
        log(f"# 128^2 {name} card vs CPU: ray set, overflows and ray and slot counts equal")
    check(int(g["overflows"][0]) == 0, f"128^2 {name}: ray overflow")
    n_s, n_c = int(g["counts"][1]), int(c["counts"][1])
    check(abs(n_s - n_c) <= 0.001 * n_c, f"128^2 {name} card vs CPU: sample counts differ")
    check(float(d_img.median()) < med_tol and float((d_img > 0.05).float().mean()) <= share_tol
          and float(d_img.max()) < max_tol, f"128^2 {name} card vs CPU: images differ")


def native_phase(card, batches, host, profile=False):
    """Phase 3n: the shipped `tpu.matmul_dtype bfloat16` on real bf16
    tensors. The fast mode (3 frames), the reference mode (2) and the
    op-by-op fast mode (1), each in bf16 and, in the same call, in float32:
    zero ray, sigma and rgb overflows, PSNR >= 20 dB, the kernels launched,
    ms per frame and the encoder's ms from CUDA events; the bf16 encoder's
    output a bf16 tensor. `render_demo_scan_fn` over the 3 fast frames
    against the per-frame loop, and its ms per frame; the native fast
    render at 128^2 on the card against the CPU."""
    import torch

    from gpnerf_tpu_torch.ops import point_stages as ps
    from gpnerf_tpu_torch.ops import quad_lerp as ql
    from gpnerf_tpu_torch.render.demo import frame_checksum, stack_frames

    rows = {}
    for title, n, extra in (("fast mode", 3, {}), ("reference mode", 2, REF_MODE),
                            ("op-by-op fast mode", 1, {"pallas_point": False})):
        for dtype in ("bfloat16", "float32"):
            r = make_render(512, dtype, "cuda", **extra)[1]
            fn = r.render_demo_fn()
            fn(batches[0])
            torch.cuda.synchronize()
            ps.LAUNCHES.clear()
            ql.LAUNCHES.clear()
            rets = [fn(b) for b in batches[:n]]
            torch.cuda.synchronize()
            launches = {**ps.LAUNCHES, **ql.LAUNCHES}
            want = "quad_lerp_rows_vcp" if "op-by-op" in title else ps.form_name(r.kernel_form())
            check(launches == {want: n}, f"3n {title} {dtype}: launches {launches}, expected "
                                         f"{n} of {want}")
            psnrs = []
            for i, (ret, hb) in enumerate(zip(rets, host)):
                ov = ret["overflows"].tolist()
                check(ov[0] == 0 and ov[2] == 0 and ov[3] == 0, f"3n {title} {dtype} frame {i}: "
                                                                 f"overflows {ov}")
                check(bool(torch.isfinite(ret["pred_chw"]).all()), f"3n {title} {dtype}: non-finite")
                psnrs.append(psnr_of(ret, hb))
                check(psnrs[-1] >= 20.0, f"3n {title} {dtype} frame {i}: PSNR {psnrs[-1]:.3f} dB")
            enc = r.encode_fn()(batches[0]["src_imgs"])
            check(enc.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32),
                  f"3n {title} {dtype}: feature maps {enc.dtype}")
            it = iter(range(10**9))
            frame_ms = cuda_ms(lambda: fn(batches[next(it) % n]), 3 * n)
            enc_ms = cuda_ms(lambda: r.encode_fn()(batches[next(it) % n]["src_imgs"]), 3 * n)
            rows[title, dtype] = (frame_ms, enc_ms, psnrs, launches)
            log(f"# 3n {title}, matmul_dtype {dtype}: launches {json.dumps(launches)}, PSNR "
                + " ".join(f"{p:.3f}" for p in psnrs) + " dB, overflows "
                + json.dumps([ret["overflows"].tolist() for ret in rets]))
            if title == "fast mode" and dtype == "bfloat16":
                order = torch.arange(n, device=batches[0]["src_imgs"].device)
                scan = r.render_demo_scan_fn()
                stacked = stack_frames(batches[:n])
                out = scan(stacked, order)
                for i, ret in enumerate(rets):
                    check(torch.equal(out["overflows"][i], ret["overflows"])
                          and torch.equal(out["counts"][i], ret["counts"]),
                          f"3n render_demo_scan_fn frame {i}: counters differ from the loop's")
                    want_ck = frame_checksum(ret)
                    check(abs(float(out["checksum"][i] - want_ck)) <= 1e-5 * abs(float(want_ck)),
                          f"3n render_demo_scan_fn frame {i}: checksum differs from the loop's")
                # the sequence entry against the loop over the same frames, in
                # turns, one CUDA-event pair around each call
                scan_ms, loop_ms = [], []
                for _ in range(5):
                    loop_ms.append(events_ms(lambda: [fn(b) for b in batches[:n]]) / n)
                    scan_ms.append(events_ms(lambda: scan(stacked, order)) / n)
                spread = lambda v: " / ".join(f"{x:.3f}" for x in sorted(v)[::2])  # noqa: E731
                log(f"# 3n render_demo_scan_fn over the {n} fast frames: overflows, counts and "
                    f"checksums equal the loop's; on {card}, ms/frame min / median / max over 5 "
                    f"calls each, in turns: scan {spread(scan_ms)}, loop {spread(loop_ms)} "
                    "(CUDA events)")
                if profile:
                    profile_render(lambda _: [fn(b) for b in batches[:n]], [None], card,
                                   sorted(loop_ms)[2], frames_per_call=n,
                                   what=f"the loop over the {n} fast frames")
                    profile_render(lambda _: scan(stacked, order), [None], card,
                                   sorted(scan_ms)[2], frames_per_call=n,
                                   what=f"render_demo_scan_fn over the {n} fast frames")
            del r, fn, rets
            torch.cuda.empty_cache()
        (b_ms, b_enc, b_psnr, _), (f_ms, f_enc, f_psnr, _) = rows[title, "bfloat16"], rows[title, "float32"]
        log(f"# timing on {card}: 3n {title}, the same call: native bf16 {b_ms:.3f} ms/frame, encoder "
            f"{b_enc:.3f} ms, mean PSNR {sum(b_psnr) / len(b_psnr):.3f} dB; float32 {f_ms:.3f} "
            f"ms/frame, encoder {f_enc:.3f} ms, mean PSNR {sum(f_psnr) / len(f_psnr):.3f} dB "
            f"(CUDA events, {3 * len(b_psnr)} renders)")
    card_vs_cpu_128("native bf16 fast mode", 0.15, dtype="bfloat16", med_tol=8e-3, share_tol=5e-3,
                    ray_cap=16384)
    return rows


def mesh_cfg(size, voxel=None):
    """make_cfg's float32 config with the mesh branch on (`use_rgbhead`
    off: the datasets add the visual-hull grid), at `voxel` m if given."""
    cfg = make_cfg(size, "float32")
    cfg.defrost()
    cfg.head.rgb.use_rgbhead = False
    if voxel is not None:
        cfg.dataset.voxel_size = [voxel] * 3
    cfg.freeze()
    return cfg


def timed_render_mesh(render, batch):
    """render_mesh with CUDA events around its volume stage and its chunk
    loop (to the alpha cube on the host) and the host clock around marching
    cubes. Returns (output, volume ms, chunk-loop ms, marching-cubes ms)."""
    import torch

    from gpnerf_tpu_torch.render import base as base_mod
    from gpnerf_tpu_torch.render import demo as demo_mod

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    mc_ms = []
    demo = hasattr(render, "mesh_frame")
    mod = demo_mod if demo else base_mod
    real_volume = render.mesh_frame if demo else base_mod.mesh_volume
    real_extract = mod.mesh_from_alpha

    def volume(*a, **kw):
        ev[0].record()
        out = real_volume(*a, **kw)
        ev[1].record()
        return out

    def extract(alpha, th):
        ev[2].record()
        t0 = time.perf_counter()
        out = real_extract(alpha, th)
        mc_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    if demo:
        render.mesh_frame = volume
    else:
        base_mod.mesh_volume = volume
    mod.mesh_from_alpha = extract
    try:
        out = render.render_mesh(batch)
    finally:
        mod.mesh_from_alpha = real_extract
        if demo:
            del render.mesh_frame
        else:
            base_mod.mesh_volume = real_volume
    torch.cuda.synchronize()
    return out, ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]), mc_ms[0]


NBODY_CELL, NBODY_SEED = "nbody-zju-views", 2147527001


def nbody_phase(card):
    """Phase 3n: Neural Body's point-network kernel on frame 0 of its
    cell; returns its `kernels` entry."""
    import torch

    from benchmark import pool, system
    from benchmark.harness import Spec
    from gpnerf_tpu_torch.ops import nbody_points as nbp
    from gpnerf_tpu_torch.ops.rays import sample_z_vals

    dev = torch.device("cuda")
    spec = Spec(NBODY_CELL)
    cfg = spec.conf["cfg"]
    scene = pool.new_scene(cfg)
    poses, cams = pool.view_items(NBODY_SEED, spec.traffic["pool"], pool.img_hw(cfg))
    ds = pool.make_dataset(system.data_layer(), scene, poses, cams, "test", cfg)
    batch = system.to_device(pool.build_batches(ds, NBODY_SEED, [0], pool.VIEW_TAG)[0], dev)
    render = system.views_program(spec.conf, dev)
    nbp.LAUNCHES.clear()
    img = render.render_demo_fn()(batch)["pred_chw"]
    torch.cuda.synchronize()
    launches = nbp.LAUNCHES["nbody_points"]
    check(launches == 1 and bool(torch.isfinite(img).all()),
          f"{NBODY_CELL}: a request launched the point-network kernel {launches} times")
    n, S = int(batch["n_rays"]), render.n_samples
    with torch.no_grad():
        vols = render._volume(batch)
        z_vals = sample_z_vals(batch["near"][:n], batch["far"][:n], S, perturb=False)
        args = (render.net, vols, batch, batch["ray_o"][:n], batch["ray_d"][:n], z_vals,
                render.net.latent_row(batch["latent_index"]), render.voxel_size)
        # the replaced path: the same torch ops on contiguous channels-first volumes
        parent_args = (render.net, [v.contiguous() for v in vols], *args[2:])
        got = nbp.nbody_points(*args)
        want = nbp.nbody_points_plain(*args, render.chunk_rays)
        scale = want.abs().flatten(0, 1).amax(dim=0).clamp_min(1e-6)
        rel = ((got - want).abs() / scale).flatten(0, 1)
        mean_err, max_err = rel.mean(dim=0).tolist(), rel.amax(dim=0).tolist()
        check(bool(torch.isfinite(got).all()) and max(mean_err) < 1e-5 and max(max_err) < 1e-2,
              f"nbody_points against plain on {NBODY_CELL} frame 0: error over each channel's "
              f"range mean {mean_err}, largest {max_err}")
        check(torch.equal(nbp.nbody_points_plain(*parent_args, render.chunk_rays), want),
              "nbody_points_plain differs from the replaced path")
        k_ms = cuda_ms(lambda: nbp.nbody_points(*args), 20)
        p_ms = cuda_ms(lambda: nbp.nbody_points_plain(*args, render.chunk_rays), 5)
        lib_ms = cuda_ms(lambda: nbp.nbody_points_plain(*parent_args, render.chunk_rays), 5)
    nbytes, flops = nbp.cost(vols, n, S)
    flops_ms, bytes_ms = flops / BF16_FLOP_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = max(flops_ms, bytes_ms), "flops" if flops_ms >= bytes_ms else "bytes"
    log(f"# nbody_points vs plain on {NBODY_CELL} frame 0 (seed {NBODY_SEED}, {n} rays x {S} "
        f"samples): error over each channel's range (rgb, sigma) mean {mean_err}, largest "
        f"{max_err}")
    log(f"# timing on {card}: nbody_points kernel {k_ms:.3f} ms at P={n * S} "
        f"({flops / k_ms * 1e-9:.1f} TFLOP/s), plain {p_ms:.3f} ms, replaced torch path "
        f"{lib_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
        f"{nbp.load_library().nbody_points_smem_bytes()} B dynamic shared memory a block")
    return {
        "name": "nbody_points", "route": "cuda", "source": "gpnerf_tpu_torch/csrc/nbody_points.cu",
        "replaces": None,  # the JAX package has no Neural Body
        "launches": launches, "max_abs_err": float((got - want).abs().max()),
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": lib_ms,  # the torch path the kernel replaced (cuBLAS, grid_sample)
    }


def mesh_phase(card):
    """Phase 3m: both renderers' mesh paths (`render_mesh`, use_rgbhead
    off) on bench frame 0 at 512^2 and the config's voxel size, float32,
    with the trained checkpoint: grid points and chunks, device ms of the
    volume stage and of the chunk loop, host ms of marching cubes, a
    non-empty mesh from each; the two thresholded alpha clouds interleave
    (median nearest distance below 2 voxels, tests/test_mesh_path.py);
    then the card's alpha cubes at 128^2 and a 0.02 m voxel against the
    CPU's."""
    import numpy as np
    import torch
    from scipy.spatial import cKDTree

    from gpnerf_tpu_torch.ops import point_stages as ps
    from gpnerf_tpu_torch.ops import quad_lerp as ql
    from gpnerf_tpu_torch.ops import row_gather as rg
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render.base import batch_to_device, mesh_volume
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model
    from gpnerf_tpu_torch.utils.bench_frames import get_bench_frames

    cfg = mesh_cfg(512)
    vs = float(cfg.dataset.voxel_size[0])
    th = 1.0 / cfg.test.mesh_th
    t0 = time.perf_counter()
    host = get_bench_frames(cfg, 1)[0]
    log(f"# mesh path: bench frame 0 at 512^2, voxel {vs} m, visual-hull grid "
        f"{tuple(host['pts'].shape[:3])} ({int(host['inside'].sum())} inside), built on the host "
        f"in {time.perf_counter() - t0:.1f} s")
    batch = batch_to_device(host, "cuda")
    outs = {}
    for name in ("BaseRender", "demo_render"):
        r = load_eval_model(CKPT, get("render", name)(cfg, device="cuda")).eval()
        check(r.mesh_th == th, f"{name}: mesh_th {r.mesh_th}")
        with torch.no_grad():  # warm the encoder and the volume stage
            mesh_volume(r.encoder, r.nerfhead, batch, r.max_out_sh)
        for lib in (ps.LAUNCHES, ql.LAUNCHES, rg.LAUNCHES):
            lib.clear()
        out, vol_ms, chunk_ms, mc_ms = timed_render_mesh(r, batch)
        launches = {**ps.LAUNCHES, **ql.LAUNCHES, **rg.LAUNCHES}
        cube, mesh = out["cube"], out["mesh"]
        n_pts = int(host["inside"].sum()) if name == "BaseRender" else int(
            np.prod(np.asarray(cube.shape) - 20))
        check(np.isfinite(cube).all(), f"{name} mesh: non-finite alpha")
        log(f"# mesh path, {name} on {card}: {n_pts} grid points in {-(-n_pts // 65536)} chunks "
            f"of 65536, cube {tuple(cube.shape)}, {int((cube > th).sum())} voxels above "
            f"{th}; volume stage {vol_ms:.3f} ms, chunk loop {chunk_ms:.3f} ms (CUDA events), "
            f"marching cubes {mc_ms:.1f} ms (host); {len(mesh.vertices)} vertices, "
            f"{len(mesh.faces)} triangles; kernel launches {json.dumps(launches)} (none lies "
            "on the mesh path)")
        check(len(mesh.vertices) > 0 and len(mesh.faces) > 0, f"{name} mesh: empty")
        outs[name] = (r, cube)
    hull = outs["BaseRender"][1][10:-10, 10:-10, 10:-10]
    cloud_h = host["pts"].reshape(hull.shape + (3,))[hull > th]
    r, occ = outs["demo_render"]
    with torch.no_grad():
        cb0 = r.mesh_frame(batch)["can_bounds"][0].cpu().numpy()
    occ = occ[10:-10, 10:-10, 10:-10]
    cloud_o = cb0[None] + np.argwhere(occ > th) * vs
    # every 16th point of each cloud queries the other
    d_oh = float(np.median(cKDTree(cloud_h).query(cloud_o[::16])[0]))
    d_ho = float(np.median(cKDTree(cloud_o).query(cloud_h[::16])[0]))
    log(f"# mesh path: thresholded alpha clouds, hull grid {len(cloud_h)} points, occupancy grid "
        f"{len(cloud_o)}; median nearest distance {d_oh:.5f} / {d_ho:.5f} m (2 voxels: {2 * vs} m)")
    check(len(cloud_h) > 50 and len(cloud_o) > 50 and d_oh < 2 * vs and d_ho < 2 * vs,
          "mesh path: the two alpha clouds do not interleave")
    del outs, r, batch
    torch.cuda.empty_cache()
    # the card against the CPU at 128^2, 0.02 m
    small_cfg = mesh_cfg(128, 0.02)
    small = get_bench_frames(small_cfg, 1)[0]
    for name in ("BaseRender", "demo_render"):
        cubes = {}
        for d in ("cuda", "cpu"):
            r = load_eval_model(CKPT, get("render", name)(small_cfg, device=d)).eval()
            cubes[d] = r.render_mesh(batch_to_device(small, d), chunk=16384)["cube"]
        check(cubes["cuda"].shape == cubes["cpu"].shape, f"128^2 {name} mesh: cube shapes differ")
        d_cube = float(np.abs(cubes["cuda"] - cubes["cpu"]).max())
        log(f"# 128^2 {name} mesh, 0.02 m voxel, card vs CPU: cube {cubes['cpu'].shape}, "
            f"max |d alpha| {d_cube:.3e}")
        check(d_cube < 1e-3, f"128^2 {name} mesh: card and CPU alpha cubes differ by {d_cube}")


def train_phase(card, profile, neg=False, train_dtype="float32"):
    """Phase 5: the training path at full width (configs/synthetic.yaml:
    512^2, ResNet34-UNet, code_dim 32, 1024 rays x 64 samples, float32)
    from the trained checkpoint: warm-up steps, then timed steps on distinct
    batches through `train.step.train_step`; the whole-image eval render of
    one test frame; `Trainer.evaluate` of that frame through the progressive
    renderer (kernel 1, form (a)). Returns {"launches": the point-stage
    launches of that evaluation (counts set to 0 just before the path),
    "s_per_it": (min, median, max), "peak_gib", "psnr"}. With `neg`, the
    same on the `thuman-synthetic` splits (THuman's neg-ray convention in
    the train and the eval render), 5 timed steps, no `Trainer.evaluate`
    (launches 0). Phase 5b: `train_dtype` "bfloat16", bf16 mixed precision
    (`tpu.train_dtype`), every parameter checked float32 after the
    steps."""
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
    if train_dtype != "float32":
        what += f", {train_dtype}"
    cfg = make_cfg(512, "bfloat16", neg)
    cfg.defrost()
    cfg.render.file = "BaseRender"
    cfg.tpu.train_dtype = train_dtype
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
        f"{cfg.train.n_rays} rays x {cfg.train.n_samples} samples, {size}, {train_dtype}: s/it min {step_s[0]:.4f} median {step_s[n_timed // 2]:.4f} "
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
    check(all(p.dtype == torch.float32 for p in render.parameters())
          and all(v.dtype == torch.float32 for v in stats.values()),
          f"{what}: a parameter or running statistic is not float32")
    if profile and not neg:
        profile_steps(lambda b: train_step(render, crit, opt, sched, b, generator=gen),
                      batches[:3], card, step_s[n_timed // 2] * 1e3)

    psnr_after = eval_psnr()
    log(f"# {what}: render_eval_fn on test frame 0 ({int(test_host['n_rays'])} rays): PSNR "
        f"{psnr_before:.3f} dB before the steps, {psnr_after:.3f} dB after")
    check(psnr_after >= 20.0, f"{what}: eval PSNR {psnr_after:.3f} < 20 dB")
    result = {"launches": 0, "s_per_it": (step_s[0], step_s[n_timed // 2], step_s[-1]),
              "peak_gib": peak / 2**30, "psnr": psnr_after}
    if neg:
        return result

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
    log(f"# {what}: Trainer.evaluate through demo_render, test frame 0: PSNR "
        f"{metrics_d['psnr']:.3f} dB, SSIM {metrics_d['ssim']:.4f}, overflows "
        f"{metrics_d['overflows_max']}, {avg_s * 1e3:.3f} ms per frame; launches over the "
        f"training path: {json.dumps(launches)}")
    check(launches == {"a": 2}, f"{what} path: point-stage launches {launches}, expected 2 "
                                "of form a (a warm-up and a timed render)")
    check(metrics_d["psnr"] >= 20.0, f"Trainer.evaluate PSNR {metrics_d['psnr']:.3f} < 20 dB")
    o = metrics_d["overflows_max"]
    check(o[0] == 0 and o[2] == 0 and o[3] == 0, f"Trainer.evaluate overflows {o}")
    result["launches"] = launches.get("a", 0)
    return result


def multi_frame_epoch(card):
    """Phase 5b: one `Trainer.train` epoch of 2 loader batches of 2 frames
    each (`dataset.img_num_per_gpu 2`, bf16) on the card: 4 counted
    optimizer steps, the lr schedule stepped 4 times, finite losses,
    parameters moved."""
    import logging

    import numpy as np
    import torch

    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model
    from gpnerf_tpu_torch.train.criterion import Criterion
    from gpnerf_tpu_torch.train.step import make_optimizer
    from gpnerf_tpu_torch.train.trainer import Trainer

    cfg = make_cfg(512, "bfloat16")
    cfg.defrost()
    cfg.render.file = "BaseRender"
    cfg.tpu.train_dtype = "bfloat16"
    cfg.dataset.img_num_per_gpu = 2
    cfg.train.val_when_train = False
    cfg.train.print_freq = 1
    cfg.freeze()
    np.random.seed(1)
    random.seed(1)
    ds = get("dataset", cfg.dataset.train.file)(cfg, is_train=True)
    loader = [[ds[0], ds[1]], [ds[2], ds[3]]]
    dev = torch.device("cuda")
    render = load_eval_model(CKPT, get("render", "BaseRender")(cfg, device=dev))
    before = [p.detach().clone() for p in render.parameters()]
    opt, sched, schedule = make_optimizer(render, cfg)
    trainer = Trainer(cfg, render=render, criterion=Criterion(cfg), optimizer=opt,
                      scheduler=sched, lr_schedule=schedule, logger=logging.getLogger("chip_smoke"))
    losses = []  # the losses the Trainer reads back, collected in place of its log
    trainer._log_metrics = lambda logger, pending: losses.extend(
        float(m["loss"]) for _, m in pending)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train(loader, [])
    torch.cuda.synchronize()
    moved = sum(not torch.equal(p, q) for p, q in zip(render.parameters(), before))
    log(f"# training, 2 frames per step on {card}: Trainer.train over 2 batches of 2 frames in "
        f"{time.perf_counter() - t0:.2f} s: {trainer.iter_count} steps, schedule at "
        f"{sched.last_epoch}, losses {[round(x, 5) for x in losses]}, {moved} of {len(before)} "
        "parameter tensors moved")
    check(trainer.iter_count == 4 and sched.last_epoch == 4 and len(losses) == 4
          and all(math.isfinite(x) for x in losses) and moved >= len(before) - 2,
          "2-frame epoch: steps, schedule, losses or parameters wrong")


def train_bench_runs(card):
    """Phase 5b: tools/train_bench_torch.py --iters 10 for float32 and for
    bfloat16, each in a process of its own; every key, finite losses, the
    card's name."""
    out = {}
    for dt in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools", "train_bench_torch.py"), "--iters", "10",
             "tpu.train_dtype", dt], cwd=ROOT, capture_output=True, text=True, timeout=600)
        check(run.returncode == 0, f"train_bench_torch {dt} exited {run.returncode}: "
                                   f"{run.stderr[-3000:]}")
        line = json.loads(run.stdout.strip().splitlines()[-1])
        log(f"# tools/train_bench_torch.py --iters 10 tpu.train_dtype {dt} "
            f"({time.perf_counter() - t0:.1f} s): {json.dumps(line)}")
        check(line["dtype"] == dt and card.startswith(line["device"])
              and len(line["losses"]) == 10 and all(math.isfinite(x) for x in line["losses"]),
              f"train_bench_torch {dt}: {line}")
        out[dt] = line
    return out


def bf16_step_card_vs_cpu():
    """Phase 5b: one bf16 AdamW step at 128^2 (tiny encoder, code_dim 16,
    256 rays x 8 samples, seeded parameters) on the card and on the CPU,
    the same batch and draws: loss within 1e-2 relative, rgb_map within
    0.1, the gradient's cosine above 0.8 and norm ratio within 10%
    (measured on the H100: 1.2e-3, 0.040, 0.946, 1.005). Where the
    devices' float32 sums straddle a bf16 boundary they round apart, and
    this random-init step amplifies that as it amplifies any rounding
    detail (JAX's own bf16 gradient moves by 43% between two of its
    compile modes: tests/test_torch_bf16_train.py)."""
    import numpy as np
    import torch

    from gpnerf_tpu_torch.config import cfg as base
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render.base import batch_to_device
    from gpnerf_tpu_torch.train.criterion import Criterion
    from gpnerf_tpu_torch.train.step import make_optimizer, train_step

    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "synthetic.yaml"))
    cfg.encoder.name = "tiny"
    cfg.dataset.H = cfg.dataset.W = 128
    cfg.head.sigma.code_dim = 16
    cfg.train.n_rays, cfg.train.n_samples = 256, 8
    cfg.tpu.train_dtype = "bfloat16"
    cfg.freeze()
    np.random.seed(0)
    random.seed(0)
    batch = get("dataset", cfg.dataset.train.file)(cfg, is_train=True)[0]
    t_rand = torch.rand(256, 8, generator=torch.Generator().manual_seed(3))
    torch.manual_seed(0)
    state = get("render", "BaseRender")(cfg, device="cpu").init_variables(0).state_dict()
    out = {}
    for d in ("cuda", "cpu"):
        r = get("render", "BaseRender")(cfg, device=d)
        r.load_state_dict(state, strict=True)
        opt, sched, _ = make_optimizer(r, cfg)
        m, ret = train_step(r, Criterion(cfg), opt, sched, batch_to_device(batch, d),
                            t_rand=t_rand.to(d))
        grad = torch.cat([p.grad.double().reshape(-1).cpu() for p in r.parameters()])
        out[d] = (float(m["loss"]), ret["rgb_map"].detach().float().cpu(), grad)
    (lg, rg, gg), (lc, rc, gc) = out["cuda"], out["cpu"]
    cos = float(gg @ gc / (gg.norm() * gc.norm()))
    ratio = float(gg.norm() / gc.norm())
    d_rgb = float((rg - rc).abs().max())
    log(f"# bf16 step at 128^2, card against CPU: loss {lg:.6f} / {lc:.6f}, rgb_map max |d| "
        f"{d_rgb:.3e}, gradient cosine {cos:.5f}, norm ratio {ratio:.5f}")
    check(abs(lg - lc) <= 1e-2 * abs(lc) and d_rgb <= 0.1 and cos > 0.8
          and abs(ratio - 1.0) <= 0.1, "bf16 step: card and CPU disagree")


def profile_steps(step, batches, card, step_ms):
    """torch.profiler over one train step per batch: device busy time per
    step and the idle share against the timed step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gpnerf_tpu_torch.utils.profiling import kernel_table

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches:
            step(b)
        torch.cuda.synchronize()
    n = len(batches)
    rows = kernel_table(prof)
    busy = sum(ms for _, ms, _ in rows) / n
    log(f"# profile on {card}: train step, kernels busy {busy:.3f} ms per step of {step_ms:.3f} ms, "
        f"idle share {1.0 - busy / step_ms:.3f}; {sum(c for _, _, c in rows) / n:.0f} kernel "
        "launches per step; by kernel (ms per step, launches per step):")
    for name, ms, count in rows[:25]:
        log(f"#   {ms / n:9.4f} ms {count / n:6.1f}x  {name[:110]}")


def layout_phase():
    """Phase 7a: artifacts/bench_ckpt.pth with every sparse conv weight
    permuted into spconv 2.x's (Cout, Cin, kD, kH, kW) loads onto the card,
    strict and as a non-strict resume, into the state the unpermuted file
    gives, bit for bit (models/sparse_net.SparseConvWeight's load hook)."""
    import tempfile

    import torch

    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.train.checkpoint import key_map, load_checkpoint, load_eval_model

    cfg = make_cfg(512, "bfloat16")
    cfg.defrost()
    cfg.render.file = "BaseRender"
    cfg.freeze()
    ckpt = torch.load(CKPT, map_location="cpu", weights_only=False)
    state = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    sparse = [k for k, _, _, kind in key_map() if kind == "sparse"]
    v2 = dict(state, **{k: state[k].permute(4, 3, 0, 1, 2).contiguous() for k in sparse})
    ref = load_eval_model(CKPT, get("render", "BaseRender")(cfg, device="cuda")).state_dict()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "spconv2.pth")
        torch.save({"epoch": 3, "state_dict": v2}, path)
        strict = load_eval_model(path, get("render", "BaseRender")(cfg, device="cuda"))
        resumed = get("render", "BaseRender")(cfg, device="cuda")
        rcfg = cfg.clone()
        rcfg.defrost()
        rcfg.train.resume = True
        rcfg.render.resume_path = path
        rcfg.freeze()
        check(load_checkpoint(rcfg, resumed) == 3, "spconv 2.x checkpoint: resume epoch")
    for how, r in (("strict", strict), ("resume", resumed)):
        got = r.state_dict()
        check(set(got) == set(ref) and all(same_bits(got[k], ref[k]) for k in ref),
              f"spconv 2.x checkpoint ({how}): state differs from the 1.2.1 file's")
    log(f"# spconv 2.x layout: {len(sparse)} sparse weights permuted to (Cout, Cin, 3, 3, 3); "
        f"load_eval_model and load_checkpoint on the card give the 1.2.1 file's {len(ref)} "
        "tensors bit for bit")


def tools_phase(card):
    """Phase 7b: the quality and profiling tools on the card:
    tools/quality_sweep_torch.py's `sweep` over the 3 bench frames (every
    key of its lines, each frame >= 20 dB), one profiled request of bench
    frame 0 (upload, render, download) whose trace holds each render span of
    utils/profiling.py and whose counters are all positive, the kernel
    fetching the rows of every point slot,
    device_memory_stats (live and peak
    bytes nonzero), and tools/profile_demo_torch.py --async in a process of
    its own (exit 0)."""
    import io

    import torch

    from gpnerf_tpu_torch.render.base import batch_to_device
    from gpnerf_tpu_torch.render.demo import pred_img_hwc
    from gpnerf_tpu_torch.utils import profiling
    from gpnerf_tpu_torch.utils.bench_frames import get_bench_frames
    from gpnerf_tpu_torch.utils.profiling import device_memory_stats

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import quality_sweep_torch

    dev = torch.device("cuda")
    cfg, render = make_render(512, "bfloat16", "cuda")
    host = get_bench_frames(cfg, 3)
    buf = io.StringIO()
    rows, summary = quality_sweep_torch.sweep(cfg, render, host, dev, out=buf)
    for line in buf.getvalue().splitlines():
        log(f"# quality sweep, 3 bench frames: {line}")
    check(len(rows) == 3 and all(set(r) == {"i", "psnr", "ssim", "overflows", "counts"}
                                 for r in rows), "quality sweep: per-frame keys")
    check(set(summary) == {"n", "psnr_mean", "ssim_mean", "psnr_min", "max_overflows", "wall_s",
                           "overrides"}, "quality sweep: summary keys")
    check(summary["psnr_min"] >= 20.0, f"quality sweep: PSNR {summary['psnr_min']} < 20 dB")

    fn = render.render_demo_fn()
    pred_img_hwc(fn(batch_to_device(host[0], dev)))
    profiling.reset_counters()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        pred_img_hwc(fn(batch_to_device(host[0], dev)))
        torch.cuda.synchronize()
    seen = {e.key: e.count for e in prof.key_averages()}
    names = ("gpnerf.upload", "gpnerf.render", "gpnerf.encoder", "gpnerf.frame_stage",
             "gpnerf.ray_pipeline", "gpnerf.point_stages", "gpnerf.assemble", "gpnerf.download")
    spans = {n: seen.get(n, 0) for n in names}
    counts = profiling.counters()
    profiling.reset_counters()
    mem = device_memory_stats()
    log(f"# profiled request on {card}, bench frame 0: spans {json.dumps(spans)}; counters "
        f"{json.dumps(counts)}; device_memory_stats: {json.dumps(mem)}")
    check(all(v >= 1 for v in spans.values()), f"render spans: {spans}")
    check(set(counts) == {"renders", "upload_bytes", "point_slots", "kernel_fetched_slots",
                          "colored_points"}
          and counts["renders"] == 1 and all(v > 0 for v in counts.values())
          and counts["kernel_fetched_slots"] == counts["point_slots"],
          f"counters: {counts}")
    check(mem.get("bytes_in_use", 0) > 0 and mem.get("peak_bytes_in_use", 0) > 0
          and mem.get("bytes_limit", 0) > 0, f"device_memory_stats: {mem}")

    t0 = time.perf_counter()
    prof = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "profile_demo_torch.py"),
                           "--async"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    check(prof.returncode == 0, f"profile_demo_torch.py --async exited {prof.returncode}: "
                                f"{prof.stderr[-3000:]}")
    for line in prof.stdout.splitlines():
        log(f"# profile_demo_torch.py --async: {line}")
    log(f"# profile_demo_torch.py --async on {card}: exit 0 in {time.perf_counter() - t0:.1f} s")


def diag_tools_phase(card):
    """Phase 7d: tools/diag_ref_mode_torch.py, tools/diag_ref_points_torch.py
    and tools/trace_demo_torch.py, each in a process of its own on 2 bench
    frames at 512^2, with their checks (module docstring). Returns kernel
    1's launches in these processes, by form."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import diag_ref_mode_torch as drm
    import diag_ref_points_torch as drp

    from gpnerf_tpu_torch.utils.bench_frames import get_bench_frames

    def run_tool(what, argv):
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, *argv], cwd=ROOT, capture_output=True, text=True,
                             timeout=600)
        check(run.returncode == 0, f"{what} exited {run.returncode}: {run.stderr[-3000:]}")
        for line in run.stdout.splitlines():
            log(f"# {what}: {line}")
        marks = [x for x in run.stderr.splitlines() if x.startswith("# kernel launches ")]
        launches = json.loads(marks[-1][len("# kernel launches "):]) if marks else {}
        log(f"# {what} on {card}: exit 0 in {time.perf_counter() - t0:.1f} s; kernel launches "
            f"{launches}")
        return run.stdout, launches

    launches = {}

    def add(counts):  # kernel 1's counts are keyed by form name (ops/point_stages.py)
        for name, n in counts.items():
            if name not in ("quad_lerp_rows_vcp", "quad_lerp_rows_cm", "row_gather"):
                key = f"point_stages[{name}]"
                launches[key] = launches.get(key, 0) + n

    # diag_ref_mode: the bands against the frames' own squared error
    out, counts = run_tool("diag_ref_mode_torch.py", ["tools/diag_ref_mode_torch.py", "2"])
    add(counts)
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    band_keys = {"px", "mse_tight", "mse_ref", "sse_tight", "sse_ref"}
    check(len(lines) == 3 and [x.get("frame") for x in lines[:2]] == [0, 1]
          and all(set(x) == {"frame", *drm.BANDS} and all(set(x[b]) == band_keys for b in drm.BANDS)
                  for x in lines[:2])
          and set(lines[2]) == {"total"} and set(lines[2]["total"]) == set(drm.BANDS)
          and all(set(v) == {"px", "sse_tight", "sse_ref"} for v in lines[2]["total"].values()),
          f"diag_ref_mode_torch.py lines: {lines}")
    cfg_t, cfg_r = drm.mode_cfg(False), drm.mode_cfg(True)
    host = get_bench_frames(cfg_t, 2)
    dev = torch.device("cuda")
    outs = {"tight": drm.render_outs(cfg_t, host, dev), "ref": drm.render_outs(cfg_r, host, dev)}
    for i, (b, line) in enumerate(zip(host, lines)):
        mab = np.asarray(b["mask_at_box"]).reshape(outs["tight"][i][1].shape)
        covered = {m: outs[m][i][1] & mab for m in outs}
        neither = mab & ~covered["tight"] & ~covered["ref"]
        px = sum(line[k]["px"] for k in drm.BANDS)
        check(px <= mab.sum() and px + neither.sum() == mab.sum(),
              f"diag_ref_mode frame {i}: bands {px} px + neither {int(neither.sum())} px against "
              f"mask_at_box {int(mab.sum())}")
        gt = np.asarray(b["tar_img"], np.float32)
        gt = (gt / 255.0 if gt.max() > 1.5 else gt) * mab[..., None]
        for m in outs:
            err = ((outs[m][i][0] - gt) ** 2).sum(-1)
            frame_sse, neither_sse = float(err[mab].sum()), float(err[neither].sum())
            bands_sse = sum(line[k][f"sse_{m}"] for k in drm.BANDS)
            gap = abs(bands_sse + neither_sse - frame_sse)
            log(f"# diag_ref_mode frame {i} {m}: bands {bands_sse:.4f} + neither {neither_sse:.4f} "
                f"against the frame's {frame_sse:.4f} over mask_at_box (gap {gap:.3e})")
            check(gap <= 1e-4 * frame_sse, f"diag_ref_mode frame {i} {m}: SSE gap {gap}")

    # diag_ref_points: the reference frame's P, seven positive times
    out, counts = run_tool("diag_ref_points_torch.py", ["tools/diag_ref_points_torch.py", "2"])
    add(counts)
    res = json.loads([x for x in out.splitlines() if x.startswith("{")][-1])
    t = drp.ref_cfg().tpu
    want_p = t.samples_per_ray * t.ray_cap if t.dense_slots else t.sigma_cap
    ops = {"octet_query", "octet_l1_only", "coarse_nearest_only", "proj_quad_current",
           "proj_rgb_only", "proj_feat_only", "heads_op_by_op"}
    check(res["P"] == want_p and set(res["ms"]) == ops and all(v > 0 for v in res["ms"].values()),
          f"diag_ref_points_torch.py: {res} (P {want_p} wanted)")

    # trace_demo: kernel 1 among the top rows
    out, counts = run_tool("trace_demo_torch.py", [
        "-c", "import sys; sys.path.insert(0, 'tools'); import trace_demo_torch; "
        "trace_demo_torch.main(sys.argv[1:], n_frames=2)", CKPT, "40"])
    add(counts)
    top = out.split("   busy ")[0]
    check("point_stages_kernel" in top, "trace_demo_torch.py: kernel 1 not among the top rows")
    return launches


def bench_phase(card):
    """Phase 8: bench_torch.py in a process of its own, at its full
    protocol. Checks its exit code, its one bare JSON line (the fast mode)
    and the record it writes: the three modes, each with zero ray, sigma
    and rgb overflows, PSNR >= 20 dB and kernel 1 launched once per frame
    of a pass; `mfu` within (0, 1]. Returns the modes' launches per pass."""
    record = os.path.join(ROOT, "BENCH_MODES_torch.json")
    if os.path.exists(record):
        os.remove(record)
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    check(run.returncode == 0, f"bench_torch.py exited {run.returncode}: {run.stderr[-3000:]}")
    bare = [line for line in run.stdout.splitlines() if line.startswith("{")]
    check(len(bare) == 1, f"bench_torch.py printed {len(bare)} bare JSON lines: {run.stdout[-2000:]}")
    fast = json.loads(bare[0])
    with open(record) as f:
        modes = json.load(f)
    check(set(modes) == {"fast", "reference_semantics", "thuman_neg_ray"},
          f"bench_torch.py record holds {sorted(modes)}")
    check(modes["fast"]["value"] == fast["value"], "bench_torch.py record and fast line differ")
    mfu = fast.get("mfu")
    check(mfu is not None and 0.0 < mfu <= 1.0, f"bench_torch.py mfu {mfu}")
    for name, m in modes.items():
        ov = m["overflows"]
        check(ov[0] == 0 and ov[2] == 0 and ov[3] == 0, f"bench_torch.py {name}: overflows {ov}")
        check(m["psnr"] >= 20.0, f"bench_torch.py {name}: PSNR {m['psnr']:.3f} < 20 dB")
        check(sum(m["launches"].values()) == len(m["loop_frames"]["counts"]),
              f"bench_torch.py {name}: kernel launches per pass {m['launches']}")
    for line in run.stdout.splitlines() + run.stderr.splitlines():
        if line.startswith(("{", "# ref-mode", "# neg-ray", "# mfu")) or " ms/frame (scan)" in line:
            log(f"# bench: {line}")
    log(f"# bench_torch.py on {card}: exited 0 in {time.perf_counter() - t0:.1f} s; ms/frame fast "
        f"{modes['fast']['ms_per_frame']:.3f}, reference {modes['reference_semantics']['ms_per_frame']:.3f}"
        f", neg-ray {modes['thuman_neg_ray']['ms_per_frame']:.3f}; mfu {mfu}")
    return {name: m["launches"] for name, m in modes.items()}, fast


def count_diff(a, b, top=15):
    """The ops (and declared kernels) whose bytes or FLOPs differ between two
    counts (utils/roofline.py `Count`), largest byte gap first."""
    keys = set(a.by_op) | set(b.by_op)
    rows = [(k, a.by_op[k] - b.by_op[k], a.flops_by_op[k] - b.flops_by_op[k]) for k in keys]
    rows = [r for r in rows if r[1] or r[2]]
    return sorted(rows, key=lambda r: -abs(r[1]))[:top]


def roofline_phase(card, profile, fast_line):
    """Phase 8r: tools/roofline_torch.py in a process of its own on 2 bench
    frames (8 under --profile): exit 0, one row per STOP_STAGES prefix and
    the whole render plus the production row, every delta_GB >= 0, every
    share of the HBM roof and the production row's in (0, 100]. Then bench
    frame 0's fast render (fused) counted on the card and on the CPU
    (utils/roofline.py `counting`): bytes and FLOPs equal, or within 1%
    with the differing ops printed. And phase 8's fast line carries
    `roofline` with `pct_hbm_roof` in (0, 100]."""
    import torch

    from bench_torch import bench_cfg
    from gpnerf_tpu_torch.render.base import batch_to_device
    from gpnerf_tpu_torch.render.demo import STOP_STAGES
    from gpnerf_tpu_torch.utils.bench_frames import get_bench_frames

    n = 8 if profile else 2
    out_dir = os.path.join(ROOT, "results", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "roofline.json")
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, 'tools'); import roofline_torch; "
         f"roofline_torch.main(sys.argv[1:], n_frames={n})", "--json", path],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    check(run.returncode == 0, f"roofline_torch.py exited {run.returncode}: {run.stderr[-3000:]}")
    for line in run.stdout.splitlines():
        log(f"# roofline: {line}")
    with open(path) as f:
        res = json.load(f)
    rows, prod = res["ladder"], res["production"]
    check([r["stage"] for r in rows] == [*STOP_STAGES, "None"],
          f"roofline ladder stages {[r['stage'] for r in rows]}")
    for r in rows:
        check(r["delta_GB"] >= 0, f"roofline {r['stage']}: delta_GB {r['delta_GB']} < 0")
        pct = r["pct_bw_roof"]
        check(pct is None or 0.0 < pct <= 100.0, f"roofline {r['stage']}: pct_bw_roof {pct}")
    check(prod["pct_bw_roof"] is not None and 0.0 < prod["pct_bw_roof"] <= 100.0,
          f"roofline production: pct_bw_roof {prod['pct_bw_roof']}")
    log(f"# tools/roofline_torch.py on {card} ({res['device']}, {res['nvidia_smi']}): exit 0 in "
        f"{time.perf_counter() - t0:.1f} s over {n} frames, {len(rows)} ladder rows + production; "
        f"production {prod['total_ms']} ms, {prod['total_GB']} GB, {prod['achieved_GBps']} GB/s = "
        f"{prod['pct_bw_roof']}% of {res['peak_GBps']} GB/s")

    cfg = bench_cfg([])
    (host,) = get_bench_frames(cfg, 1)
    counts = {}
    for d in ("cuda", "cpu"):
        cfg_d, render = make_render(512, cfg.tpu.matmul_dtype, d)
        check(render.pallas_point, "phase 8r: the fast mode is not fused")
        batch = batch_to_device(host, d)
        with torch.no_grad(), roofline.counting(d) as c:
            render.render_demo_fn()(batch)
        counts[d] = c
        del render, batch
    g, c = counts["cuda"], counts["cpu"]
    db, df = abs(g.bytes - c.bytes) / c.bytes, abs(g.flops - c.flops) / c.flops
    log(f"# roofline count of bench frame 0 (fast, fused) on {card}: {g.bytes} B, {g.flops} FLOPs, "
        f"kernels {dict(g.kernels)}, host<->card {g.transfer_bytes} B, host ops {g.host_ops}; on "
        f"the CPU {c.bytes} B, {c.flops} FLOPs, kernels {dict(c.kernels)}; gap {db:.3e} / {df:.3e}")
    for k, b, fl in count_diff(g, c):
        log(f"#   card - CPU: {k} {b:+d} B {fl:+d} FLOPs")
    check(db <= 0.01 and df <= 0.01, f"phase 8r: card and CPU counts differ by {db:.3e} / {df:.3e}")

    roof = fast_line.get("roofline")
    check(roof is not None and 0.0 < roof["pct_hbm_roof"] <= 100.0,
          f"bench_torch.py fast line roofline {roof}")
    log(f"# bench_torch.py roofline on {card}: {json.dumps(roof)}")


def dp_cfg(render_file):
    """configs/synthetic.yaml at 512^2 with the checkpoint's code_dim: the
    training renderer (1,024 rays x 64 samples) or the fast-mode demo
    renderer."""
    cfg = make_cfg(512, "bfloat16")
    cfg.defrost()
    cfg.render.file = render_file
    cfg.freeze()
    return cfg


def dp_worker(out_dir, coordinator, world, rank, backend):
    """One rank of phase 7c (`chip_smoke.py --dp-worker ...`): one
    data-parallel step at full width from the checkpoint on its frame and
    draws (its state written to out_dir/rank<r>.pt), 2 + 10 more steps timed
    with CUDA events, then the 2-rank progressive render of bench frame 0
    against the single-process render on this rank, with the point-stage
    launches of the DP render; the findings to out_dir/rank<r>.json."""
    import pickle

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from gpnerf_tpu_torch.ops import point_stages as ps
    from gpnerf_tpu_torch.parallel import dp
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render.base import batch_to_device
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model
    from gpnerf_tpu_torch.train.criterion import Criterion
    from gpnerf_tpu_torch.train.step import make_optimizer
    from gpnerf_tpu_torch.utils import dist

    dev = dist.local_device(rank)
    dist.init_distributed(coordinator, world, rank, backend=backend, device=dev)
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    res = {"rank": rank, "device": str(dev), "backend": backend}
    cfg = dp_cfg("BaseRender")
    render = load_eval_model(CKPT, get("render", cfg.render.file)(cfg, device=dev))
    opt, sched, _ = make_optimizer(render, cfg)
    render.train()
    step = dp.make_dp_train_step(render, Criterion(cfg), opt, sched)
    batch = batch_to_device(inp["frames"][rank], dev)
    metrics, _ = step(batch, t_rand=torch.from_numpy(inp["t_rand"][rank]).to(dev))
    res["metrics"] = {k: float(v) for k, v in metrics.items()}
    torch.save({k: v.cpu() for k, v in render.state_dict().items()},
               os.path.join(out_dir, f"rank{rank}.pt"))
    gen = torch.Generator(device=dev).manual_seed(100 + rank)
    for _ in range(2):
        step(batch, generator=gen)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(10)]
    for start, end in events:
        start.record()
        step(batch, generator=gen)
        end.record()
    torch.cuda.synchronize()
    res["s_per_it"] = sorted(s.elapsed_time(e) / 1e3 for s, e in events)
    res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    del render, opt, step

    cfg = dp_cfg("demo_render")
    demo = load_eval_model(CKPT, get("render", cfg.render.file)(cfg, device=dev))
    fb = batch_to_device(inp["bench"], dev)
    single = demo.render_demo_fn()(fb)
    run = dp.make_dp_demo_render(demo)
    run(fb)
    torch.cuda.synchronize()
    ps.LAUNCHES.clear()
    multi = run(fb)
    torch.cuda.synchronize()
    res["launches"] = dict(ps.LAUNCHES)
    res["same"] = {k: bool(torch.equal(single[k], multi[k]))
                   for k in ("ray_ok", "ray_pix_idx", "mask_at_box", "overflows", "counts")}
    res["pred_max"] = float((single["pred_chw"] - multi["pred_chw"]).abs().max())
    res["overflows"] = multi["overflows"].tolist()
    res["counts"] = multi["counts"].tolist()
    res["psnr"] = psnr_of(multi, inp["bench"])
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.shutdown()
    return 0


def within_step_tolerance(before, a, b, lr, wd):
    """tests/test_torch_train_step.py's tolerance between two AdamW
    results `a` and `b` from `before` (dicts of parameter tensors): each
    element within 1e-6, or, where the two steps' Adam directions differ in
    sign or are not saturated, within 2 lr plus the float32 rounding of
    both results, on at most 0.5% of the elements. Returns (ok, elements
    beyond 1e-6, elements)."""
    import numpy as np

    n_all = n_over = 0
    ok = True
    for k in before:
        p0, pa, pb = before[k].double(), a[k].double(), b[k].double()
        sa = -(pa - p0) / lr - wd * p0
        sb = -(pb - p0) / lr - wd * p0
        special = (sa.sign() != sb.sign()) | (sa.abs() < 0.99) | (sb.abs() < 0.99)
        over = (pa - pb).abs() > 1e-6
        ulp = float(np.finfo(np.float32).eps) * float(pb.abs().max())
        ok &= bool(special[over].all()) and float((pa - pb).abs().max()) <= 2 * lr + 2 * ulp
        n_all += pa.numel()
        n_over += int(over.sum())
    return ok and n_over <= 5e-3 * n_all, n_over, n_all


def dp_phase(card, single_s_per_it=None):
    """Phase 7c: data parallelism, two processes of `chip_smoke.py
    --dp-worker`: NCCL with one rank per card when the box has two or more,
    else gloo with both ranks on cuda:0 (then NCCL across cards is not
    exercised). Each rank takes one DP train step at full width from the
    checkpoint (BaseRender, 1,024 rays x 64 samples, one 512^2 train frame
    per rank): the ranks' parameters must be bitwise equal, and equal
    within the step test's tolerance to one process that averages the two
    frames' gradients (and running statistics) itself before AdamW. Then
    the 2-rank progressive render of bench frame 0 in fast mode
    (parallel/dp.make_dp_demo_render) must equal the single-process render
    (integers bitwise, colors within 1e-4), and kernel 1 must launch on each
    rank. Logs the DP step's s/it beside one process's."""
    import pickle
    import socket
    import tempfile

    import numpy as np
    import torch

    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render.base import batch_to_device
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model
    from gpnerf_tpu_torch.train.criterion import Criterion
    from gpnerf_tpu_torch.train.step import forward_backward, make_optimizer
    from gpnerf_tpu_torch.utils.bench_frames import get_bench_frames

    world = 2
    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= world else "gloo"
    where = (f"NCCL, one rank per card (cuda:0, cuda:1 of {n_cards})" if backend == "nccl" else
             "gloo, both ranks on cuda:0 of the box's one card: NCCL across cards is not "
             "exercised here")
    log(f"# data parallel: {world} processes over {where}")
    cfg = dp_cfg("BaseRender")
    np.random.seed(0)
    random.seed(0)
    train_ds = get("dataset", cfg.dataset.train.file)(cfg, is_train=True)
    frames = [train_ds[i] for i in range(world)]
    g = torch.Generator().manual_seed(7)
    t_rand = [torch.rand(cfg.train.n_rays, cfg.train.n_samples, generator=g).numpy()
              for _ in range(world)]
    bench = get_bench_frames(dp_cfg("demo_render"), 3)[0]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
            pickle.dump({"frames": frames, "t_rand": t_rand, "bench": bench}, f)
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{s.getsockname()[1]}"
        s.close()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-worker", tmp,
                                   coordinator, str(world), str(r), backend], cwd=ROOT,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(world)]
        errs = []
        try:
            for p in procs:
                errs.append(p.communicate(timeout=900)[1][-3000:])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        check(all(p.returncode == 0 for p in procs),
              f"data-parallel workers exited {[p.returncode for p in procs]}: {errs}")
        res = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                res.append(json.load(f))
            res[-1]["state"] = torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
    log(f"# data parallel: both ranks exited 0 in {time.perf_counter() - t0:.1f} s")
    a, b = res[0]["state"], res[1]["state"]
    check(set(a) == set(b) and all(same_bits(a[k], b[k]) for k in a),
          "data parallel: the ranks' states differ after the step")

    # one process: the two frames' gradients and running statistics averaged
    dev = torch.device("cuda")
    render = load_eval_model(CKPT, get("render", cfg.render.file)(cfg, device=dev))
    opt, sched, _ = make_optimizer(render, cfg)
    render.train()
    before = {k: p.detach().clone() for k, p in render.named_parameters()}
    stats = {k: v for k, v in render.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    stats0 = {k: v.clone() for k, v in stats.items()}
    grads, new_stats, losses = [], [], []
    for i in range(world):
        for k, v in stats.items():
            v.copy_(stats0[k])
        m, _ = forward_backward(render, Criterion(cfg), opt, batch_to_device(frames[i], dev),
                                t_rand=torch.from_numpy(t_rand[i]).to(dev))
        losses.append(float(m["loss"]))
        grads.append({k: p.grad.clone() for k, p in render.named_parameters()})
        new_stats.append({k: v.clone() for k, v in stats.items()})
    for k, p in render.named_parameters():
        p.grad = (grads[0][k] + grads[1][k]) / 2
    opt.step()
    sched.step()
    with torch.no_grad():
        for k, v in stats.items():
            v.copy_((new_stats[0][k] + new_stats[1][k]) / 2)
    mine = {k: p.detach().cpu() for k, p in render.named_parameters()}
    ok, n_over, n_all = within_step_tolerance(
        {k: v.cpu() for k, v in before.items()}, {k: a[k] for k in mine}, mine, cfg.train.lr,
        cfg.train.weight_decay)
    d_stats = max(float((a[k] - v.cpu()).abs().max()) for k, v in stats.items())
    d_loss = abs(res[0]["metrics"]["loss"] - sum(losses) / world)
    log(f"# data parallel step at 512^2 (1,024 rays x 64 samples per rank) against one process "
        f"averaging the two frames' gradients: {n_over} of {n_all} parameter elements beyond "
        f"1e-6 (within 2 lr), running statistics max |d| {d_stats:.3e}, mean loss "
        f"{res[0]['metrics']['loss']:.6f} against {sum(losses) / world:.6f}")
    check(ok, "data parallel step: parameters beyond the step test's tolerance of one process's")
    check(d_stats <= 1e-5 and d_loss <= 1e-4 * abs(sum(losses)),
          "data parallel step: running statistics or loss differ from one process's")
    del render, opt
    torch.cuda.empty_cache()

    for r in res:
        log(f"# data parallel rank {r['rank']} ({r['device']}, {r['backend']}) on {card}: DP step "
            f"s/it min {r['s_per_it'][0]:.4f} median {r['s_per_it'][5]:.4f} max "
            f"{r['s_per_it'][-1]:.4f} (10 steps, CUDA events"
            + (f"; one process, phase 5: median {single_s_per_it[1]:.4f}" if single_s_per_it else "")
            + f"), peak {r['peak_gib']:.3f} GiB; 2-rank fast render of "
            f"bench frame 0: launches {json.dumps(r['launches'])}, overflows {r['overflows']}, "
            f"counts {r['counts']}, PSNR {r['psnr']:.3f} dB, against one process: integers "
            f"{json.dumps(r['same'])}, colors max |d| {r['pred_max']:.2e}")
        check(all(r["same"].values()), f"2-rank render, rank {r['rank']}: integers differ")
        check(r["pred_max"] <= 1e-4, f"2-rank render, rank {r['rank']}: colors {r['pred_max']}")
        check(r["launches"] == {"a": 1}, f"2-rank render, rank {r['rank']}: launches "
                                         f"{r['launches']}, expected one of form a")
        check(r["psnr"] >= 20.0, f"2-rank render: PSNR {r['psnr']:.3f} < 20 dB")


def bf16_stages_card_vs_cpu():
    """Phase 5b, after the bf16 step: where the bf16 step's card-against-CPU
    gap comes from, stage by stage with tests/test_torch_bf16_train.py's
    method (the same inputs and seeded cotangents on both devices): the
    encoder (from the source images), the code fusion and sparse stack
    (train-mode BatchNorms, from the vertex features), the heads (from the
    frame's sample points, the level matrices and the projected features).
    For each stage and for bf16 and float32: the output's max |d| and
    relative L2 and the parameter gradient's cosine and relative L2, card
    against CPU. Logged, not gated: bf16 rounding decides where the
    devices' float32 sums straddle a bf16 boundary."""
    import numpy as np
    import torch

    from gpnerf_tpu_torch.config import cfg as base
    from gpnerf_tpu_torch.ops.projection import project_and_gather
    from gpnerf_tpu_torch.ops.rays import sample_points, sample_z_vals
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render.base import (
        batch_to_device,
        points_to_dhw_vox,
        prepare_frame,
        src_norm,
    )

    def cfg_of(dt):
        cfg = base.clone()
        cfg.defrost()
        cfg.merge_from_file(os.path.join(ROOT, "configs", "synthetic.yaml"))
        cfg.encoder.name = "tiny"
        cfg.dataset.H = cfg.dataset.W = 128
        cfg.head.sigma.code_dim = 16
        cfg.train.n_rays, cfg.train.n_samples = 256, 8
        cfg.tpu.train_dtype = dt
        cfg.freeze()
        return cfg

    np.random.seed(0)
    random.seed(0)
    c32 = cfg_of("float32")
    host = get("dataset", c32.dataset.train.file)(c32, is_train=True)[0]
    state = get("render", "BaseRender")(c32, device="cpu").init_variables(0).state_dict()
    t_rand = torch.rand(256, 8, generator=torch.Generator().manual_seed(3))
    # the stage inputs, from the float32 renderer on the CPU
    r32 = get("render", "BaseRender")(c32, device="cpu")
    r32.load_state_dict(state, strict=True)
    pb = batch_to_device(host, "cpu")
    with torch.no_grad():
        fm = r32.encoder(src_norm(pb["src_imgs"]))
        pre = prepare_frame(pb, fm, r32.max_out_sh)
        feats = [x.float() for x in r32.nerfhead.volume(pre["smpl_feat"], pre["vertex_rows"],
                                                         pre["grids"], train=False)]
        z = sample_z_vals(pb["near"], pb["far"], 8, perturb=True, t_rand=t_rand)
        pts = sample_points(pb["ray_o"], pb["ray_d"], z)
        dhw = points_to_dhw_vox(pts, pb, r32.voxel_size)
        rgb_feat, mask = project_and_gather(pts.reshape(-1, 3), pre["KE"],
                                            src_norm(pb["src_imgs"]) * 0.5 + 0.5, fm, 128, 128)
    rgb_feat, mask = rgb_feat.reshape(256, 8, 3, -1), mask.reshape(256, 8, 3, 1)
    rng = np.random.default_rng(1)
    ct_enc = torch.from_numpy(rng.standard_normal(tuple(fm.shape)).astype(np.float32))
    ct_lv = [torch.from_numpy(rng.standard_normal(tuple(x.shape)).astype(np.float32))
             for x in feats]
    ct_raw = torch.from_numpy(rng.standard_normal((256, 8, 4)).astype(np.float32))

    def run(dt, d):
        cfg = cfg_of(dt)
        b = batch_to_device(host, d)
        out = {}
        r = get("render", "BaseRender")(cfg, device=d)
        r.load_state_dict(state, strict=True)
        y = r.encoder(src_norm(b["src_imgs"])).float()
        (y * ct_enc.to(d)).sum().backward()
        out["encoder"] = (y.detach(), [p.grad for p in r.encoder.parameters()])
        grids = prepare_frame(b, torch.zeros(3, 32, 32, 32, device=d), r.max_out_sh)["grids"]
        lv = r.nerfhead.volume(pre["smpl_feat"].to(d), b["vertex_rows"], grids, train=True)
        sum((x.float() * c.to(d)).sum() for x, c in zip(lv, ct_lv)).backward()
        sh = r.nerfhead.sigmahead
        out["sparse stack"] = (torch.cat([x.detach().float().reshape(-1) for x in lv]),
                               [p.grad for n, p in sh.named_parameters()
                                if not n.startswith("out_geometry_fc") and p.grad is not None])
        r.zero_grad()
        lf = [x.detach().to(d, copy=True).requires_grad_() for x in feats]
        raw, _ = r.nerfhead.point_forward(
            r.sparse_query_ctx(lf, grids), dhw.to(d), torch.as_tensor(np.asarray(host["out_sh"]),
                                                                      device=d),
            rgb_feat.to(d), mask.to(d))
        (raw.float() * ct_raw.to(d)).sum().backward()
        out["heads"] = (raw.detach().float(),
                        [p.grad for n, p in r.nerfhead.named_parameters() if p.grad is not None
                         and n.startswith(("sigmahead.out_geometry_fc", "rgbhead"))]
                        + [x.grad for x in lf])
        return {k: (y.cpu().double(), torch.cat([g.reshape(-1).cpu().double() for g in gs]))
                for k, (y, gs) in out.items()}

    # each bf16 convolution of the encoder on the input its CPU forward
    # gives it: both devices' outputs against the exact result of the same
    # bf16 operands (the product in float64, each rounding of
    # models/layers.ReflectConv done once, to bf16)
    import torch.nn.functional as F

    from gpnerf_tpu_torch.models.layers import ReflectConv

    convs, inputs = {}, {}
    for d in ("cpu", "cuda"):
        r = get("render", "BaseRender")(cfg_of("bfloat16"), device=d)
        r.load_state_dict(state, strict=True)
        convs[d] = [m for m in r.encoder.modules() if isinstance(m, ReflectConv)]
        if d == "cpu":
            hooks = [m.register_forward_pre_hook(
                lambda m, a, i=i: inputs.setdefault(i, a[0].detach()))
                for i, m in enumerate(convs[d])]
            with torch.no_grad():
                r.encoder(src_norm(pb["src_imgs"]))
            for h in hooks:
                h.remove()
    bf = torch.bfloat16
    off = {"cpu": [0, 0.0], "cuda": [0, 0.0]}  # outputs off the exact rounding, max ulps
    n_out = 0
    with torch.no_grad():
        for i, x in sorted(inputs.items()):
            m = convs["cpu"][i]
            p = m.padding[0]
            xp = F.pad(x.float(), (p, p, p, p), mode="reflect") if p else x.float()
            ref = F.conv2d(xp.to(bf).double(), m.weight.to(bf).double(), None, m.stride).to(bf)
            if m.bias is not None:
                ref = (ref.double() + m.bias.to(bf).double()[None, :, None, None]).to(bf)
            ulp = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp_min(1e-30))) - 7)
            n_out += ref.numel()
            for d in ("cpu", "cuda"):
                y = convs[d][i](x.to(d)).cpu()
                diff = (y.float() - ref.float()).abs()
                off[d][0] += int((diff > 0).sum())
                off[d][1] = max(off[d][1], float((diff / ulp).max()))
    log(f"# bf16 encoder convolutions ({len(inputs)} layers, {n_out} outputs) on the CPU forward's "
        f"inputs, against the exactly rounded result: card off at {off['cuda'][0]} "
        f"({off['cuda'][0] / n_out:.3e}, max {off['cuda'][1]:.2f} ulp), CPU off at "
        f"{off['cpu'][0]} ({off['cpu'][0] / n_out:.3e}, max {off['cpu'][1]:.2f} ulp)")

    for dt in ("bfloat16", "float32"):
        card, cpu = run(dt, "cuda"), run(dt, "cpu")
        for stage in ("encoder", "sparse stack", "heads"):
            (yc, gc), (yh, gh) = card[stage], cpu[stage]
            cos = float(gc @ gh / (gc.norm() * gh.norm()))
            log(f"# {dt} stage {stage}, card against CPU: output max |d| "
                f"{float((yc - yh).abs().max()):.3e}, rel L2 {float((yc - yh).norm() / yh.norm()):.3e}; "
                f"gradient cosine {cos:.6f}, rel L2 {float((gc - gh).norm() / gh.norm()):.3e}")


def main():
    import torch

    if sys.argv[1:2] == ["--dp-worker"]:  # one rank of phase 7c
        sys.path.insert(0, ROOT)
        out_dir, coordinator, world, rank, backend = sys.argv[2:7]
        return dp_worker(out_dir, coordinator, int(world), int(rank), backend)
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
    all_keys = "--all-keys" in sys.argv[1:]

    from gpnerf_tpu_torch.ops import nbody_points as nbp
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
    if "--dp-only" in sys.argv[1:]:  # phase 7c alone, on form (a)'s library
        build_point_keys([k for k, n in ps.FORMS.items() if n == "a"])
        dp_phase(card)
        log(f"# total {time.perf_counter() - t_all:.1f} s")
        print(smi)
        return 0
    t0 = time.perf_counter()
    # every key the switch space reaches (--all-keys) or FORMS' and the cover
    cover = cover_keys()
    point_keys = list(ps.FORMS) + cover
    if all_keys:
        point_keys += [k for k in reachable_kernel_keys() if k not in point_keys]
    lerp_build, gather_build = ql.start_build(), rg.start_build()
    nbody_build = nbp.start_build()
    build_point_keys(point_keys, jobs=(os.cpu_count() or 8) * 6)
    ql.load_library(lerp_build)
    rg.load_library(gather_build)
    nbp.load_library(nbody_build)
    log(f"# built {len(point_keys)} instantiation(s) of csrc/point_stages.cu, csrc/quad_lerp.cu, "
        f"csrc/row_gather.cu and csrc/nbody_points.cu in {time.perf_counter() - t0:.1f} s")
    for name, entry in (("quad_lerp", ql.BUILD_LOG.get("quad_lerp")),
                        ("row_gather", rg.BUILD_LOG.get("row_gather")),
                        ("nbody_points", nbp.BUILD_LOG.get("nbody_points"))):
        for line in (entry or {}).get("output", "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"#   ptxas [{name}] {line.strip()}")
    build_info = log_builds(point_keys)

    # ---- phase 2a: every instantiation vs plain on seeded random inputs ----
    cfg, render = make_render(512, "bfloat16", "cuda")
    fast_P = cfg.tpu.samples_per_ray * cfg.tpu.ray_cap
    head_weights = {3: head_weights_of(render)}
    key_rows = []  # the keys beyond FORMS at the fast-mode P: time, bound, error
    for key in point_keys:
        name = ps.form_name(key)
        if key.views not in head_weights:
            head_weights[key.views] = head_weights_of(
                make_views_render(512, "bfloat16", "cuda", key.views)[1])
        # FORMS' keys: the fast-mode shape for form (a), a ragged size for
        # the others (their main-path shape is checked on captured inputs
        # below); the other keys at the fast-mode shape, timed there
        P = fast_P if name == "a" or key not in ps.FORMS else 500003
        weights = head_weights[key.views][sum(t[1] for t in ps.geom_specs(key.geom))]
        tabs, feats, vmask, sig_ok, kw = random_point_inputs(key, P, dev)
        call = (tabs, feats, vmask, sig_ok, weights, kw)
        before = ps.LAUNCHES[name]
        k_out = ps.fused_point_stages_tabs(tabs, feats, vmask, sig_ok, weights, **kw)
        torch.cuda.synchronize()
        check(ps.LAUNCHES[name] == before + 1, f"form {name}: wrapper did not launch its kernel")
        # the switch space's other keys (--all-keys) may each have 2 points
        # beyond the per-point bounds: on these random rows (geometry
        # features up to ~10) a bf16 rounding flip of one large activation
        # can move a point's alpha past them, whichever key runs
        extra = key not in ps.FORMS and key not in cover
        stats = compare_point_stages(k_out, plain_in_chunks(call),
                                     f"point_stages[{name}] vs plain, random inputs, P={P}",
                                     max_outliers=2 if extra else 0)
        if key not in ps.FORMS:
            kern_ms = cuda_ms(lambda: ps.fused_point_stages_tabs(
                tabs, feats, vmask, sig_ok, weights, **kw), 10)
            plain_ms = cuda_ms(lambda: plain_in_chunks(call), 2)
            nb, bound_ms, bound_by = point_stage_cost(call)
            row = {"name": name, "views": key.views, "ms": kern_ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by, "mbytes": nb / 1e6,
                   "max_abs_err": max(stats["max_abs_d_alpha"], stats["max_abs_d_rgb"]),
                   "outliers": stats.get("outliers", 0), **build_info[name]}
            key_rows.append(row)
            log(f"# timing on {card}: point_stages[{name}] kernel {kern_ms:.3f} ms at P={P} "
                f"(seeded inputs), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
                f"{nb / 1e6:.1f} MB)")
        del tabs, feats, vmask, sig_ok, kw, k_out, call
    ps.LAUNCHES.clear()
    if key_rows:
        ms = [r["ms"] for r in key_rows]
        log(f"# keys beyond FORMS on {card}: {len(key_rows)} built and held against plain; "
            f"{min(ms):.3f}-{max(ms):.3f} ms at P={fast_P}, max |d| "
            f"{max(r['max_abs_err'] for r in key_rows):.3e}; keys with a point beyond the "
            f"per-point bounds {sum(r['outliers'] > 0 for r in key_rows)}")
    if all_keys:
        out_dir = os.path.join(ROOT, "results", "chip_smoke")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "all_keys.json"), "w") as f:
            json.dump({"card": smi, "keys": key_rows}, f, indent=1)
        log(f"# --all-keys: {len(point_keys)} keys built and held against plain; per-key rows "
            "in results/chip_smoke/all_keys.json")

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
    frame_out = {}  # title -> [(pred_chw, overflows, counts)] per frame

    def run_mode(title, form_name, n_frames, render, stages=False, frames=None, min_psnr=20.0,
                 sig_overflow=False):
        """Drive one render mode over the first n_frames bench frames (of
        `frames`, (device batches, host batches), else the positive ones),
        check it (every frame's PSNR >= min_psnr; no sigma overflow, or with
        `sig_overflow` one on every frame), compare and time its kernel
        instantiation on the inputs captured from frame 0. Appends to
        `kernels`; returns (frame ms, PSNRs)."""
        batches, host = frames or (pos_batches, pos_host)
        fn = render.render_demo_fn()
        captured = []
        real = demo_mod.fused_point_stages_from_tables

        def capture(*a, **kw):
            captured.append((a, kw))
            return real(*a, **kw)

        demo_mod.fused_point_stages_from_tables = capture
        try:
            fn(batches[0])  # warm (allocator) and capture the kernel's inputs
        finally:
            demo_mod.fused_point_stages_from_tables = real
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
            check(ov[0] == 0 and (ov[2] > 0) == sig_overflow and ov[3] == 0,
                  f"{title} frame {i}: overflows {ov}")
            if not render.tight_cull and render.samples_per_ray == render.n_samples:
                check(ov[1] == 0, f"{title} frame {i}: K = S drops nothing, got {ov}")
            check(bool(torch.isfinite(r["pred_chw"]).all()), f"{title} frame {i}: non-finite image")
            check(tuple(r["pred_chw"].shape) == (3, 512, 512), f"{title} frame {i}: shape")
            psnrs.append(psnr_of(r, hb))
            log(f"# {title} frame {i}: overflows(ray,perrayK,sigma,rgb)={ov} "
                f"counts(rays,sigma,rgb)={counts} PSNR {psnrs[-1]:.3f} dB")
            check(psnrs[-1] >= min_psnr, f"{title} frame {i}: PSNR {psnrs[-1]:.3f} < {min_psnr} dB")
        images[title] = rets[0]["pred_chw"]
        frame_out[title] = [(r["pred_chw"], r["overflows"].tolist(), r["counts"].tolist())
                            for r in rets]

        # kernel vs plain on the inputs captured from frame 0, then timings:
        # the tables entry the render launches, and the rows entry on the
        # rows gathered from the same tables
        t_args, t_kw = captured[0]
        t_args = (*t_args[:4], t_args[4].to(torch.uint8), *t_args[5:])
        (tabs, feats, vmask, sig_ok), kw = ps.gather_from_tables(*t_args[:5], **t_kw)
        weights = t_args[5]
        call = (tabs, feats, vmask, sig_ok, weights, kw)
        P = vmask.shape[-1]
        plain = plain_in_chunks(call)
        t_out = ps.fused_point_stages_from_tables(*t_args, **t_kw)
        torch.cuda.synchronize()
        stats = compare_point_stages(
            t_out, plain, f"point_stages[{form_name}] tables entry vs plain, {title} frame 0 inputs, P={P}")
        k_out = ps.fused_point_stages_tabs(tabs, feats, vmask, sig_ok, weights, **kw)
        torch.cuda.synchronize()
        compare_point_stages(
            k_out, plain, f"point_stages[{form_name}] rows entry vs plain, {title} frame 0 inputs, P={P}")
        same = [float((t == k).all(dim=-1).float().mean()) if t.dim() > 1 else float((t == k).float().mean())
                for t, k in zip(t_out, k_out)]
        log(f"# point_stages[{form_name}], {title} frame 0: tables entry equal to the rows entry "
            f"(alpha, rgb[, occm]) at {', '.join(f'{x:.6f}' for x in same)} of the points")
        del plain, t_out, k_out
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
        reps = 20 if P < 10**6 else 5
        kern_ms = cuda_ms(lambda: ps.fused_point_stages_from_tables(*t_args, **t_kw), reps)
        rows_ms = cuda_ms(lambda: ps.fused_point_stages_tabs(tabs, feats, vmask, sig_ok, weights, **kw),
                          reps)
        gather_ms = cuda_ms(lambda: ps.gather_from_tables(*t_args[:5], **t_kw), reps)
        plain_ms = cuda_ms(lambda: plain_in_chunks(call), 5 if P < 10**6 else 1)
        nbytes, bound_ms, bound_by = point_stage_cost(call)
        log(line + f"; point_stages[{form_name}] tables entry {kern_ms:.3f} ms at P={P}, rows entry "
            f"{rows_ms:.3f} ms after a gather of {gather_ms:.3f} ms, plain {plain_ms:.3f} ms, "
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
            "rows_entry_ms": rows_ms,
            "gather_ms": gather_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
        })
        return frame_ms, psnrs

    run_mode("fast mode", "a", 3, render, stages=True)
    run_mode("fast mode, kernel_octet off", "a+b@bf16", 1,
             make_render(512, "bfloat16", "cuda", kernel_octet=False)[1])
    run_mode("float32, fast mode, kernel_octet off", "a+b", 1,
             make_render(512, "float32", "cuda", kernel_octet=False)[1])
    render_fast = render
    del render
    run_mode("reference mode", "c", 2, make_render(512, "bfloat16", "cuda", **REF_MODE)[1], stages=True)
    for title, form_name, extra in (
        ("reference mode, frame_mode", "c+e", {"frame_mode": True}),
        ("reference mode, sigma_query_cull", "c+e", {"sigma_query_cull": True}),
        ("reference mode, int4_feat", "c+d", {"int4_feat": True}),
        ("reference mode, kernel_octet off", "b+c@bf16", {"kernel_octet": False}),
        ("float32, reference mode, kernel_octet off", "b+c", {"kernel_octet": False}),
    ):
        dtype = "float32" if title.startswith("float32") else "bfloat16"
        run_mode(title, form_name, 1, make_render(512, dtype, "cuda", **REF_MODE, **extra)[1])
        torch.cuda.empty_cache()
    # the windowless frame and the dense slots under the same trilinear cull
    # evaluate the same kernel on the same surviving samples
    m = (images["reference mode, frame_mode"] - images["reference mode, sigma_query_cull"]).abs()
    d_ref = (images["reference mode, frame_mode"] - images["reference mode"]).abs()
    log(f"# frame_mode vs dense slots + sigma_query_cull, frame 0: |d pred| max {float(m.max()):.2e}; "
        f"vs dense slots under the tap alone: mean {float(d_ref.mean()):.2e} max {float(d_ref.max()):.2e} "
        "(the tap keeps the blanket's fringe samples)")
    check(float(m.max()) < 1e-3, "frame_mode and dense slots + sigma_query_cull images differ")

    # ---- phase 3n: native bf16 against float32, the sequence entry ----
    torch.cuda.empty_cache()
    native = native_phase(card, batches, host, profile)
    for k in kernels:
        if k["name"] in ("point_stages[a]", "point_stages[c]"):
            k["launches"] += sum(v[3].get(k["name"][13:-1], 0) for v in native.values())

    # ---- phase 3d: the paper configs' tables and the switch pairs ----
    # configs/trainzju_valzju.yaml and trainthu_valzju.yaml leave
    # merge_lowres_src off: split tables under the tight cull, form (c) at
    # the fast mode's P
    paper = make_render(512, "bfloat16", "cuda", merge_lowres_src=False)[1]
    run_mode("paper tables (split, tight cull)", "c", 3, paper)
    fn_paper = paper.render_demo_fn()
    per_frame = [cuda_ms(lambda: fn_paper(b), 3) for b in batches[:3]]
    log(f"# timing on {card}: paper tables (split, tight cull) ms per frame "
        + " ".join(f"{t:.3f}" for t in per_frame) + " (CUDA events, 3 renders of each frame)")
    del paper, fn_paper
    float_src = [dict(b, src_imgs=b["src_imgs"].float() / 127.5 - 1.0) for b in batches]
    for title, form_name, dtype, extra, frames in (
        ("merge_src_feat", "a:bf16", "bfloat16", {"merge_src_feat": True}, None),
        ("quantize_proj off, merged", "a:bf16", "bfloat16", {"quantize_proj": False}, None),
        ("quantize_proj off, split", "c:u8/bf16", "bfloat16",
         {"quantize_proj": False, "merge_lowres_src": False}, None),
        ("fast mode, sigma_query_cull", "a+e", "bfloat16", {"sigma_query_cull": True}, None),
        ("fast mode, sigma_query_cull, split tables", "c+e", "bfloat16",
         {"sigma_query_cull": True, "merge_lowres_src": False}, None),
        ("split tables, int4_feat", "c+d", "bfloat16",
         {"int4_feat": True, "merge_lowres_src": False}, None),
        ("reference mode, frame_mode + int4_feat", "c+d+e", "bfloat16",
         {**REF_MODE, "frame_mode": True, "int4_feat": True}, None),
        ("reference mode, int4_feat + kernel_octet off", "b+c+d@bf16", "bfloat16",
         {**REF_MODE, "int4_feat": True, "kernel_octet": False}, None),
        ("float32, reference mode, int4_feat + kernel_octet off", "b+c+d", "float32",
         {**REF_MODE, "int4_feat": True, "kernel_octet": False}, None),
        ("reference mode, merge_lowres_src", "a", "bfloat16",
         {**REF_MODE, "merge_lowres_src": True}, None),
        ("float src_imgs, split tables", "c:bf16/i8", "bfloat16",
         {"merge_lowres_src": False}, (float_src, pos_host)),
        ("float32, merge_src_feat", "a:f32", "float32", {"merge_src_feat": True}, None),
        ("float32, quantize_proj off, split", "c:u8/f32", "float32",
         {"quantize_proj": False, "merge_lowres_src": False}, None),
        ("float32, float src_imgs, split tables", "c:f32/i8", "float32",
         {"merge_lowres_src": False}, (float_src, pos_host)),
    ):
        run_mode(title, form_name, 1, make_render(512, dtype, "cuda", **extra)[1], frames=frames)
        torch.cuda.empty_cache()
    del float_src

    # ---- phase 3g: the geometry-table switches ----
    geometry_frames = (
        # the fast mode's merged int8 table, form (a)
        ("coarse_nearest 1", "a", "bfloat16", {"coarse_nearest": 1}),
        ("coarse_nearest 0", "a@coarse-octet", "bfloat16", {"coarse_nearest": 0}),
        ("fold_coarse_fc off", "a@unfolded", "bfloat16", {"fold_coarse_fc": False}),
        ("merge_coarse_octet off", "a@four-level", "bfloat16", {"merge_coarse_octet": False}),
        ("l1_nearest 1", "a@l1-nearest", "bfloat16", {"l1_nearest": 1}),
        ("l1_nearest 2", "a@l1-nearest", "bfloat16", {"l1_nearest": 2}),
        ("l1_nearest 11", "a+b@bf16", "bfloat16", {"l1_nearest": 11}),
        ("int4_coarse", "a+b@bf16", "bfloat16", {"int4_coarse": True}),
        ("pack_octet_u32", "a+b@128-bf16", "bfloat16", {"pack_octet_u32": True}),
        ("float32, pack_octet_u32", "a+b@128", "float32", {"pack_octet_u32": True}),
        ("dense_conv", "a", "bfloat16", {"dense_conv": True}),
        ("quantize_volume off", "a@float", "bfloat16", {"quantize_volume": False}),
        ("float32, quantize_volume off", "a@float32", "float32", {"quantize_volume": False}),
        # the paper configs' split u8/i8 tables, form (c)
        ("paper tables, coarse_nearest 0", "c@coarse-octet", "bfloat16",
         {"merge_lowres_src": False, "coarse_nearest": 0}),
        ("paper tables, fold_coarse_fc off", "c@unfolded", "bfloat16",
         {"merge_lowres_src": False, "fold_coarse_fc": False}),
        ("paper tables, merge_coarse_octet off", "c@four-level", "bfloat16",
         {"merge_lowres_src": False, "merge_coarse_octet": False}),
        ("paper tables, l1_nearest 1", "c@l1-nearest", "bfloat16",
         {"merge_lowres_src": False, "l1_nearest": 1}),
        ("paper tables, quantize_volume off", "c@float", "bfloat16",
         {"merge_lowres_src": False, "quantize_volume": False}),
        # the occupancy cull read from the nearest level-1 table, on its own
        # grid and on the midpoint-doubled one
        ("l1_nearest 1, sigma_query_cull", "a+e@l1-nearest", "bfloat16",
         {"l1_nearest": 1, "sigma_query_cull": True}),
        ("l1_nearest 2, sigma_query_cull", "a+e@l1-nearest", "bfloat16",
         {"l1_nearest": 2, "sigma_query_cull": True}),
    )
    for title, form_name, dtype, extra in geometry_frames:
        r = make_render(512, dtype, "cuda", **extra)[1]
        check(ps.form_name(r.kernel_form()) == form_name,
              f"{title}: the renderer selects {r.kernel_form()}, not {form_name}")
        # the nearest level-1 occupancy on its own grid culls every sample
        # whose nearest level-1 voxel is inactive: 70% of the colored points
        # of bench frame 0, 17.2 dB, as the JAX package renders it (held to
        # it at 128^2 by tests/test_torch_geom_layouts_queried.py); a wiring
        # fault reads near 10 dB
        floor = 15.0 if title == "l1_nearest 1, sigma_query_cull" else 20.0
        run_mode(f"geometry layouts, {title}", form_name, 1, r, min_psnr=floor)
        del r
        torch.cuda.empty_cache()

    # ---- phase 3h: the global sigma compaction and the blanket cull with K < S ----
    def same_as_dense(title, dense_title):
        """Each frame of `title` against the same frame of `dense_title`:
        equal (|d| <= 1e-6, bitwise expected: the kernel works point by
        point) wherever the compaction dropped nothing."""
        for i, ((img, ov, _), (ref, _, _)) in enumerate(zip(frame_out[title], frame_out[dense_title])):
            d = float((img - ref).abs().max())
            log(f"# {title} frame {i} vs {dense_title}: sig_overflow {ov[2]}, |d pred| max {d:.3e}, "
                f"bitwise {bool(torch.equal(img, ref))}")
            check(ov[2] > 0 or d <= 1e-6, f"{title} frame {i}: differs from {dense_title} by {d}")

    # synthetic.yaml's caps: sig_cap 294,912 against K * R = 319,488 slots
    comp = make_render(512, "bfloat16", "cuda", dense_slots=False)[1]
    check(not comp.dense_slots and comp.sigma_cap == 294912 and comp.ray_cap == 24576,
          f"dense_slots off: sigma_cap {comp.sigma_cap}, ray_cap {comp.ray_cap}")
    _, psnr_comp = run_mode("fast mode, dense_slots off", "a", 3, comp)
    same_as_dense("fast mode, dense_slots off", "fast mode")
    # dense and compacted in turns (dense, compacted, compacted, dense), each
    # over the 3 frames 3 times: the host sets the fast frame's time and
    # drifts between phases
    turns = {"dense": [], "compacted": []}
    for name in ("dense", "compacted", "compacted", "dense"):
        fn = (render_fast if name == "dense" else comp).render_demo_fn()
        it = iter(range(10**9))
        turns[name].append(cuda_ms(lambda: fn(batches[next(it) % 3]), 9))
    log(f"# timing on {card}: fast mode in turns, ms/frame: dense slots "
        + " / ".join(f"{t:.3f}" for t in turns["dense"]) + ", dense_slots off "
        + " / ".join(f"{t:.3f}" for t in turns["compacted"]))
    # 4 points per ray: the bench frames' ~100,000 colored points overflow it,
    # so the drop path runs; the deepest slots of every ray go first
    capped = "fast mode, dense_slots off, sigma_cap 98304"
    _, psnr_capped = run_mode(capped, "a", 3,
                              make_render(512, "bfloat16", "cuda", dense_slots=False,
                                          sigma_cap=98304)[1], min_psnr=15.0, sig_overflow=True)
    log(f"# {capped}: sig_overflow per frame {[o[1][2] for o in frame_out[capped]]}, PSNR "
        + " ".join(f"{a:.3f}" for a in psnr_capped) + " dB against the uncapped "
        + " ".join(f"{b:.3f}" for b in psnr_comp) + " dB")
    del comp
    torch.cuda.empty_cache()
    # the blanket cull keeping each ray's nearest 32 of its 64 samples, over
    # the dense (K, R) slots and compacted (sig_cap 2,293,760 at the
    # reference caps, above K * R = 1,835,008)
    for title, extra in (("reference mode, samples_per_ray 32", {}),
                         ("reference mode, samples_per_ray 32, dense_slots off", {"dense_slots": False})):
        run_mode(title, "c", 3, make_render(512, "bfloat16", "cuda",
                                            **{**REF_MODE, "samples_per_ray": 32}, **extra)[1])
        torch.cuda.empty_cache()
    same_as_dense("reference mode, samples_per_ray 32, dense_slots off",
                  "reference mode, samples_per_ray 32")

    # ---- phase 3w: the windowed occupancy tap (splat_bins off, or a window under the blanket) ----
    # the windowed frame_mode evaluates only the K = 13 grid samples from
    # each ray's window start: the JAX package's semantics lose 3.3 dB
    # against the binned fast mode at 384^2 on the CPU (`PYTHONPATH=.
    # python tests/test_torch_window.py 384`: the port within 0.001 dB of
    # JAX), so that frame is held to 15 dB
    for title, form_name, n_frames, extra, min_psnr in (
        ("windowed fast mode (splat_bins off)", "a", 3, {"splat_bins": False}, 20.0),
        ("windowed fast mode, frame_mode", "a+e", 1, {"splat_bins": False, "frame_mode": True},
         15.0),
        ("windowed fast mode, sigma_query_cull", "a+e", 1,
         {"splat_bins": False, "sigma_query_cull": True}, 20.0),
        ("windowed fast mode, dense_slots off", "a", 1,
         {"splat_bins": False, "dense_slots": False}, 20.0),
        # W = 32 of the 64 samples from each ray's front depth, K = 32
        ("reference mode, tap_window 32, samples_per_ray 32", "c", 1,
         {**REF_MODE, "tap_window": 32, "samples_per_ray": 32}, 20.0),
    ):
        r = make_render(512, "bfloat16", "cuda", **extra)[1]
        check(r._uses_window() and not r._uses_bins(), f"{title}: the tap window is off")
        check(r._frame_mode_on() == ("frame_mode" in extra), f"{title}: frame mode")
        run_mode(title, form_name, n_frames, r, min_psnr=min_psnr)
        del r
        torch.cuda.empty_cache()

    # ---- phase 3k: switch sets and view counts whose kernel is built from the key ----
    key_modes = []  # the names of the keys beyond FORMS that the main path launched
    for title, extra, n_frames in (
        ("paper tables, sigma_query_cull, coarse_nearest 0",
         {"merge_lowres_src": False, "sigma_query_cull": True, "coarse_nearest": 0}, 3),
        ("merge_src_feat, sigma_query_cull", {"merge_src_feat": True, "sigma_query_cull": True}, 3),
        # a nearest level-1 table beside the coarse octet table: a mixed
        # geometry layout no GEOMS name holds
        ("l1_nearest 1, coarse_nearest 0", {"l1_nearest": 1, "coarse_nearest": 0}, 1),
        # merged bf16 projection rows beside the coarse octet table
        ("quantize_proj off, coarse_nearest 0", {"quantize_proj": False, "coarse_nearest": 0}, 1),
    ):
        r = make_render(512, "bfloat16", "cuda", **extra)[1]
        key = r.kernel_form()
        check(key not in ps.FORMS, f"{title}: {key} is one of FORMS")
        key_modes.append(ps.form_name(key))
        run_mode(f"built from the key, {title}", key_modes[-1], n_frames, r)
        del r
        torch.cuda.empty_cache()
    # other view counts: the checkpoint's heads with a seeded first rgb_fc
    # layer (its own takes 3 views), so no PSNR gate; the fused frame 0
    # against the op-by-op frame 0 of the same weights on the card
    for views, n_frames in ((4, 3), (2, 1), (8, 1)):
        vcfg, fused = make_views_render(512, "bfloat16", "cuda", views)
        host_v = get_bench_frames(vcfg, n_frames)
        frames_v = ([batch_to_device(b, dev) for b in host_v], host_v)
        check(all(b["src_imgs"].shape[0] == views for b in frames_v[0]),
              f"{views} views: the bench frames hold other view counts")
        title = f"fast mode, {views} views"
        key_modes.append(ps.form_name(fused.kernel_form()))
        check(fused.kernel_form() == ps.Key(("i8",), "default", False, views), title)
        run_mode(title, key_modes[-1], n_frames, fused, frames=frames_v, min_psnr=-math.inf)
        op = make_views_render(512, "bfloat16", "cuda", views, pallas_point=False)[1]
        ret_f = fused.render_demo_fn()(frames_v[0][0])
        ret_o = op.render_demo_fn()(frames_v[0][0])
        for k in ("mask_at_box", "ray_pix_idx", "ray_ok", "overflows"):
            check(torch.equal(ret_f[k], ret_o[k]), f"{title}: fused and op-by-op {k} differ")
        check(torch.equal(ret_f["counts"][:2], ret_o["counts"][:2]),
              f"{title}: fused and op-by-op counts differ")
        m = ret_f["mask_at_box"]
        d = (ret_f["pred_chw"].reshape(3, -1)[:, m] - ret_o["pred_chw"].reshape(3, -1)[:, m]).abs()
        log(f"# {title}, frame 0: fused vs op-by-op on the card: integers bitwise, counts "
            f"{ret_f['counts'].tolist()} vs {ret_o['counts'].tolist()}, |d pred| median "
            f"{float(d.median()):.2e} max {float(d.max()):.2e}")
        check(float(d.median()) <= 2e-3, f"{title}: fused and op-by-op images differ")
        del vcfg, fused, op, host_v, frames_v, ret_f, ret_o
        torch.cuda.empty_cache()

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

    # op-by-op under merge_src_feat: the full-resolution merged table's bf16
    # rows through the quad-lerp kernel
    title = "op-by-op fast mode, merge_src_feat"
    op_src = make_render(512, "bfloat16", "cuda", pallas_point=False, merge_src_feat=True)[1]
    captured = []
    ql.quad_lerp_rows_vcp = capture_vcp
    try:
        op_src.render_demo_fn()(batches[0])
    finally:
        ql.quad_lerp_rows_vcp = real_vcp
    check(len(captured) == 1 and captured[0][0].dtype == torch.bfloat16,
          f"{title}: one quad lerp of bf16 rows per frame")
    rets = run_opbyop(title, 1, op_src, 1)
    bf_launches = ql.LAUNCHES["quad_lerp_rows_vcp"]
    image_gap(title, rets[0]["pred_chw"], "merge_src_feat", 0.1, 5e-4)
    l_rows, l_w4, l_scale, l_kw = captured[0]
    l_out = ql.quad_lerp_rows_vcp(l_rows, l_w4, l_scale, **l_kw)
    l_plain = ql.quad_lerp_rows_vcp_plain(l_rows, l_w4, l_scale, **l_kw)
    check(same_bits(l_out, l_plain), f"quad_lerp_rows_vcp differs from plain on the {title} rows")
    k_ms = cuda_ms(lambda: ql.quad_lerp_rows_vcp(l_rows, l_w4, l_scale, **l_kw), 20)
    p_ms = cuda_ms(lambda: ql.quad_lerp_rows_vcp_plain(l_rows, l_w4, l_scale, **l_kw), 5)
    nb, bound_ms, bound_by = lerp_cost(l_rows, l_w4, l_scale, l_out)
    log(f"# timing on {card}: quad_lerp_rows_vcp kernel {k_ms:.4f} ms at rows {tuple(l_rows.shape)} "
        f"{l_rows.dtype} -> {l_out.dtype} ({title}, bitwise equal to plain), plain {p_ms:.3f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}, {nb / 1e6:.1f} MB)")
    kernels.append({
        "name": "quad_lerp_rows_vcp[bf16 rows]", "route": "cuda",
        "source": "gpnerf_tpu_torch/csrc/quad_lerp.cu",
        "replaces": "gpnerf_tpu/ops/pallas_lerp.py:125", "launches": bf_launches,
        "max_abs_err": float((l_out.float() - l_plain.float()).abs().max()),
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes the lerp
    })
    del captured, l_rows, l_w4, l_out, l_plain, rets, op_src
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
    nb, _ = rg.cost(g_table, g_idx)  # the table read once, the rows written once
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
    # without bins the window is off under neg-ray: the tap walks all 64
    # samples from the far end
    neg_tap = make_render(512, "bfloat16", "cuda", neg=True, splat_bins=False)[1]
    check(not neg_tap._uses_window() and not neg_tap._uses_bins(),
          "neg-ray fast mode, splat_bins off: the window or the bins are on")
    run_mode("neg-ray fast mode, splat_bins off (tap over every sample)", "a", 1, neg_tap,
             frames=neg_frames)
    del neg_tap
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
    # the window's integers (front depth, window start, tap) as on the CPU;
    # a border row's sample can flip a view in or out as above
    card_vs_cpu_128("windowed fast mode", 0.4, exact=True, ray_cap=16384, splat_bins=False)

    # ---- phase 3m: the mesh path ----
    torch.cuda.empty_cache()
    mesh_phase(card)

    # ---- phase 3n: Neural Body's point-network kernel ----
    torch.cuda.empty_cache()
    kernels.append(nbody_phase(card))
    torch.cuda.empty_cache()

    # ---- phase 5: the training path ----
    torch.cuda.empty_cache()
    f32 = train_phase(card, profile)
    torch.cuda.empty_cache()
    train_phase(card, profile, neg=True)
    torch.cuda.empty_cache()

    # ---- phase 5b: bf16 mixed-precision training ----
    bf16 = train_phase(card, profile, train_dtype="bfloat16")
    for k in kernels:
        if k["name"] == "point_stages[a]":
            k["launches"] += f32["launches"] + bf16["launches"]
    fmt = lambda r: (" / ".join(f"{x:.4f}" for x in r["s_per_it"])  # noqa: E731
                     + f" s/it, peak {r['peak_gib']:.3f} GiB, eval PSNR {r['psnr']:.3f} dB")
    log(f"# training on {card}, the same call: float32 {fmt(f32)}; bfloat16 {fmt(bf16)} "
        f"(min / median / max; bf16 / float32 median {bf16['s_per_it'][1] / f32['s_per_it'][1]:.3f})")
    torch.cuda.empty_cache()
    multi_frame_epoch(card)
    torch.cuda.empty_cache()
    bf16_step_card_vs_cpu()
    bf16_stages_card_vs_cpu()
    torch.cuda.empty_cache()
    bench = train_bench_runs(card)
    log(f"# train bench on {card}: s/it float32 {bench['float32']['s_per_it']}, bfloat16 "
        f"{bench['bfloat16']['s_per_it']}")

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

    # ---- phase 7: the spconv 2.x layout, the tools, data parallelism ----
    torch.cuda.empty_cache()
    layout_phase()
    torch.cuda.empty_cache()
    tools_phase(card)
    torch.cuda.empty_cache()
    dp_phase(card, f32["s_per_it"])
    by_name = {k["name"]: k for k in kernels}

    # ---- phase 7d: the diagnostic tools, each a process of its own ----
    torch.cuda.empty_cache()
    for name, count in diag_tools_phase(card).items():
        by_name[name]["launches"] += count

    # ---- phase 8: the port's bench, a process of its own ----
    torch.cuda.empty_cache()
    bench_launches, fast_line = bench_phase(card)
    for launches in bench_launches.values():  # the fused modes: kernel 1's forms
        for form, count in launches.items():
            by_name[f"point_stages[{form}]"]["launches"] += count

    # ---- phase 8r: the roofline ----
    torch.cuda.empty_cache()
    roofline_phase(card, profile, fast_line)

    log(f"# total {time.perf_counter() - t_all:.1f} s")
    want = {f"point_stages[{n}]" for n in [*ps.FORMS.values(), *key_modes]} | {
        "quad_lerp_rows_vcp", "quad_lerp_rows_vcp[bf16 rows]", "quad_lerp_rows_cm", "row_gather",
        "nbody_points"}
    check(len(kernels) == len(want) == len(ps.FORMS) + len(key_modes) + 5
          and {k["name"] for k in kernels} == want and all(k["launches"] >= 1 for k in kernels),
          f"kernels line: {[(k['name'], k['launches']) for k in kernels]}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
