"""Benchmark of the PyTorch/CUDA port: 512x512 progressive full-image
rendering, frames per second on one card.

bench.py's protocols, modes and checks on the port (gpnerf_tpu_torch):
configs/synthetic.yaml at 512x512 with `head.sigma.code_dim 32` and the
demo renderer, the 10 frames of the bench protocol (utils/bench_frames.py),
the trained checkpoint `artifacts/bench_ckpt.pth` (or `BENCH_CKPT`), timed
with CUDA events on the card.

    python3 bench_torch.py [dotted.cfg overrides ...]   # e.g. tpu.frame_mode True

It runs on the GPU; `device cpu` among the overrides selects the CPU, where
the times are the host clock's and the lines say `cpu`. Without a card and
without `device cpu` it raises.

Modes, each written to BENCH_MODES_torch.json at the root as it completes:
  * fast (the config's speed defaults): one bare JSON line on stdout,
    {"metric", "value" (fps), "unit", "mfu", "psnr", "ssim", "device",
    "nvidia_smi"}, then `#` lines on stderr (scan and loop ms per frame, the
    loop's reps and host dispatch ms, the per-frame spread by scan
    isolation, the overflows and counts);
  * reference semantics (`BENCH_REF`, default on): the blanket cull, all 64
    samples, no tap window, full-resolution source rgb and raised caps;
    `BENCH_REF_FRAME=1` adds `tpu.frame_mode`; a `# ref-mode {...}` line;
  * neg-ray (`BENCH_NEG`, default on): the scene in THuman's OpenGL camera
    convention (`dataset.test.name thuman-synthetic`); a `# neg-ray {...}`
    line.

Two timing protocols, as in bench.py: the loop renders every frame through
`render_demo_fn()` per rep (best of the reps reported, and the host's time
to enqueue each rep), and the scan renders the frames `scan_cycles` times
through one call of `render_demo_scan_fn()` (the headline where a mode has
it). Per-frame time: `iso_cycles` renders of one frame in one scan call,
or, in the reference mode (no scan), one event pair around each frame.

The headline guard (`headline_guard`) refuses a result, exits non-zero and
prints no line for it when the scan's overflows, counts or checksums differ
from the loop's for the same frames, when the scan's ms per frame is below
half the loop's best (the scan renders the same frames through the same
code), when `mfu` exceeds 1, or when `pct_hbm_roof` exceeds 100.

`mfu`: analytic FLOPs per frame (`analytic_flops_per_frame`) times fps over
the card's published dense peak for `tpu.matmul_dtype`
(utils/roofline.py `PEAK_FLOP_PER_S`). `roofline` (bench.py's key, there
from XLA's cost analysis): `counted_GB_per_frame`, the mean over the bench
frames of one counted, untimed fast render each (utils/roofline.py
`counting`: the eager ops' operands and results, each hand-written kernel
by its declared cost), `achieved_GBps` (that over the scan's ms per frame),
`pct_hbm_roof` (its share of the card's `HBM_BYTES_PER_S`) and `peak_GBps`.
Each is left out, with the reason on stderr, on the CPU and for a card or
dtype the tables do not hold. bench.py's `vs_baseline` (fps over a TPU
target) has no counterpart here.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

from gpnerf_tpu_torch.utils.roofline import counting, peak_bytes_per_s, peak_flop_per_s

ROOT = os.path.dirname(os.path.abspath(__file__))
RECORD = "BENCH_MODES_torch.json"
N_FRAMES = 10
# the headline guard's bounds: the scan renders the loop's frames through
# the loop's code, so it is not twice as fast; an mfu above 1, or a share of
# the HBM roof above 100%, is a timing or counting fault; the checksums of
# the same frame agree to float32 sums in another order
SCAN_FLOOR = 0.5
MFU_CEIL = 1.0
ROOF_PCT_CEIL = 100.0
CHECKSUM_RTOL = 1e-5
# the reference-semantics mode (bench.py:372-397): the reference's blanket
# cull over all 64 samples, no tap window, full-resolution source rgb, caps
# sized drop-free on the bench frames
REF_MODE = {
    "tight_cull": False, "samples_per_ray": 64, "tap_window": 0, "merge_lowres_src": False,
    "ray_cap": 57344, "sigma_cap": 2293760, "rgb_cap": 1048576,
}


def analytic_flops_per_frame(H, W, counts, n_smpl=6890, code_dim=32,
                             feat_ch=32):
    """Analytic model FLOPs for one progressive frame (multiply-adds x 2):
    ResNet34-UNet encoder on 3 source views, vertex-code MHA fusion, the
    sparse conv stack, and the per-point query/density/color MLPs at the
    frame's measured point counts. Gathers/scatters/compaction are excluded
    (they are bandwidth, not FLOPs) — so this MFU is a lower bound on how
    far the gather stages sit from the compute roofline."""
    V = 3
    f = 0.0
    # encoder (conv layers, stride tracked; BasicBlock = 2 convs [+1x1 ds])
    h, w = H // 2, W // 2
    f += 2 * 7 * 7 * 3 * 64 * h * w  # stem
    cin = 64
    for planes, blocks in ((64, 3), (128, 4), (256, 6)):
        h, w = h // 2, w // 2
        for b in range(blocks):
            ci = cin if b == 0 else planes
            f += 2 * 9 * ci * planes * h * w * 2  # conv1+conv2
            if b == 0:
                f += 2 * ci * planes * h * w  # 1x1 downsample
        cin = planes
    # decoder (upconv3/iconv3 at H/8, upconv2/iconv2 at H/4, out 1x1)
    h8, w8 = H // 8, W // 8
    h4, w4 = H // 4, W // 4
    f += 2 * 9 * 256 * 128 * h8 * w8 + 2 * 9 * (128 + 128) * 128 * h8 * w8
    f += 2 * 9 * 128 * 64 * h4 * w4 + 2 * 9 * (64 + 64) * feat_ch * h4 * w4
    f += 2 * feat_ch * feat_ch * h4 * w4
    f *= V
    # MHA fusion: qkv projections + attention over V keys + out proj
    f += 2 * n_smpl * (code_dim * code_dim + 2 * V * feat_ch * code_dim
                       + 2 * V * code_dim + code_dim * code_dim)
    # sparse conv stack (subm0 x2 + per level: stride + 2 subm), 27-tap
    sites = [6890, 15400, 6900, 1900, 500]  # measured typical actives
    dims = [(code_dim, code_dim)] * 2
    f += sum(2 * 27 * ci * co * sites[0] for ci, co in dims)
    cin = code_dim
    for lvl in range(4):
        f += 2 * 27 * cin * 32 * sites[lvl + 1]          # strided
        f += 2 * 27 * 32 * 32 * sites[lvl + 1] * 2       # double conv
        cin = 32
    n_rays, n_sigma, n_rgb = counts
    # per-point: trilinear lerps (4 levels x 8 taps x 32ch) + Linear 128->64
    # + density MLP + color MLP
    f += n_sigma * (2 * 4 * 8 * 32 + 2 * 128 * 64)
    f += n_sigma * 2 * (134 * 64 + 64 * 32 + 32 * 16 + 16)
    f += n_rgb * 2 * (3 * (105 * 64 + 64 * 32 + 2 * 32 * 32) + 96 * 32
                      + 32 * 16 + 16 * 3)
    return f


def card_of(device):
    """(device name, the `nvidia-smi` name and power limit line): ("cpu",
    None) off the card."""
    import torch

    if device.type != "cuda":
        return "cpu", None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return torch.cuda.get_device_name(device), smi.stdout.strip().splitlines()[0]


class Timer:
    """Milliseconds between two marks: CUDA events on the card (device
    time), the host clock on the CPU (where every op is synchronous)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def sync(self):
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        import torch

        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def ms(self, a, b):
        if not self.cuda:
            return (b - a) * 1e3
        b.synchronize()
        return a.elapsed_time(b)


def frame_counters(rets):
    """Per-frame overflows, counts and checksums (render/demo.py
    `frame_checksum`, the scan's own) of the loop's render dicts, as lists."""
    from gpnerf_tpu_torch.render.demo import frame_checksum

    return {
        "overflows": [r["overflows"].tolist() for r in rets],
        "counts": [r["counts"].tolist() for r in rets],
        "checksum": [float(frame_checksum(r)) for r in rets],
    }


def launch_counts():
    """The kernel wrappers' launch counters, merged."""
    from gpnerf_tpu_torch.ops import point_stages, quad_lerp, row_gather

    return {**point_stages.LAUNCHES, **quad_lerp.LAUNCHES, **row_gather.LAUNCHES}


def clear_launch_counts():
    from gpnerf_tpu_torch.ops import point_stages, quad_lerp, row_gather

    for mod in (point_stages, quad_lerp, row_gather):
        mod.LAUNCHES.clear()


def run_mode(render, cfg, *, reps=3, scan_cycles=3, iso_cycles=5, batches=None, host=None):
    """Time the progressive renderer and measure full-protocol PSNR/SSIM
    (train/evaluator.Evaluator) on the frames `host` (host batches; their
    device copies `batches`, made here when None), bench.py's `run_mode`:

      * loop: `reps` passes of `render_demo_fn()` over the frames, one
        timer pair around each pass; the best pass, every pass, and the
        host's time to enqueue each;
      * scan (`scan_cycles` > 0): one warm call of `render_demo_scan_fn()`
        over order = range(n) * scan_cycles, then one timed call; its
        overflows, counts and checksums are returned beside the loop's for
        `headline_guard`; per-frame time by scan isolation: order = [i] *
        iso_cycles for each frame after one warm call of that length;
      * without a scan (the reference mode): one timer pair around each
        frame of one more pass.

    Returns bench.py's keys (fps, ms_per_frame, fps_loop, loop_ms_per_frame,
    loop_reps_ms, loop_dispatch_ms, loop_dispatch_reps_ms, frame_ms_spread,
    overflows, counts_max, counts_mean, psnr, ssim) and `device`, `timer`,
    `launches` (kernel launches per pass, counted by the wrappers on the
    card), `loop_frames` and `scan_frames` (per-frame counters, None
    without a scan)."""
    import torch

    from gpnerf_tpu_torch.render.base import batch_to_device
    from gpnerf_tpu_torch.render.demo import stack_frames
    from gpnerf_tpu_torch.train.evaluator import Evaluator

    if host is None:
        raise ValueError("run_mode needs the host frames `host`")
    device = next(render.parameters()).device
    dbs = [batch_to_device(b, device) for b in host] if batches is None else batches
    n = len(dbs)
    timer = Timer(device)
    fn = render.render_demo_fn()
    # warm: the first call builds the point-stage kernel's library for its key
    fn(dbs[0])
    fn(dbs[1 % n])
    timer.sync()

    clear_launch_counts()
    loop_ms, disp_ms, rets = [], [], None
    for _ in range(reps):
        a = timer.mark()
        t0 = time.perf_counter()
        rets = [fn(b) for b in dbs]
        disp_ms.append((time.perf_counter() - t0) * 1e3)
        loop_ms.append(timer.ms(a, timer.mark()))
    launches = {k: v // reps for k, v in launch_counts().items()}
    loop_best = min(loop_ms)

    scan_ms = scan_frames = None
    if scan_cycles:
        stacked = stack_frames(dbs)
        sfn = render.render_demo_scan_fn()
        order = torch.arange(n, device=device).repeat(scan_cycles)
        sfn(stacked, order)
        timer.sync()
        a = timer.mark()
        souts = sfn(stacked, order)
        scan_ms = timer.ms(a, timer.mark()) / len(order)
        scan_frames = {
            "overflows": souts["overflows"].tolist(),
            "counts": souts["counts"].tolist(),
            "checksum": [float(c) for c in souts["checksum"]],
        }
        # per-frame device time: one call of iso_cycles renders of frame i
        sfn(stacked, torch.zeros(iso_cycles, dtype=torch.long, device=device))
        frame_ms = []
        for i in range(n):
            oi = torch.full((iso_cycles,), i, dtype=torch.long, device=device)
            timer.sync()
            a = timer.mark()
            sfn(stacked, oi)
            frame_ms.append(timer.ms(a, timer.mark()) / iso_cycles)
        del stacked
    else:
        timer.sync()
        marks = []
        for b in dbs:
            a = timer.mark()
            fn(b)
            marks.append((a, timer.mark()))
        frame_ms = [timer.ms(a, b) for a, b in marks]
    frame_ms = np.asarray(frame_ms)

    loop_frames = frame_counters(rets)
    all_over = np.asarray(loop_frames["overflows"])
    all_counts = np.asarray(loop_frames["counts"])
    ev = Evaluator(cfg, "bench")
    for r, b in zip(rets, host):
        ev.evaluate(r, b)  # scores pred_img_hwc(r) over mask_at_box
    ms = scan_ms if scan_ms is not None else loop_best / n
    return {
        "fps": 1e3 / ms,
        "ms_per_frame": ms,
        "fps_loop": n / loop_best * 1e3,
        "loop_ms_per_frame": loop_best / n,
        "loop_reps_ms": [round(d / n, 3) for d in loop_ms],
        # the host's time to enqueue the best pass, and every pass's
        "loop_dispatch_ms": round(disp_ms[int(np.argmin(loop_ms))], 3),
        "loop_dispatch_reps_ms": [round(d, 3) for d in disp_ms],
        "frame_ms_spread": [round(float(f), 3) for f in
                            (frame_ms.min(), np.median(frame_ms), frame_ms.max())],
        "overflows": all_over.max(axis=0).tolist(),
        "counts_max": all_counts.max(axis=0).tolist(),
        "counts_mean": all_counts.mean(axis=0).tolist(),
        "psnr": float(np.mean(ev.psnr)),
        "ssim": float(np.mean(ev.ssim)),
        "device": device.type,
        "timer": "cuda events" if device.type == "cuda" else "host clock",
        "launches": launches,
        "loop_frames": loop_frames,
        "scan_frames": scan_frames,
    }


def frame_roofline(render, batches, ms_per_frame, device_name):
    """bench.py's `roofline` key on the port: the mean bytes of one counted,
    untimed `render_demo_fn()` call on each of `batches` (utils/roofline.py
    `counting`), over `ms_per_frame`, as a share of the card's HBM peak.
    None, with the reason on stderr, where `HBM_BYTES_PER_S` holds no peak
    for `device_name` (the CPU among them)."""
    peak = peak_bytes_per_s(device_name)
    if peak is None:
        why = "on the CPU" if device_name == "cpu" else f"no published HBM peak for {device_name!r}"
        print(f"# roofline left out: {why} (utils/roofline.py HBM_BYTES_PER_S)", file=sys.stderr)
        return None
    fn = render.render_demo_fn()
    device = next(render.parameters()).device
    total = 0
    for b in batches:
        with counting(device) as c:
            fn(b)
        total += c.bytes
    gb = total / len(batches) / 1e9
    gbps = gb / (ms_per_frame / 1e3)
    return {"counted_GB_per_frame": gb, "achieved_GBps": gbps,
            "pct_hbm_roof": gbps / (peak / 1e9) * 100.0, "peak_GBps": peak / 1e9}


def headline_guard(rec, mfu=None, pct_hbm_roof=None):
    """The reasons to refuse `rec` (a run_mode result), its `mfu` and its
    `pct_hbm_roof`; empty when sound. Refused: a time that is not positive
    and finite; a scan frame whose overflows or counts differ from the
    loop's for the same frame, or whose checksum differs by more than
    CHECKSUM_RTOL of it; a scan ms per frame below SCAN_FLOOR of the loop's
    best; mfu above MFU_CEIL; a share of the HBM roof above ROOF_PCT_CEIL
    percent (more bytes a second than the card moves)."""
    reasons = []
    for k in ("ms_per_frame", "loop_ms_per_frame"):
        if not (math.isfinite(rec[k]) and rec[k] > 0):
            reasons.append(f"{k} {rec[k]} is not a positive time")
    scan, loop = rec.get("scan_frames"), rec["loop_frames"]
    if scan is not None:
        n = len(loop["checksum"])
        for j, ck in enumerate(scan["checksum"]):
            i = j % n
            for k in ("overflows", "counts"):
                if scan[k][j] != loop[k][i]:
                    reasons.append(f"scan frame {j} (frame {i}): {k} {scan[k][j]} differ from "
                                   f"the loop's {loop[k][i]}")
            want = loop["checksum"][i]
            if not abs(ck - want) <= CHECKSUM_RTOL * abs(want):
                reasons.append(f"scan frame {j} (frame {i}): checksum {ck!r} differs from the "
                               f"loop's {want!r} by more than {CHECKSUM_RTOL:g} of it")
        if not rec["ms_per_frame"] >= SCAN_FLOOR * rec["loop_ms_per_frame"]:
            reasons.append(f"scan {rec['ms_per_frame']:.6g} ms/frame is below {SCAN_FLOOR:g} x the "
                           f"loop's best {rec['loop_ms_per_frame']:.6g} ms/frame")
    if mfu is not None and not mfu <= MFU_CEIL:
        reasons.append(f"mfu {mfu!r} is above {MFU_CEIL:g}")
    if pct_hbm_roof is not None and not pct_hbm_roof <= ROOF_PCT_CEIL:
        reasons.append(f"pct_hbm_roof {pct_hbm_roof!r} is above {ROOF_PCT_CEIL:g}")
    return reasons


def refuse_unsound(title, rec, mfu=None, pct_hbm_roof=None):
    """Exit non-zero, naming the reasons, when headline_guard refuses."""
    reasons = headline_guard(rec, mfu, pct_hbm_roof)
    if reasons:
        raise SystemExit(f"bench_torch: {title} refused: " + "; ".join(reasons))


def write_record(modes, root=ROOT):
    """BENCH_MODES_torch.json under `root`, through a temporary file."""
    path = os.path.join(root, RECORD)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(modes, f, indent=1)
    os.replace(tmp, path)
    return path


def bench_cfg(argv):
    """configs/synthetic.yaml, then the flagship protocol (512x512,
    code_dim 32, the demo renderer), then the overrides (bench.py:90-106)."""
    from gpnerf_tpu_torch.config import cfg as default_cfg

    cfg = default_cfg.clone()
    cfg.defrost()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "synthetic.yaml"))
    cfg.dataset.H = 512
    cfg.dataset.W = 512
    cfg.dataset.ratio = 1.0
    cfg.head.sigma.code_dim = 32
    cfg.render.file = "demo_render"
    if argv:
        cfg.merge_from_list(list(argv))
    cfg.freeze()
    return cfg


def ref_cfg(cfg, frame_mode=False):
    """The reference-semantics mode's config (REF_MODE; `frame_mode` on
    under BENCH_REF_FRAME=1)."""
    out = cfg.clone()
    out.defrost()
    for k, v in REF_MODE.items():
        out.tpu[k] = v
    out.tpu.frame_mode = bool(frame_mode) or out.tpu.frame_mode
    out.freeze()
    return out


def neg_cfg(cfg):
    """The neg-ray mode's config: the synthetic scene served in THuman's
    OpenGL camera convention."""
    out = cfg.clone()
    out.defrost()
    out.dataset.test.name = "thuman-synthetic"
    out.freeze()
    return out


def load_weights(render, cfg, batch):
    """The checkpoint `BENCH_CKPT` (default artifacts/bench_ckpt.pth) when
    it exists; else fresh parameters (render/base `init_variables(0)`) and
    25 train-mode volume passes on `batch`, so that the BatchNorm running
    statistics (and the occupancy cull) behave as a trained model's
    (bench.py:134-154). Returns the state dict every mode loads."""
    import torch

    from gpnerf_tpu_torch.render.base import build_render, prepare_frame, src_norm
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model

    ckpt = os.environ.get("BENCH_CKPT", os.path.join(ROOT, "artifacts", "bench_ckpt.pth"))
    if os.path.exists(ckpt):
        load_eval_model(ckpt, render)
        print(f"# loaded {ckpt}", file=sys.stderr)
        return render.state_dict()
    render.load_state_dict(build_render(cfg, device="cpu").init_variables(0).state_dict())
    with torch.no_grad():
        featmaps = render.encoder(src_norm(batch["src_imgs"]))
        pre = prepare_frame(batch, featmaps, render.max_out_sh, neg_ray=render.neg_ray_val)
        for _ in range(25):
            render.nerfhead.volume(pre["smpl_feat"], pre["vertex_rows"], pre["grids"], train=True)
    print(f"# no checkpoint at {ckpt}: fresh parameters, BatchNorm statistics warmed",
          file=sys.stderr)
    return render.state_dict()


def mode_line(metric, rec, device_name, smi):
    return {
        "metric": metric,
        "value": round(rec["fps"], 3),
        "unit": "frames/sec/device",
        "psnr": round(rec["psnr"], 3),
        "ssim": round(rec["ssim"], 4),
        "device": device_name,
        "nvidia_smi": smi,
    }


def main(argv=None, root=ROOT):
    argv = sys.argv[1:] if argv is None else list(argv)
    import torch

    from gpnerf_tpu_torch.utils.dist import select_device

    device = select_device(argv)  # the card, or `device cpu`; never a fallback

    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render.base import batch_to_device
    from gpnerf_tpu_torch.utils.bench_frames import get_bench_frames

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = bench_cfg(argv)
    name, smi = card_of(device)
    H, W = int(cfg.dataset.H), int(cfg.dataset.W)

    # host batch prep stays out of every timed window (the reference's
    # DataLoader workers); frames stride across the test set
    host_batches = get_bench_frames(cfg, N_FRAMES)
    dev_batches = [batch_to_device(b, device) for b in host_batches]
    render = get("render", cfg.render.file)(cfg, device=device)
    state = load_weights(render, cfg, dev_batches[0])

    def build(cfg_m):
        r = get("render", cfg_m.render.file)(cfg_m, device=device)
        r.load_state_dict(state)
        return r.eval()

    fast = run_mode(render, cfg, batches=dev_batches, host=host_batches)
    roof = frame_roofline(render, dev_batches, fast["ms_per_frame"], name)
    del render
    peak = peak_flop_per_s(name, cfg.tpu.matmul_dtype)
    mfu = None
    if peak is None:
        why = "on the CPU" if device.type == "cpu" else (
            f"no published peak for {name!r} in {cfg.tpu.matmul_dtype} (PEAK_FLOP_PER_S)")
        print(f"# mfu left out: {why}", file=sys.stderr)
    else:
        flops = analytic_flops_per_frame(H, W, fast["counts_mean"],
                                         code_dim=cfg.head.sigma.code_dim)
        mfu = flops * fast["fps"] / peak
    refuse_unsound("fast mode", fast, mfu, roof and roof["pct_hbm_roof"])
    fast_line = mode_line(f"synthetic-body {H}x{W} progressive render", fast, name, smi)
    if mfu is not None:
        fast_line["mfu"] = round(mfu, 6)
    if roof is not None:
        fast_line["roofline"] = fast["roofline"] = roof
    print(json.dumps(fast_line), flush=True)
    print(
        f"# {fast['ms_per_frame']:.3f} ms/frame (scan); loop {fast['loop_ms_per_frame']:.3f} "
        f"ms/frame (reps {fast['loop_reps_ms']}, dispatch {fast['loop_dispatch_ms']} ms per pass, "
        f"per-frame (scan-isolated) min/med/max {fast['frame_ms_spread']} ms); max "
        f"overflows(ray,perrayK,sigma,rgb)={fast['overflows']}; max counts(rays,sigma,rgb)="
        f"{fast['counts_max']}; launches per pass {fast['launches']}; device={name} "
        f"({smi}; {fast['timer']})",
        file=sys.stderr, flush=True,
    )
    if roof is not None:
        print(f"# roofline: counted {roof['counted_GB_per_frame']:.4f} GB/frame -> "
              f"{roof['achieved_GBps']:.2f} GB/s at {fast['ms_per_frame']:.3f} ms/frame = "
              f"{roof['pct_hbm_roof']:.3f}% of {roof['peak_GBps']:.0f} GB/s (per-stage: "
              "tools/roofline_torch.py)", file=sys.stderr, flush=True)
    modes = {"fast": {**fast_line, **fast}}
    write_record(modes, root)

    if os.environ.get("BENCH_REF", "1") != "0":
        cfg_ref = ref_cfg(cfg, frame_mode=os.environ.get("BENCH_REF_FRAME", "0") == "1")
        render_ref = build(cfg_ref)
        # ~90 ms per frame: no scan, one rep fewer
        ref = run_mode(render_ref, cfg_ref, reps=2, scan_cycles=0, batches=dev_batches,
                       host=host_batches)
        del render_ref
        refuse_unsound("reference mode", ref)
        ref_line = mode_line(f"reference-cull-semantics {H}x{W} progressive render", ref, name, smi)
        print("# ref-mode " + json.dumps(ref_line), flush=True)
        print(f"# ref-mode {ref['ms_per_frame']:.3f} ms/frame (loop; reps {ref['loop_reps_ms']}, "
              f"dispatch {ref['loop_dispatch_ms']} ms per pass, per-frame min/med/max "
              f"{ref['frame_ms_spread']} ms); max overflows={ref['overflows']}; max counts="
              f"{ref['counts_max']}; launches per pass {ref['launches']}", file=sys.stderr, flush=True)
        modes["reference_semantics"] = {**ref_line, **ref}
        write_record(modes, root)

    if os.environ.get("BENCH_NEG", "1") != "0":
        cfg_neg = neg_cfg(cfg)
        render_neg = build(cfg_neg)
        if not render_neg.neg_ray_val:
            raise RuntimeError("dataset.test.name thuman-synthetic did not select neg-ray rendering")
        neg_host = get_bench_frames(cfg_neg, N_FRAMES)
        neg_dev = [batch_to_device(b, device) for b in neg_host]
        neg = run_mode(render_neg, cfg_neg, reps=2, scan_cycles=3, batches=neg_dev, host=neg_host)
        del render_neg, neg_dev
        refuse_unsound("neg-ray mode", neg)
        neg_line = mode_line(f"neg-ray (THuman-convention) {H}x{W} progressive render", neg,
                             name, smi)
        print("# neg-ray " + json.dumps(neg_line), flush=True)
        print(f"# neg-ray {neg['ms_per_frame']:.3f} ms/frame (scan); loop "
              f"{neg['loop_ms_per_frame']:.3f} (reps {neg['loop_reps_ms']}, dispatch "
              f"{neg['loop_dispatch_ms']} ms per pass, per-frame min/med/max {neg['frame_ms_spread']} ms); "
              f"max overflows={neg['overflows']}; max counts={neg['counts_max']}; launches per "
              f"pass {neg['launches']}", file=sys.stderr, flush=True)
        modes["thuman_neg_ray"] = {**neg_line, **neg}
        write_record(modes, root)
    return modes


if __name__ == "__main__":
    main()
