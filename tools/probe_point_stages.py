#!/usr/bin/env python3
"""Where the point-stage kernel (gpnerf_tpu_torch/csrc/point_stages.cu)
spends its time on the card, for forms (a) and (c) at the main-path sizes
(P = 319,488 and 3,670,016) on the seeded tables of tests/point_tables.py:

  1. CUDA-event times of the kernel and of three probes built from the same
     source: the weight staging only, the front end only (lerps, mean/var,
     geometry, tiles written), the MLP only (every lane treated as past P:
     no loads, zero tiles, all twelve layers);
  2. clock64() marks between the kernel's phases (staging, front end,
     density MLP, each view's color layers, rgb layers), read back for the
     warps of one block in the middle of the grid;
  3. on the inputs of bench frame 0 at 512^2 (the fast mode for form (a),
     the reference semantics for form (c), the trained checkpoint): the
     kernel and its probes, as the renderer launches them.

    python3 tools/probe_point_stages.py

The probes are edited copies of the source, built by ops/cuda_build.py into
gpnerf_tpu_torch/_build/. Exits non-zero without a CUDA device.
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

FORMS = {"a": ((("i8",), "default", False), 319488),
         "c": ((("u8", "i8"), "default", False), 3670016)}
MLP = "  // ---- sigma-feat linear + density MLP, on tensor cores ----"
PROBES = {
    "staging only": [("  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;",
                      "  if (P > 0) return;\n  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;")],
    "front end only": [(MLP, "  if (P > 0) {\n    if (live) a.alpha_out[p] = __bfloat162float(xx[lane * KX + 64]) + "
                             "__bfloat162float(xf[lane * KF]);\n    return;\n  }\n" + MLP)],
    "MLP only": [("  const bool live = p < P;", "  const bool live = p < P && P < 0;")],
}
# (anchor, mark placed before it) for the clock64() breakdown
PHASES = [("front end", MLP), ("density MLP", "  // ---- color MLP"),
          ("color, 3 views", "  bf16* const r1 = xf;"), ("rgb layers", "  const bool alive = alpha")]
BLOCK_PROBED = 1000


def edited(src, edits):
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"probe anchor not found once in point_stages.cu: {old!r}")
        src = src.replace(old, new)
    return src


def clock_source(src):
    mark = ("if (blockIdx.x == %d && (threadIdx.x & 31) == 0) "
            "ps_clock[(threadIdx.x >> 5) * 8 + %%d] = clock64();" % BLOCK_PROBED)
    edits = [("namespace {\n", "__device__ long long ps_clock[32 * 8];\nnamespace {\n"),
             ('extern "C" {\n', 'extern "C" {\nint probe_clock(void* h) { return (int)cudaMemcpyFromSymbol('
                               'h, ps_clock, sizeof(ps_clock)); }\n'),
             ("  extern __shared__ __align__(128) unsigned char smem[];",
              "  extern __shared__ __align__(128) unsigned char smem[];\n  " + mark % 0),
             ("  const bool live = p < P;", "  const bool live = p < P;\n  " + mark % 1)]
    edits += [(anchor, "  " + mark % (i + 2) + "\n" + anchor) for i, (_, anchor) in enumerate(PHASES)]
    return edited(src, edits)


def main():
    import torch

    import chip_smoke as cs
    from gpnerf_tpu_torch.ops import cuda_build
    from gpnerf_tpu_torch.ops import point_stages as ps

    if not torch.cuda.is_available():
        print("no CUDA device: tools/probe_point_stages.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    src = open(ps.SOURCE).read()
    variants = {"kernel": src, **{k: edited(src, e) for k, e in PROBES.items()},
                "clock64 marks": clock_source(src)}
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    builds = {}
    for vname, text in variants.items():
        fname = "probe_" + vname.replace(" ", "_") + ".cu"
        with open(os.path.join(cuda_build.BUILD_DIR, fname), "w") as f:
            f.write(text)
        for name, (form, _) in FORMS.items():
            args = (os.path.join("..", "_build", fname), f"probe_{vname.replace(' ', '_')}_{name}",
                    ps._build_args(form)[2])
            builds[vname, name] = (args, cuda_build.start_build(*args))
    vp = ctypes.c_void_p
    libs = {}
    for key, (args, proc) in builds.items():
        libs[key] = ps.bind_library(cuda_build.load(*args, proc=proc))
    dev = torch.device("cuda")
    pt = cs.point_tables()
    saved = dict(ps._libs)
    try:
        for name, (form, P) in FORMS.items():
            form = ps.check_key(form)
            args, kw = pt.seeded_tables(form, P, device=dev)

            def call():
                return ps.fused_point_stages_from_tables(*args, **kw)

            times = {}
            for vname in [v for v in variants if v != "clock64 marks"] * 2:  # two rounds, in turn
                ps._libs[form] = libs[vname, name]
                times.setdefault(vname, []).append(cs.cuda_ms(call, 10 if P < 10**6 else 4))
            print(f"# probe on {card}: form ({name}) P={P}, ms (two rounds): "
                  + "; ".join(f"{k} {v[0]:.4f} {v[1]:.4f}" for k, v in times.items()), flush=True)
            lib = libs["clock64 marks", name]
            lib.probe_clock.argtypes, lib.probe_clock.restype = [vp], ctypes.c_int
            ps._libs[form] = lib
            call()
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * (32 * 8))()
            if lib.probe_clock(ctypes.addressof(buf)) != 0:
                raise RuntimeError("probe_clock failed")
            labels = ["staging"] + [p for p, _ in PHASES]
            for w in (0, 1, 7):
                t = buf[w * 8: w * 8 + 6]
                print(f"# clock64 on {card}: form ({name}) block {BLOCK_PROBED} warp {w}: {t[5] - t[0]} cycles; "
                      + ", ".join(f"{lab} {t[i + 1] - t[i]}" for i, lab in enumerate(labels)), flush=True)
            del args, kw
            torch.cuda.empty_cache()
            ps._libs[form] = libs["kernel", name]
            frame_probe(name, form, card, libs, variants)
            torch.cuda.empty_cache()
    finally:
        ps._libs.clear()
        ps._libs.update(saved)
    return 0


def frame_probe(name, form, card, libs, variants):
    """Part 3 for one form: the kernel and its probes, timed in turn over
    two rounds on frame 0's inputs."""
    import torch

    import chip_smoke as cs
    from bench_torch import REF_MODE
    from gpnerf_tpu_torch.ops import point_stages as ps
    from gpnerf_tpu_torch.render import demo
    from gpnerf_tpu_torch.render.base import batch_to_device
    from gpnerf_tpu_torch.utils.bench_frames import get_bench_frames

    cfg, render = cs.make_render(512, "bfloat16", "cuda", **(REF_MODE if name == "c" else {}))
    batch = batch_to_device(get_bench_frames(cfg, 1)[0], torch.device("cuda"))
    captured, real = [], demo.fused_point_stages_from_tables
    demo.fused_point_stages_from_tables = lambda *a, **k: captured.append((a, k)) or real(*a, **k)
    try:
        with torch.no_grad():
            render.render_demo_fn()(batch)
    finally:
        demo.fused_point_stages_from_tables = real
    args, kw = captured[0]
    args = (*args[:4], args[4].to(torch.uint8), *args[5:])
    P = args[1].shape[0]
    reps = 10 if P < 10**6 else 4
    times = {}
    for _ in range(2):
        for vname in [v for v in variants if v != "clock64 marks"]:
            ps._libs[form] = libs[vname, name]
            times.setdefault(vname, []).append(
                cs.cuda_ms(lambda: ps.fused_point_stages_from_tables(*args, **kw), reps))
        ps._libs[form] = libs["kernel", name]
    print(f"# probe on {card}: form ({name}) on bench frame 0's inputs, P={P}, ms (two rounds): "
          + "; ".join(f"{k} {v[0]:.4f} {v[1]:.4f}" for k, v in times.items()), flush=True)


if __name__ == "__main__":
    sys.exit(main())
