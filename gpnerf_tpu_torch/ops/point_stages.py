"""Per-point stages of the progressive renderer in one kernel
(gpnerf_tpu/ops/pallas_point.py, the TPU megakernel `_point_kernel`).

`fused_point_stages` takes the raw gathered rows of the merged int8
[rgb|feat] projection quad table with their tap weights, the raw rows of
the two geometry tables (u8 level-1 octet rows with 8 corner weights, int8
folded-coarse nearest rows with their in-bounds weight), the view mask, the
sample-cull mask and the head weights, and returns the sigma-masked alpha
(P,) and the alpha-culled rgb (P, 3) — the only tensors the composite
needs. Between them: quad lerp + dequant, mean/var over views, geometry
lerp, sigma-feat linear, density MLP, color MLP (see csrc/point_stages.cu).

Numerics: every dot input is rounded to bf16 and accumulates in float32;
activations, lerps and masks are float32.

On a CPU tensor the wrapper runs `point_stages_plain`, the same function in
torch ops; on a CUDA tensor it launches the CUDA kernel (built from
csrc/point_stages.cu at first use into gpnerf_tpu_torch/_build/) or raises.
`fused_point_stages.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import List, NamedTuple, Tuple

import torch

from gpnerf_tpu_torch.models.layers import rounded
from gpnerf_tpu_torch.ops.grid_sample import lerp_rows

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "point_stages.cu")
BUILD_DIR = os.path.join(_PKG, "_build")

# the form the CUDA kernel is written for (csrc/point_stages.cu constants)
V, C, C0, C1 = 3, 35, 32, 64


class PointWeights(NamedTuple):
    """Head weights for the point stages: `layers` = 12 (W (Cout, Cin),
    b (Cout,)) float32 pairs in order [sigma-feat, density d0..d3, base b0
    b1, vis v0 v1, rgb r0..r2]; `flat` = the same, bf16-rounded and laid out
    for the kernel's shared memory (4 outputs interleaved per input,
    outputs padded to a multiple of 4, then all biases)."""

    layers: List[Tuple[torch.Tensor, torch.Tensor]]
    flat: torch.Tensor


def pack_head_weights(nerfhead, fold_nch=None) -> PointWeights:
    """Flatten a NeRFHead's MLPs into PointWeights.

    `fold_nch`: the merged coarse table was built with out_geometry_fc's
    coarse block pre-applied (render/demo.py fold_coarse_fc), so the
    geometry input is [raw level-1 (fold_nch) | pre-multiplied coarse (64)]
    and the sigma-feat weight becomes [W[:, :fold_nch] | I_64]."""
    sf = nerfhead.sigmahead.out_geometry_fc[0]
    w_sf = sf.weight
    if fold_nch is not None:
        n_out = w_sf.shape[0]
        eye = torch.eye(n_out, dtype=w_sf.dtype, device=w_sf.device)
        w_sf = torch.cat([w_sf[:, :fold_nch], eye], dim=1)
    rh = nerfhead.rgbhead
    lins = [m for m in (*rh.out_geometry_fc, *rh.base_fc, *rh.vis_fc, *rh.rgb_fc)
            if isinstance(m, torch.nn.Linear)]
    layers = [(w_sf, sf.bias)] + [(m.weight, m.bias) for m in lins]
    layers = [(w.detach().float(), b.detach().float()) for w, b in layers]
    return PointWeights(layers, _kernel_layout(layers))


def _kernel_layout(layers):
    ws, bs = [], []
    for w, b in layers:
        cout, cin = w.shape
        g = -(-cout // 4)
        wp = w.new_zeros(g * 4, cin)
        wp[:cout] = rounded(w, torch.bfloat16)
        ws.append(wp.reshape(g, 4, cin).transpose(1, 2).reshape(-1))
        bs.append(b)
    return torch.cat(ws + bs).contiguous()


def _elu(x):
    return torch.where(x > 0, x, torch.exp(torch.clamp(x, max=0.0)) - 1.0)


def _dense(layer, x):
    w, b = layer
    return rounded(x, torch.bfloat16) @ rounded(w, torch.bfloat16).T + b


def point_stages_plain(rows, w4, pscale, geom_tabs, vmask, sig_ok,
                       weights: PointWeights):
    """The kernel's function in torch ops.

    rows (V*P, 4C) int8 quad rows, view-major; w4 (V, 4, P) tap weights;
    pscale (C,) dequant factors; geom_tabs = ((rows (P, Tg*Cg), w (Tg, P),
    scale (Cg,)), ...) concatenated in order; vmask (V, P) float; sig_ok (P,)
    bool. Returns alpha (P,), rgb (P, 3) float32."""
    nv_, _, P = w4.shape
    Cp = pscale.shape[0]
    r = rows.reshape(nv_, P, 4, Cp)
    rf = r[:, :, 0].float() * w4[:, 0, :, None]
    for k in range(1, 4):
        rf = rf + r[:, :, k].float() * w4[:, k, :, None]
    rf = rf * pscale  # (V, P, C)
    mean = rf[0]
    for v in range(1, nv_):
        mean = mean + rf[v]
    mean = mean / float(nv_)
    var = (rf[0] - mean) ** 2
    for v in range(1, nv_):
        var = var + (rf[v] - mean) ** 2
    var = var / float(nv_)
    f = torch.cat([lerp_rows(g, w.T, s) for g, w, s in geom_tabs], dim=-1)
    L = weights.layers
    sf = _elu(_dense(L[0], f))
    h = _elu(_dense(L[1], torch.cat([sf, mean, var], dim=-1)))
    h = _elu(_dense(L[2], h))
    h = _elu(_dense(L[3], h))
    sigma = torch.relu(_dense(L[4], h))[:, 0]
    nv = vmask[0]
    for v in range(1, nv_):
        nv = nv + vmask[v]
    ok = sig_ok.bool()
    sigma = torch.where((nv < 1.0) | ~ok, 0.0, sigma)
    alpha = 1.0 - torch.exp(-sigma)
    hs = []
    for v in range(nv_):
        hv = _elu(_dense(L[5], torch.cat([mean, var, rf[v]], dim=-1)))
        hv = _elu(_dense(L[6], hv))
        h2 = _elu(_dense(L[7], hv / float(nv_)))
        h2 = _elu(_dense(L[8], h2))
        hs.append(hv + h2)
    x = _elu(_dense(L[9], torch.cat(hs, dim=-1)))
    x = _elu(_dense(L[10], x))
    rgb = torch.sigmoid(_dense(L[11], x))
    alive = (alpha > 1e-14) & ok
    return alpha, torch.where(alive[:, None], rgb, 0.0)


# ---------------------------------------------------------------------------
# CUDA build + launch
# ---------------------------------------------------------------------------

_lib = None
BUILD_LOG = {}


def _nvcc():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    return cand if os.path.exists(cand) else (shutil.which("nvcc") or cand)


def build_command():
    """(nvcc argv, library path) for the current source; the library name
    carries the source hash, so an edited source rebuilds."""
    with open(SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    lib = os.path.join(BUILD_DIR, f"libpoint_stages_{tag}.so")
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", lib, SOURCE,
    ]
    return cmd, lib


def load_library(proc=None):
    """Build (unless the hashed library exists) and load the kernel.
    `proc`: an already started nvcc Popen of build_command() to wait on."""
    global _lib
    if _lib is not None:
        return _lib
    cmd, lib_path = build_command()
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        if proc is None:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCE}:\n{out}")
        BUILD_LOG.update(seconds=time.perf_counter() - t0, output=out)
    lib = ctypes.CDLL(lib_path)
    vp = ctypes.c_void_p
    lib.point_stages_launch.argtypes = [vp] * 14 + [ctypes.c_int, vp]
    lib.point_stages_launch.restype = ctypes.c_int
    lib.point_stages_wbuf_floats.restype = ctypes.c_int
    _lib = lib
    return lib


def _check(t, dtype, shape, name):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise NotImplementedError(
            f"point-stage kernel: {name} must be {dtype} {tuple(shape)}, got "
            f"{t.dtype} {tuple(t.shape)}"
        )
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"point-stage kernel: {name} must be contiguous and "
                         "16-byte aligned")


def _launch(rows, w4, pscale, geom_tabs, vmask, sig_ok, weights):
    P = w4.shape[-1]
    if len(geom_tabs) != 2:
        raise NotImplementedError("point-stage kernel takes 2 geometry tables")
    (g0, gw0, gs0), (g1, gw1, gs1) = geom_tabs
    f32 = torch.float32
    _check(rows, torch.int8, (V * P, 4 * C), "rows")
    _check(w4, f32, (V, 4, P), "w4")
    _check(pscale, f32, (C,), "pscale")
    _check(g0, torch.uint8, (P, 8 * C0), "level-1 octet rows")
    _check(gw0, f32, (8, P), "level-1 octet weights")
    _check(gs0, f32, (C0,), "level-1 scale")
    _check(g1, torch.int8, (P, C1), "coarse nearest rows")
    _check(gw1, f32, (1, P), "coarse nearest weight")
    _check(gs1, f32, (C1,), "coarse scale")
    _check(vmask, f32, (V, P), "vmask")
    _check(sig_ok, torch.uint8, (P,), "sig_ok")
    lib = load_library()
    flat = weights.flat
    _check(flat, f32, (lib.point_stages_wbuf_floats(),), "packed weights")
    tensors = (rows, w4, pscale, g0, gw0, gs0, g1, gw1, gs1, vmask, sig_ok, flat)
    if any(t.device != rows.device for t in tensors):
        raise ValueError("point-stage kernel: inputs on different devices")
    alpha = torch.empty(P, dtype=f32, device=rows.device)
    rgb = torch.empty(P, 3, dtype=f32, device=rows.device)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    err = lib.point_stages_launch(
        *(t.data_ptr() for t in tensors), alpha.data_ptr(), rgb.data_ptr(),
        P, stream,
    )
    if err != 0:
        raise RuntimeError(f"point-stage kernel launch failed: CUDA error {err}")
    fused_point_stages.launches += 1
    return alpha, rgb


def fused_point_stages(rows, w4, pscale, geom_tabs, vmask, sig_ok,
                       weights: PointWeights):
    """Point stages on the device the inputs live on: the plain torch
    version for CPU tensors, the CUDA kernel for CUDA tensors. Same
    arguments and returns as `point_stages_plain` (sig_ok as uint8/bool)."""
    if rows.device.type == "cpu":
        return point_stages_plain(rows, w4, pscale, geom_tabs, vmask, sig_ok, weights)
    if rows.device.type != "cuda":
        raise ValueError(f"point stages: unsupported device {rows.device}")
    return _launch(rows, w4, pscale, geom_tabs, vmask,
                   sig_ok.to(torch.uint8), weights)


fused_point_stages.launches = 0
