"""Quad lerp of gathered projection rows (gpnerf_tpu/ops/pallas_lerp.py):
the 4-tap bilinear weighted sum plus per-channel dequantization, written
channel-major with points innermost, the orientation the point stages read.

  quad_lerp_rows_vcp(rows (V*P, 4C) view-major, w4 (V, 4, P), scale (C,))
      -> (V, C, P)
  quad_lerp_rows_cm(rows (N, 4C), w4 (4, N), scale (C,)) -> (C, N)

out[.., c, p] = scale[c] * sum_k w4[.., k, p] * rows[.., p, k*C + c]: tap k of
channel c sits at column k*C + c (ops/grid_sample.build_quad_table_2d), the
weights carry the in-bounds masks, and the dequantization factor multiplies
the sum. Rows are int8 or uint8 codes, or float32 fields that are rounded to
bf16 first (as the TPU kernel casts them); the sum runs in float32 from 0 in
the order k = 0..3 and is rounded once to `out_dtype`.

On a CPU tensor each wrapper runs its plain version (`*_plain`, the same
function in torch ops); on a CUDA tensor it launches the kernel of
csrc/quad_lerp.cu, built at first use (ops/cuda_build.py), or raises.
Kernel and plain version agree bitwise. `LAUNCHES` counts launches per
wrapper name.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from gpnerf_tpu_torch.models.layers import rounded
from gpnerf_tpu_torch.ops import cuda_build

LAUNCHES = collections.Counter()
BUILD_LOG = {}
_BUILD = ("quad_lerp.cu", "quad_lerp")
_ROW_TYPES = {torch.int8: 0, torch.uint8: 1, torch.float32: 2}
_OUT_TYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def quad_lerp_rows_vcp_plain(rows_vmajor, w4, scale, *, out_dtype=torch.bfloat16):
    """The view-major kernel's function in torch ops; see the module
    docstring. Returns (V, C, P) `out_dtype`."""
    V, _, P = w4.shape
    C = rows_vmajor.shape[-1] // 4
    r = rows_vmajor.reshape(V, P, 4, C)
    if r.is_floating_point():
        r = rounded(r, torch.bfloat16)
    acc = torch.zeros(V, P, C, dtype=torch.float32, device=rows_vmajor.device)
    for k in range(4):
        acc = acc + r[:, :, k].float() * w4[:, k, :, None]
    return (acc * scale.float()).to(out_dtype).transpose(1, 2).contiguous()


def quad_lerp_rows_cm_plain(rows, w4, scale, *, out_dtype=torch.bfloat16):
    """The flat channel-major kernel's function in torch ops: rows (N, 4C),
    w4 (4, N) -> (C, N) `out_dtype`."""
    return quad_lerp_rows_vcp_plain(rows, w4[None], scale, out_dtype=out_dtype)[0]


def start_build():
    """Start nvcc for csrc/quad_lerp.cu unless its library exists; returns
    the Popen (or None) to hand to load_library."""
    return cuda_build.start_build(*_BUILD)


def load_library(proc=None):
    """Build (unless the hashed library exists) and load the kernels."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(*_BUILD, proc=proc, build_log=BUILD_LOG, log_key="quad_lerp")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.quad_lerp_vcp_launch.argtypes = [vp] * 4 + [ci] * 5 + [vp]
        lib.quad_lerp_cm_launch.argtypes = [vp] * 4 + [ci] * 4 + [vp]
        lib.quad_lerp_max_channels.argtypes = [ci]
        for fn in (lib.quad_lerp_vcp_launch, lib.quad_lerp_cm_launch,
                   lib.quad_lerp_max_channels):
            fn.restype = ci
        _lib = lib
    return _lib


def _checked(rows, w4, scale, w4_shape, out_dtype, what):
    """Validate one launch's tensors; returns (lib, C, row type, out type)."""
    n_rows, C4 = rows.shape
    C = C4 // 4
    if rows.dtype not in _ROW_TYPES or out_dtype not in _OUT_TYPES:
        raise NotImplementedError(
            f"{what}: rows {rows.dtype} -> {out_dtype} has no kernel (rows int8, "
            "uint8 or float32; output float32 or bfloat16)")
    if C4 != 4 * C or tuple(w4.shape) != w4_shape or tuple(scale.shape) != (C,):
        raise ValueError(
            f"{what}: rows {tuple(rows.shape)}, w4 {tuple(w4.shape)} (expected "
            f"{w4_shape}), scale {tuple(scale.shape)} do not fit together")
    if w4.dtype != torch.float32 or scale.dtype != torch.float32:
        raise NotImplementedError(f"{what}: w4 and scale must be float32")
    for name, t in (("rows", rows), ("w4", w4), ("scale", scale)):
        if t.device != rows.device or not t.is_contiguous() or t.data_ptr() % 4:
            raise ValueError(f"{what}: {name} must be contiguous, 4-byte aligned "
                             "and on the rows' device")
    if n_rows >= 2**31:
        raise NotImplementedError(f"{what}: {n_rows} rows exceed the kernel's int32 counts")
    lib = load_library()
    if C > lib.quad_lerp_max_channels(_ROW_TYPES[rows.dtype]):
        raise NotImplementedError(f"{what}: C={C} exceeds the kernel's shared-memory tile")
    return lib, C, _ROW_TYPES[rows.dtype], _OUT_TYPES[out_dtype]


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def quad_lerp_rows_vcp(rows_vmajor, w4, scale, *, out_dtype=torch.bfloat16):
    """View-major quad lerp on the device the rows live on: the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors. rows (V*P, 4C) int8,
    uint8 or float32; w4 (V, 4, P) f32; scale (C,) f32 -> (V, C, P)."""
    dev = rows_vmajor.device
    if dev.type == "cpu":
        return quad_lerp_rows_vcp_plain(rows_vmajor, w4, scale, out_dtype=out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"quad_lerp_rows_vcp: unsupported device {dev}")
    V, P = w4.shape[0], w4.shape[-1]
    if rows_vmajor.shape[0] != V * P:
        raise ValueError(f"quad_lerp_rows_vcp: {rows_vmajor.shape[0]} rows for V*P = {V * P}")
    lib, C, rt, ot = _checked(rows_vmajor, w4, scale, (V, 4, P), out_dtype,
                              "quad_lerp_rows_vcp")
    out = torch.empty(V, C, P, dtype=out_dtype, device=dev)
    if P == 0:
        return out
    _raise_on(lib.quad_lerp_vcp_launch(
        rows_vmajor.data_ptr(), w4.data_ptr(), scale.data_ptr(), out.data_ptr(),
        V, P, C, rt, ot, torch.cuda.current_stream(dev).cuda_stream), "quad_lerp_rows_vcp")
    LAUNCHES["quad_lerp_rows_vcp"] += 1
    return out


def quad_lerp_rows_cm(rows, w4, scale, *, out_dtype=torch.bfloat16):
    """Flat channel-major quad lerp: rows (N, 4C), w4 (4, N) f32, scale (C,)
    f32 -> (C, N); plain version on the CPU, CUDA kernel on CUDA tensors."""
    dev = rows.device
    if dev.type == "cpu":
        return quad_lerp_rows_cm_plain(rows, w4, scale, out_dtype=out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"quad_lerp_rows_cm: unsupported device {dev}")
    N = rows.shape[0]
    lib, C, rt, ot = _checked(rows, w4, scale, (4, N), out_dtype, "quad_lerp_rows_cm")
    out = torch.empty(C, N, dtype=out_dtype, device=dev)
    if N == 0:
        return out
    _raise_on(lib.quad_lerp_cm_launch(
        rows.data_ptr(), w4.data_ptr(), scale.data_ptr(), out.data_ptr(),
        N, C, rt, ot, torch.cuda.current_stream(dev).cuda_stream), "quad_lerp_rows_cm")
    LAUNCHES["quad_lerp_rows_cm"] += 1
    return out
