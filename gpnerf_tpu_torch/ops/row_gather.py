"""Row gather out[i, :] = table[idx[i], :] as a hand-written kernel (the
in-kernel gather `pallas_gather` of the JAX package's tools/bench_gather.py,
which holds the table in VMEM; here the table stays in the card's L2 cache,
see csrc/row_gather.cu).

`row_gather(table (T, C), idx (N,))` returns (N, C) in the table's dtype.
Rows may be any dtype whose row is a multiple of 4 bytes (float32 and
bfloat16 rows are what the microbenchmark uses); indices are int32 or int64
and in range by contract, as in that microbenchmark. On a CPU tensor the
wrapper runs `row_gather_plain`; on a CUDA tensor it launches the kernel,
built at first use (ops/cuda_build.py), or raises. `LAUNCHES` counts kernel
launches; a count (utils/roofline.py) takes each call at its declared `cost`.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from gpnerf_tpu_torch.ops import cuda_build
from gpnerf_tpu_torch.utils import roofline

LAUNCHES = collections.Counter()
BUILD_LOG = {}
_BUILD = ("row_gather.cu", "row_gather")
_lib = None


def row_gather_plain(table, idx):
    """The kernel's function in torch ops."""
    return table[idx.long()]


def cost(table, idx):
    """(bytes, FLOPs) of one call (utils/roofline.py): the table, which the
    kernel reads once into the L2 cache, and the indices read once, the (N,
    C) rows written once; no FLOPs."""
    return roofline.nbytes(table, idx) + idx.shape[0] * table.shape[1] * table.element_size(), 0


def start_build():
    """Start nvcc for csrc/row_gather.cu unless its library exists; returns
    the Popen (or None) to hand to load_library."""
    return cuda_build.start_build(*_BUILD)


def load_library(proc=None):
    """Build (unless the hashed library exists) and load the kernel."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(*_BUILD, proc=proc, build_log=BUILD_LOG, log_key="row_gather")
        vp = ctypes.c_void_p
        lib.row_gather_launch.argtypes = [vp, vp, vp, ctypes.c_longlong,
                                          ctypes.c_int, ctypes.c_int, vp]
        lib.row_gather_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def row_gather(table, idx):
    """table (T, C), idx (N,) int32/int64 -> (N, C): the plain version for
    CPU tensors, the CUDA kernel for CUDA tensors."""
    with roofline.note_kernel("row_gather", *cost(table, idx)):
        return _row_gather(table, idx)


def _row_gather(table, idx):
    dev = table.device
    if dev.type == "cpu":
        return row_gather_plain(table, idx)
    if dev.type != "cuda":
        raise ValueError(f"row_gather: unsupported device {dev}")
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"row_gather: table {tuple(table.shape)}, idx {tuple(idx.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise NotImplementedError(f"row_gather: idx must be int32 or int64, got {idx.dtype}")
    row_bytes = table.shape[1] * table.element_size()
    if row_bytes == 0 or row_bytes % 4:
        raise NotImplementedError(
            f"row_gather: rows of {row_bytes} bytes; the kernel copies 4-byte words")
    for name, t in (("table", table), ("idx", idx)):
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"row_gather: {name} must be contiguous, 16-byte "
                             "aligned and on the table's device")
    lib = load_library()
    n = idx.shape[0]
    out = torch.empty(n, table.shape[1], dtype=table.dtype, device=dev)
    if n == 0:
        return out
    err = lib.row_gather_launch(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), n, row_bytes,
        int(idx.dtype == torch.int64), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"row_gather kernel launch failed: CUDA error {err}")
    LAUNCHES["row_gather"] += 1
    return out
