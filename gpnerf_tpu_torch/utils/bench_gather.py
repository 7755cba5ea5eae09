"""Microbenchmark of gather strategies (the JAX package's
tools/bench_gather.py, which grounds the design of the trilinear query and
the occupancy cull): row gathers from a (20480, 32) table in float32 and
bfloat16, `index_select`, scalar gathers from a 48*192*192 volume, a one-hot
matmul gather, and the hand-written row-gather kernel (ops/row_gather.py).

`run(device)` returns the measurements as a dict; tools/bench_gather_torch.py
prints them. Times are the minimum of 5 calls after one warm call: CUDA
events on a card, the host clock on the CPU, where they say nothing about a
card.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gpnerf_tpu_torch.ops import row_gather as rg

TABLE_ROWS, CHANNELS = 20480, 32
VOLUME = 48 * 192 * 192
ONEHOT_TILE = 1024


def _min_ms(fn, device, reps=5):
    """(minimum milliseconds over `reps` calls after a warm call, result)."""
    out = fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return min(times), out


def onehot_gather(table, idx):
    """Gather by matmul: per tile of queries a bf16 one-hot (tile, rows)
    times the bf16 table, accumulated in float32."""
    t16 = table.to(torch.bfloat16)
    ids = torch.arange(table.shape[0], device=table.device)
    outs = []
    for s in range(0, idx.shape[0], ONEHOT_TILE):
        oh = (idx[s:s + ONEHOT_TILE, None] == ids[None, :]).to(torch.bfloat16)
        outs.append((oh @ t16).float())
    return torch.cat(outs)


def run(device, n_queries=8 * 1024 * 1024, seed=0):
    """Time each strategy on `device` ("cuda" or "cpu"). `n_queries` row
    gathers (8M: the 8-corner x 1M-point pattern); the scalar gathers run at
    n_queries / 2 and 4 * n_queries (4M and 32M), the one-hot matmul at
    n_queries / 8 (1M). Returns {"device", "n_queries", "<name>_ms"...,
    "row_gather_f32_gb_s", "kernel_row_gather_gb_s", "kernel_launches"};
    the kernel's result is checked against the plain gather."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    t32 = torch.from_numpy(
        rng.standard_normal((TABLE_ROWS, CHANNELS)).astype(np.float32)).to(device)
    t16 = t32.to(torch.bfloat16)
    idx = torch.from_numpy(rng.integers(0, TABLE_ROWS, n_queries).astype(np.int32)).to(device)
    idx64 = idx.long()
    vol = torch.from_numpy(rng.standard_normal(VOLUME).astype(np.float32)).to(device)
    n_small, n_large = max(n_queries // 2, 1), 4 * n_queries
    sidx = torch.from_numpy(rng.integers(0, VOLUME, n_small)).to(device)
    sidx_large = torch.from_numpy(rng.integers(0, VOLUME, n_large)).to(device)
    n_onehot = max(n_queries // 8, 1)

    res = {
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "n_queries": n_queries,
    }
    res["row_gather_f32_ms"], ref = _min_ms(lambda: t32[idx64], device)
    res["row_gather_f32_gb_s"] = n_queries * CHANNELS * 4 / res["row_gather_f32_ms"] / 1e6
    res["row_gather_bf16_ms"], _ = _min_ms(lambda: t16[idx64], device)
    res["index_select_f32_ms"], _ = _min_ms(lambda: torch.index_select(t32, 0, idx), device)
    res[f"scalar_gather_{n_small}_ms"], _ = _min_ms(lambda: vol[sidx], device)
    res[f"scalar_gather_{n_large}_ms"], _ = _min_ms(lambda: vol[sidx_large], device)
    res[f"onehot_matmul_{n_onehot}_ms"], oh = _min_ms(
        lambda: onehot_gather(t32, idx64[:n_onehot]), device)
    if not torch.equal(oh, t16[idx64[:n_onehot]].float()):
        raise RuntimeError("one-hot matmul gather disagrees with the row gather")
    before = rg.LAUNCHES["row_gather"]
    out = rg.row_gather(t32, idx)  # first use builds the kernel
    res["kernel_launches"] = rg.LAUNCHES["row_gather"] - before
    if not torch.equal(out, ref):
        raise RuntimeError("row_gather disagrees with the plain gather")
    res["kernel_row_gather_ms"], _ = _min_ms(lambda: rg.row_gather(t32, idx), device)
    res["kernel_row_gather_gb_s"] = n_queries * CHANNELS * 4 / res["kernel_row_gather_ms"] / 1e6
    res["kernel_row_gather_bf16_ms"], out16 = _min_ms(lambda: rg.row_gather(t16, idx), device)
    if not torch.equal(out16, t16[idx64]):
        raise RuntimeError("row_gather (bf16) disagrees with the plain gather")
    return res
