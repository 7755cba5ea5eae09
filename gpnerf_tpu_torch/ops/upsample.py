"""Bilinear upsampling with align_corners=True as separable matmuls
(gpnerf_tpu/ops/upsample.py): out = A_h @ x @ A_w^T with A built once in
numpy — the same arithmetic as the JAX package, so the two encoders agree
to float32 rounding."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) align_corners=True linear interpolation matrix."""
    A = np.zeros((n_out, n_in), dtype=np.float32)
    if n_in == 1:
        A[:, 0] = 1.0
        return A
    src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    w = (src - lo).astype(np.float32)
    A[np.arange(n_out), lo] += 1.0 - w
    A[np.arange(n_out), hi] += w
    return A


def upsample_bilinear_nchw(x, scale: int = 2):
    """x: (N, C, H, W) -> (N, C, H*scale, W*scale), align_corners=True.
    A bf16 input is widened and the result is float32, as JAX promotes the
    product of its float32 matrices with a bf16 tensor."""
    _, _, H, W = x.shape
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    Ah = torch.from_numpy(_interp_matrix(H, H * scale)).to(x.device)
    Aw = torch.from_numpy(_interp_matrix(W, W * scale)).to(x.device)
    x = torch.einsum("oh,nchw->ncow", Ah, x)
    return torch.einsum("pw,ncow->ncop", Aw, x)
