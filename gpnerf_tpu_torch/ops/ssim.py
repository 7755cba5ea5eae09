"""SSIM matching `skimage.measure.compare_ssim(multichannel=True)` (a
copy of gpnerf_tpu/ops/ssim.py).

The reference's SSIM metric (reference libs/evaluators/if_nerf.py:
20-47) calls old-skimage compare_ssim with all defaults on float images:
win_size=7 uniform (non-gaussian) windows, K1=0.01, K2=0.03, sample
covariance, per-channel SSIM averaged, and — the widely-inherited quirk —
data_range defaulting to the float dtype range (-1, 1), i.e. **2.0**, even
for [0, 1] images. Reproduced exactly for metric parity (SURVEY.md §7).
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter


def ssim_single_channel(x, y, win_size=7, data_range=2.0, K1=0.01, K2=0.03):
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    NP = win_size**2
    cov_norm = NP / (NP - 1)  # sample covariance (skimage default)

    filt = lambda im: uniform_filter(im, size=win_size)
    ux, uy = filt(x), filt(y)
    uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    R = data_range
    C1 = (K1 * R) ** 2
    C2 = (K2 * R) ** 2
    A1, A2 = 2 * ux * uy + C1, 2 * vxy + C2
    B1, B2 = ux**2 + uy**2 + C1, vx + vy + C2
    S = (A1 * A2) / (B1 * B2)

    pad = (win_size - 1) // 2
    return S[pad:-pad, pad:-pad].mean() if pad else S.mean()


def compare_ssim(x, y, multichannel=False, win_size=7, data_range=2.0):
    """Drop-in for the reference's compare_ssim call signature."""
    if multichannel:
        vals = [
            ssim_single_channel(x[..., c], y[..., c], win_size, data_range)
            for c in range(x.shape[-1])
        ]
        return float(np.mean(vals))
    return float(ssim_single_channel(x, y, win_size, data_range))
