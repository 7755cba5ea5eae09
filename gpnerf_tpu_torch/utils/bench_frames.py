"""The bench frame protocol (gpnerf_tpu/utils/bench_frames.py): frames
stride across the test set, and both stdlib `random` and `np.random` are
seeded with the item's position before it is built (eval view selection
draws from stdlib random, data/base.py select_views)."""

from __future__ import annotations

import random

import numpy as np


def get_bench_frames(cfg, n_frames):
    """The first `n_frames` items of the bench protocol, as host batches."""
    from gpnerf_tpu_torch.registry import get

    np.random.seed(0)
    ds = get("dataset", cfg.dataset.test.file)(cfg, is_train=False)
    stride = max(1, len(ds) // n_frames)
    frames = []
    for pos in range(n_frames):
        random.seed(pos)
        np.random.seed(pos)
        frames.append(ds[pos * stride])
    return frames
