"""The bench frame protocol (gpnerf_tpu/utils/bench_frames.py), cached on
disk.

Frames stride across the test set, and both stdlib `random` and
`np.random` are seeded with the item's position before it is built (eval
view selection draws from stdlib random, data/base.py select_views).
Building a frame on the host (the synthetic image and the sparse pyramid's
rulebooks) costs seconds, and the frame set is a function of the dataset
config, the pyramid capacities and the item indices only; so it is pickled
once under artifacts/frame_cache_torch/, keyed by `_fingerprint` over the
same keys as the JAX package's, and read back afterwards. The port keeps
its own cache directory: neither package reads the other's pickles."""

from __future__ import annotations

import hashlib
import os
import pickle
import random
import sys

import numpy as np

_CACHE_VERSION = 1
CACHE_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "artifacts", "frame_cache_torch")


def _fingerprint(cfg, indices) -> str:
    """Only the keys that change the host batches: the dataset block, the
    pyramid capacities, the head (its code_dim), the cameras and the item
    indices. Renderer switches leave the cache valid."""
    relevant = {
        "v": _CACHE_VERSION,
        "dataset": repr(cfg.dataset),
        "site_cap": cfg.tpu.site_cap,
        "level_caps": list(cfg.tpu.level_caps),
        "max_out_sh": list(cfg.tpu.max_out_sh),
        "head": repr(cfg.head),
        "cam_num": cfg.cam_num,
        "src_view_num": cfg.src_view_num,
        "indices": list(indices),
    }
    return hashlib.sha256(repr(sorted(relevant.items())).encode()).hexdigest()[:16]


def get_bench_frames(cfg, n_frames=10, cache_root=None, verbose=True):
    """The first `n_frames` items of the bench protocol, as host batches;
    `n_frames=None` takes the full test set (stride 1, seed = index: the
    quality sweep's protocol). Read from `cache_root` (default
    artifacts/frame_cache_torch/) when the fingerprint is there, else built
    and written to a temporary file renamed into place."""
    from gpnerf_tpu_torch.registry import get

    np.random.seed(0)
    ds = get("dataset", cfg.dataset.test.file)(cfg, is_train=False)
    if n_frames is None:
        n_frames = len(ds)
    stride = max(1, len(ds) // n_frames)
    indices = [i * stride for i in range(n_frames)]
    root = CACHE_ROOT if cache_root is None else cache_root
    path = os.path.join(root, f"frames_{_fingerprint(cfg, indices)}.pkl")
    if os.path.exists(path):
        with open(path, "rb") as f:
            frames = pickle.load(f)
        if verbose:
            print(f"# frame cache hit: {path}", file=sys.stderr)
        return frames
    frames = []
    for pos, idx in enumerate(indices):
        random.seed(pos)
        np.random.seed(pos)
        frames.append(ds[idx])
    os.makedirs(root, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(frames, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    if verbose:
        print(f"# frame cache write: {path}", file=sys.stderr)
    return frames
