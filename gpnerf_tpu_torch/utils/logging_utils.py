"""Logger + scalar/image writers.

A copy of gpnerf_tpu/utils/logging_utils.py (reference libs/utils/
utils.py:50-74): a timestamped file+console logger under
work_dirs/<output_dir>/<ts>/ and a writer that stores scalars as a JSONL
event file and images as PNGs (no tensorboard dependency)."""

from __future__ import annotations

import json
import logging
import os
import time


def write_dict_to_json(mydict, f_path):
    """(utils.py:184-218): persist a metrics dict as JSON."""
    import numpy as np

    def default(o):
        if isinstance(o, (np.integer,)):
            return int(o)
        if isinstance(o, (np.floating,)):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        raise TypeError(type(o))

    with open(f_path, "w") as f:
        json.dump(mydict, f, indent=2, default=default)


def get_sha():
    """(misc.py:266-283): git state string for log headers."""
    import subprocess

    cwd = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    def _run(cmd):
        return subprocess.check_output(cmd, cwd=cwd).decode("ascii").strip()

    try:
        sha = _run(["git", "rev-parse", "HEAD"])
        diff = "has uncommitted changes" if _run(["git", "diff-index", "HEAD"]) else "clean"
        branch = _run(["git", "rev-parse", "--abbrev-ref", "HEAD"])
        return f"sha: {sha}, status: {diff}, branch: {branch}"
    except Exception:
        return "sha: N/A"


def create_logger(cfg, rank=0, phase="train"):
    time_str = time.strftime("%Y-%m-%d-%H-%M")
    log_dir = os.path.join("work_dirs", cfg.output_dir.strip("/"), time_str)
    os.makedirs(log_dir, exist_ok=True)
    log_file = os.path.join(log_dir, f"{phase}_{time_str}_rank{rank}.log")
    logger = logging.getLogger(f"gpnerf.rank{rank}")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(message)s")
    fh = logging.FileHandler(log_file)
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    return logger, log_dir


class ScalarWriter:
    """SummaryWriter stand-in: JSONL events + optional image dumps."""

    def __init__(self, log_dir):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "events.jsonl")
        self.img_dir = os.path.join(log_dir, "images")
        self._fh = open(self.path, "a")

    def add_scalar(self, tag, value, step):
        self._fh.write(
            json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n"
        )
        self._fh.flush()

    def add_image(self, tag, img, step):
        """img: (H, W, 3) float [0,1] or (3, H, W)."""
        import numpy as np

        from gpnerf_tpu_torch.ops.image import imwrite

        os.makedirs(self.img_dir, exist_ok=True)
        arr = np.asarray(img)
        if arr.ndim == 3 and arr.shape[0] == 3:
            arr = arr.transpose(1, 2, 0)
        safe_tag = tag.replace("/", "_")
        imwrite(os.path.join(self.img_dir, f"{safe_tag}_{step}.png"), arr)

    def close(self):
        self._fh.close()
