# Frozen copy of gpnerf_tpu_torch/train/criterion.py at commit ffa1347, the benchmark's plain
# reference: the port's hand-written kernels, registries and the paths no
# configuration of the benchmark runs are removed; nothing here is imported
# from the program.
"""Training criterion (gpnerf_tpu/train/criterion.py; reference
BaseNeRFCriterion.py:35-57): the MSE on rgb over the valid rays, as a
validity-weighted mean over the padded ray set."""

from __future__ import annotations



class Criterion:
    def __init__(self, cfg):
        self.cfg = cfg

    def __call__(self, ret, batch, is_train=True):
        valid = batch["ray_valid"]
        diff = (ret["rgb_map"] - batch["rgb"]) ** 2
        n = valid.sum().clamp_min(1.0)
        return {"rgb_loss": (diff * valid[:, None]).sum() / (n * diff.shape[-1])}
