"""Learning-rate schedules (gpnerf_tpu/train/lr.py), each a function of
the optimizer step count with the reference's per-epoch staircase: an
epoch is `ep_iter` steps and the epoch is floored (step // ep_iter), so
the rate changes once per epoch (reference lr_scheduler.py:21-89)."""

from __future__ import annotations

import numpy as np


def exponential_epoch_schedule(base_lr, gamma, decay_epochs, ep_iter):
    """lr = base * gamma ** (epoch / decay_epochs)."""

    def schedule(step):
        epoch = step // ep_iter
        return base_lr * gamma ** (epoch / decay_epochs)

    return schedule


def multistep_epoch_schedule(base_lr, milestones, gamma, ep_iter):
    """lr = base * gamma ** (#milestones passed) (MultiStepLR)."""
    ms = np.asarray(sorted(milestones))

    def schedule(step):
        epoch = step // ep_iter
        return base_lr * gamma ** int((ms <= epoch).sum())

    return schedule


def warmup_multistep_epoch_schedule(
    base_lr, milestones, gamma, warmup_factor, warmup_iters, ep_iter,
    warmup_method="linear",
):
    """WarmupMultiStepLR: a constant or linear warm-up factor for the first
    `warmup_iters` epochs, then the multistep decay."""
    ms = np.asarray(sorted(milestones))

    def schedule(step):
        epoch = step // ep_iter
        wf = 1.0
        if epoch < warmup_iters:
            if warmup_method == "constant":
                wf = warmup_factor
            else:
                alpha = epoch / warmup_iters
                wf = warmup_factor * (1 - alpha) + alpha
        return base_lr * wf * gamma ** int((ms <= epoch).sum())

    return schedule
