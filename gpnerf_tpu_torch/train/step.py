"""The optimization step (gpnerf_tpu/train/step.py): AdamW over every
parameter with the per-epoch exponential schedule, and one train step =
forward, loss, backward, optimizer step, schedule step.

`optax.adamw(schedule, weight_decay)` decays every leaf of the params tree
(biases, norm scales, the vertex codes included) and evaluates the schedule
at the pre-update count, so step k runs at lr(k): here a `LambdaLR` over
`torch.optim.AdamW` with the same betas and eps. A parameter that no
output reaches (the attention's LayerNorm, kept for checkpoint keys) gets a
zero gradient, as JAX gives it, so weight decay moves it as optax does."""

from __future__ import annotations

import torch

from gpnerf_tpu_torch.train.lr import exponential_epoch_schedule


def make_optimizer(model, cfg):
    """(AdamW, LambdaLR, schedule) for `model`'s parameters: lr
    cfg.train.lr decayed per epoch by gamma over decay_epochs, betas (0.9,
    0.999), eps 1e-8, cfg.train.weight_decay."""
    t = cfg.train
    schedule = exponential_epoch_schedule(t.lr, t.gamma, t.decay_epochs, t.ep_iter)
    opt = torch.optim.AdamW(model.parameters(), lr=t.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=t.weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda k: schedule(k) / t.lr)
    return opt, sched, schedule


def forward_backward(render, criterion, optimizer, batch, generator=None, t_rand=None):
    """The forward pass on one frame, the loss and its gradient in each
    parameter's `.grad` (zeros where no output reaches it). Returns
    (metrics, render dict): the metrics of the JAX step, each loss term,
    `loss` and `overflow` (the pyramid's largest overflow count), as 0-d
    tensors on the batch's device."""
    optimizer.zero_grad()
    ret = render.render_train(batch, generator=generator, t_rand=t_rand)
    loss_dict = criterion(ret, batch, is_train=True)
    total = sum(loss_dict.values())
    total.backward()
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:  # reached by no output: JAX's gradient is 0
                p.grad = torch.zeros_like(p)
    metrics = {k: v.detach() for k, v in loss_dict.items()}
    metrics["loss"] = total.detach()
    metrics["overflow"] = ret["overflows"].max()
    return metrics, ret


def train_step(render, criterion, optimizer, scheduler, batch, generator=None, t_rand=None):
    """One optimizer step on one frame: `forward_backward`, then the AdamW
    and schedule steps. Returns its (metrics, render dict)."""
    metrics, ret = forward_backward(render, criterion, optimizer, batch, generator, t_rand)
    optimizer.step()
    scheduler.step()
    return metrics, ret
