"""Shared layers: reflect-padded conv, InstanceNorm, masked BatchNorm, and
the Linear stacks of the heads.

Counterparts of gpnerf_tpu/models/layers.py, written as torch modules whose
parameter names follow the reference checkpoint (`weight`, `bias`,
`running_mean`, `running_var`), so `load_state_dict(strict=True)` on
artifacts/bench_ckpt.pth fills them directly.

`compute_dtype` reproduces the JAX package's reduced-precision layers
(flax `Conv` / `Dense` with `dtype=bfloat16` over float32 parameters): the
casts make real tensors of that dtype, so convolutions and products take
bf16 operands (float32 accumulation in cuDNN, cuBLAS or the CPU's kernels)
and return bf16, and the ops that follow compute in the dtype of what they
are given, as the JAX package's do. Norms take their statistics in float32.
`rounded` is the float32 emulation of one such rounding, kept for the plain
versions of the kernels and the samplers' inner steps.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def rounded(x, dtype):
    """`x` rounded to `dtype` (None: unchanged), as float32 holding the
    rounded values."""
    if dtype is None:
        return x
    return x.to(dtype).float()


def cast(x, dtype):
    """`x` as a tensor of `dtype` (None: unchanged)."""
    return x if dtype is None else x.to(dtype)


class ReflectConv(nn.Conv2d):
    """Conv2d with reflect padding, NCHW (the reference's
    `padding_mode='reflect'` convs, UNet.py:6-14,160-161)."""

    def __init__(self, cin, cout, kernel_size=3, stride=1, bias=False,
                 compute_dtype=None):
        super().__init__(
            cin, cout, kernel_size, stride, padding=(kernel_size - 1) // 2,
            padding_mode="reflect", bias=bias,
        )
        self.compute_dtype = compute_dtype

    def forward(self, x):
        p = self.padding[0]
        if p:
            x = F.pad(x, (p, p, p, p), mode="reflect")
        dt = self.compute_dtype
        y = F.conv2d(cast(x, dt), cast(self.weight, dt), None, self.stride)
        if self.bias is not None:
            y = y + cast(self.bias, dt)[None, :, None, None]
        return y


class InstanceNorm(nn.Module):
    """InstanceNorm2d(affine=True, track_running_stats=False), NCHW,
    statistics in float32 (layers.InstanceNorm)."""

    def __init__(self, channels, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        x = x.float()
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(2, 3), keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight[None, :, None, None] + self.bias[None, :, None, None]


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d(eps=1e-3, momentum=0.01) over a padded (CAP, C)
    active-site matrix (layers.MaskedBatchNorm).

    Eval (the default): the running statistics as an affine map. Train
    (`train=True` with the (CAP,) `valid` mask): mean and biased variance
    over the valid rows only (n = max(#valid, 1)) normalize the input, and
    the running estimates move by the momentum in torch's convention, the
    variance unbiased (var * n / max(n - 1, 1)); `num_batches_tracked`
    counts the updates."""

    def __init__(self, channels, eps=1e-3, momentum=0.01):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer(
            "num_batches_tracked", torch.tensor(0, dtype=torch.long)
        )

    def forward(self, x, valid=None, *, train=False):
        if not train:
            y = (x - self.running_mean) / torch.sqrt(self.running_var + self.eps)
            return y * self.weight + self.bias
        # the column sums (the statistics and, in the backward, the scale
        # and bias gradients and those through the statistics) run in
        # float64: a float32 sum over ~10^4 rows whose terms cancel loses
        # up to 1e-2 of its value in a sequential reduction
        x64 = x.double()
        vf = valid.double()[:, None]
        n = vf.sum().clamp_min(1.0)
        mean = (x64 * vf).sum(dim=0) / n
        var = (((x64 - mean) ** 2) * vf).sum(dim=0) / n
        with torch.no_grad():
            m = self.momentum
            unbiased = (var * n / (n - 1.0).clamp_min(1.0)).to(x.dtype)
            self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean.to(x.dtype))
            self.running_var.copy_((1.0 - m) * self.running_var + m * unbiased)
            self.num_batches_tracked += 1
        y = (x64 - mean) / torch.sqrt(var + self.eps)
        return (y * self.weight.double() + self.bias.double()).to(x.dtype)


_ACTS = {"elu": nn.ELU, "relu": nn.ReLU}


class MLP(nn.Sequential):
    """Linear stack with per-layer activations, laid out as the reference's
    nn.Sequential (Linear at even indices), so keys read `<name>.0.weight`,
    `<name>.2.weight`, ...

    `compute_dtype` is a Dense layer computing in that dtype with float32
    parameters (flax `Dense(dtype=bfloat16)`): input, weight and bias are
    cast to it, and the product, the biased sum and the activation are
    tensors of it (the output too)."""

    def __init__(self, cin: int, features: Sequence[int],
                 activations: Sequence[str], compute_dtype=None):
        mods = []
        for f, act in zip(features, activations):
            mods.append(nn.Linear(cin, f))
            if act != "none":
                mods.append(_ACTS[act]())
            cin = f
        super().__init__(*mods)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        for m in self:
            if isinstance(m, nn.Linear):
                x = cast(x, dt) @ cast(m.weight, dt).T + cast(m.bias, dt)
            else:
                x = m(x)
        return x
