"""Shared layers: reflect-padded conv, InstanceNorm, masked BatchNorm, and
the Linear stacks of the heads.

Counterparts of gpnerf_tpu/models/layers.py, written as torch modules whose
parameter names follow the reference checkpoint (`weight`, `bias`,
`running_mean`, `running_var`), so `load_state_dict(strict=True)` on
artifacts/bench_ckpt.pth fills them directly.

`compute_dtype` reproduces the JAX package's reduced-precision casts. Two
forms share one code path:

  * the emulation (the inference paths under cfg.tpu.matmul_dtype
    "bfloat16"): operands are rounded to that dtype and the arithmetic runs
    in float32 on the rounded values, which is what XLA does for a bf16
    convolution with float32 accumulation; values stay in float32 tensors;
  * `native` (the training path under cfg.tpu.train_dtype "bfloat16"): the
    casts make real tensors of that dtype, so convolutions and products take
    bf16 operands (float32 accumulation in cuDNN, cuBLAS or the CPU's
    kernels) and return bf16, and the ops that follow compute in the dtype
    of what they are given, as the JAX package's do.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def rounded(x, dtype, native=False):
    """`x` rounded to `dtype` (None: unchanged): a tensor of that dtype when
    `native`, else float32 holding the rounded values."""
    if dtype is None:
        return x
    return x.to(dtype) if native else x.to(dtype).float()


class ReflectConv(nn.Conv2d):
    """Conv2d with reflect padding, NCHW (the reference's
    `padding_mode='reflect'` convs, UNet.py:6-14,160-161)."""

    def __init__(self, cin, cout, kernel_size=3, stride=1, bias=False,
                 compute_dtype=None, native=False):
        super().__init__(
            cin, cout, kernel_size, stride, padding=(kernel_size - 1) // 2,
            padding_mode="reflect", bias=bias,
        )
        self.compute_dtype = compute_dtype
        self.native = native

    def forward(self, x):
        p = self.padding[0]
        if p:
            x = F.pad(x, (p, p, p, p), mode="reflect")
        dt, nat = self.compute_dtype, self.native
        y = F.conv2d(rounded(x, dt, nat), rounded(self.weight, dt, nat), None, self.stride)
        y = rounded(y, dt, nat)
        if self.bias is not None:
            y = rounded(y + rounded(self.bias, dt, nat)[None, :, None, None], dt, nat)
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

    `compute_dtype` reproduces a Dense layer computing in that dtype with
    float32 parameters (flax `Dense(dtype=bfloat16)`): input, weight and
    bias are rounded to it, the product is rounded, the biased sum is
    rounded, and the activation runs on the rounded value and is rounded
    again. Values stay in float32 tensors, or with `native` are tensors of
    that dtype (the output too)."""

    def __init__(self, cin: int, features: Sequence[int],
                 activations: Sequence[str], compute_dtype=None, native=False):
        mods = []
        for f, act in zip(features, activations):
            mods.append(nn.Linear(cin, f))
            if act != "none":
                mods.append(_ACTS[act]())
            cin = f
        super().__init__(*mods)
        self.compute_dtype = compute_dtype
        self.native = native

    def forward(self, x):
        dt, nat = self.compute_dtype, self.native
        if dt is None:
            return super().forward(x)
        for m in self:
            if isinstance(m, nn.Linear):
                x = rounded(rounded(x, dt, nat) @ rounded(m.weight, dt, nat).T, dt, nat)
                x = rounded(x + rounded(m.bias, dt, nat), dt, nat)
            else:
                x = rounded(m(x), dt, nat)
        return x
