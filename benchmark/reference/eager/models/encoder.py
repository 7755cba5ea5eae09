# Frozen copy of gpnerf_tpu_torch/models/encoder.py at commit ffa1347, the benchmark's plain
# reference: the port's hand-written kernels, registries and the paths no
# configuration of the benchmark runs are removed; nothing here is imported
# from the program.
"""ResNet34-UNet image encoder (gpnerf_tpu/models/encoder.py), as torch
modules with the reference's parameter names (UNet.py:133-234).

ResNet-style encoder (BasicBlocks [3, 4, 6], 7x7 stride-2 stem, three
stride-2 stages) with InstanceNorm and reflect padding; U-Net decoder
upconv3/iconv3/upconv2/iconv2 with [upsampled, skip] concats and bilinear
align_corners upsampling; 1x1 out_conv to `out_ch` at 1/4 resolution.
Public layout is the JAX package's NHWC: (V, H, W, 3) -> (V, H/4, W/4, C).
With a compute dtype every convolution takes and returns tensors of it; the
InstanceNorms return float32, so the decoder's upsampled inputs and skips
are float32 and the feature maps (out_conv's output) are of the compute
dtype, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.eager.models.layers import InstanceNorm, ReflectConv
from benchmark.reference.eager.ops.upsample import upsample_bilinear_nchw


class BasicBlock(nn.Module):
    def __init__(self, cin, planes, stride=1, compute_dtype=None):
        super().__init__()
        dt = dict(compute_dtype=compute_dtype)
        self.conv1 = ReflectConv(cin, planes, 3, stride, **dt)
        self.bn1 = InstanceNorm(planes)
        self.conv2 = ReflectConv(planes, planes, 3, 1, **dt)
        self.bn2 = InstanceNorm(planes)
        self.downsample = None
        if stride != 1:
            # the reference creates the 1x1 projection exactly when stride != 1
            self.downsample = nn.Sequential(
                ReflectConv(cin, planes, 1, stride, **dt),
                InstanceNorm(planes),
            )

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ConvINElu(nn.Module):
    """Decoder conv block: reflect conv with bias + InstanceNorm + ELU."""

    def __init__(self, cin, cout, compute_dtype=None):
        super().__init__()
        self.conv = ReflectConv(cin, cout, 3, 1, bias=True, compute_dtype=compute_dtype)
        self.bn = InstanceNorm(cout)

    def forward(self, x):
        return F.elu(self.bn(self.conv(x)))


class _Wrap(nn.Module):
    """upconvN wraps its conv block once more (`upconv3.conv.conv.weight`)."""

    def __init__(self, block):
        super().__init__()
        self.conv = block

    def forward(self, x):
        return self.conv(x)


class ResUNet(nn.Module):
    def __init__(self, out_ch=32, encoder="resnet34", compute_dtype=None):
        super().__init__()
        layers = {"resnet34": [3, 4, 6], "resnet18": [2, 2, 2], "tiny": [1, 1, 1]}[
            encoder
        ]
        dt = dict(compute_dtype=compute_dtype)
        self.conv1 = ReflectConv(3, 64, 7, 2, **dt)
        self.bn1 = InstanceNorm(64)
        cin = 64
        for i, (planes, blocks) in enumerate(zip((64, 128, 256), layers)):
            mods = [BasicBlock(cin, planes, 2, **dt)]
            mods += [BasicBlock(planes, planes, 1, **dt) for _ in range(1, blocks)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*mods))
            cin = planes
        self.upconv3 = _Wrap(ConvINElu(256, 128, **dt))
        self.iconv3 = ConvINElu(256, 128, **dt)
        self.upconv2 = _Wrap(ConvINElu(128, 64, **dt))
        self.iconv2 = ConvINElu(128, out_ch, **dt)
        self.out_conv = ReflectConv(out_ch, out_ch, 1, 1, bias=True, **dt)

    def forward(self, x_nhwc):
        x = x_nhwc.permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        x1 = self.layer1(x)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        y = self.upconv3(upsample_bilinear_nchw(x3, 2))
        y = self.iconv3(torch.cat([y, x2], dim=1))
        y = self.upconv2(upsample_bilinear_nchw(y, 2))
        y = self.iconv2(torch.cat([y, x1], dim=1))
        y = self.out_conv(y)
        return y.permute(0, 2, 3, 1).contiguous()


def build_encoder(cfg, compute_dtype=None):
    """The encoder of `cfg` (JAX models/encoder.py `build_encoder`,
    UNet.py:237-243); with a `compute_dtype` its convolutions compute on
    tensors of that dtype, as the JAX package's clone with that dtype does
    (models/layers.py), and the feature maps it returns are of that dtype."""
    return ResUNet(cfg.encoder.out_ch, cfg.encoder.name, compute_dtype)
