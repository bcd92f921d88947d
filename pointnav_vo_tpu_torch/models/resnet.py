"""GroupNorm ResNet18 (counterpart of ``models/resnet.py``), NCHW.

Submodule names follow the reference checkpoints, so their state dicts
load with ``strict=True``: ``conv1.{0,1}`` (stem conv and GroupNorm),
``layer{L}.{B}.convs.{0,1,3,4}`` and ``layer{L}.{B}.downsample.{0,1}``.

Every GroupNorm uses eps=1e-6, flax's default, which the JAX package uses
(torch's default is 1e-5).

Compute runs in the input's dtype, the parameters stay in theirs, as flax's
``dtype=`` beside ``param_dtype=``: a bfloat16 input runs its convs in
bfloat16 over float32 weights cast in the forward (gradients reach the
float32 parameters through the cast), and GroupNorm takes its statistics
and applies its affine in float32, then casts to bfloat16 (flax's
``_normalize`` with ``force_float32_reductions``).  An input in the
parameters' dtype runs exactly as plain ``nn.Conv2d`` and ``nn.GroupNorm``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

GN_EPS = 1e-6


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` computed in the parameters' dtype and cast back to
    the input's (a no-op where the two agree)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.to(self.weight.dtype), self.num_groups, self.weight, self.bias,
                            self.eps).to(x.dtype)


def group_norm(ngroups: int, channels: int) -> GroupNorm:
    return GroupNorm(ngroups, channels, eps=GN_EPS)


class BasicBlock(nn.Module):
    """conv3x3-GN-ReLU-conv3x3-GN + residual."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, ngroups: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.convs = nn.Sequential(
            Conv2d(inplanes, planes, 3, stride=stride, padding=1, bias=False),
            group_norm(ngroups, planes),
            nn.ReLU(True),
            Conv2d(planes, planes, 3, padding=1, bias=False),
            group_norm(ngroups, planes),
        )
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, planes, 1, stride=stride, bias=False),
                group_norm(ngroups, planes),
            )
        self.relu = nn.ReLU(True)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(self.convs(x) + residual)


class GNResNet(nn.Module):
    """7x7/2 stem + GN + ReLU, 3x3/2 max-pool, four stages at widths
    base * (1, 2, 4, 8) with stride-2 transitions; overall stride 1/32."""

    def __init__(self, in_channels: int, base_planes: int = 32, ngroups: int = 16,
                 layers=(2, 2, 2, 2)):
        super().__init__()
        self.conv1 = nn.Sequential(
            Conv2d(in_channels, base_planes, 7, stride=2, padding=3, bias=False),
            group_norm(ngroups, base_planes),
            nn.ReLU(True),
        )
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = base_planes
        for stage, n_blocks in enumerate(layers):
            planes = base_planes * 2 ** stage
            stride = 1 if stage == 0 else 2
            blocks = []
            for j in range(n_blocks):
                s = stride if j == 0 else 1
                down = j == 0 and (s != 1 or inplanes != planes * BasicBlock.expansion)
                blocks.append(BasicBlock(inplanes, planes, ngroups, s, down))
                inplanes = planes * BasicBlock.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.final_channels = inplanes
        self.final_spatial_compress = 1.0 / 32

    def forward(self, x):
        x = self.maxpool(self.conv1(x))
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


def resnet18(in_channels: int, base_planes: int = 32, ngroups: int = 16) -> GNResNet:
    return GNResNet(in_channels, base_planes, ngroups, layers=(2, 2, 2, 2))

