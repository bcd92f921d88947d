"""GroupNorm ResNet family (counterpart of ``models/resnet.py``), NCHW:
``BasicBlock``, ``Bottleneck`` (expansion 4), ``ResNeXtBottleneck``
(expansion 2), the squeeze-excitation gate, and the seven backbones of
:data:`BACKBONES`.

Submodule names follow the reference checkpoints, so their state dicts
load with ``strict=True``: ``conv1.{0,1}`` (stem conv and GroupNorm),
``layer{L}.{B}.convs.{0,1,3,4}`` (a basic block) or
``layer{L}.{B}.convs.{0,1,3,4,6,7}`` (a bottleneck),
``layer{L}.{B}.se.excite.{0,2}`` and ``layer{L}.{B}.downsample.{0,1}``.

The reference's layer plan is copied with its quirks: a ResNeXt stage is
twice as wide (``2 * base_planes * 2**stage``), its cardinality reaches the
first block of each stage only, only a bottleneck's 3x3 conv is grouped,
and a downsample is built wherever the first block's input width differs
from its output width, stride 1 included.  The stem is the plain 7x7/2
conv (the JAX package's space-to-depth stem is a TPU layout workaround).

Every GroupNorm uses eps=1e-6, flax's default, which the JAX package uses
(torch's default is 1e-5).

Compute runs in the input's dtype, the parameters stay in theirs, as flax's
``dtype=`` beside ``param_dtype=``: a bfloat16 input runs its convs and the
SE gate in bfloat16 over float32 weights cast in the forward (gradients
reach the float32 parameters through the cast), and GroupNorm takes its
statistics and applies its affine in float32, then casts to bfloat16
(flax's ``_normalize`` with ``force_float32_reductions``).  An input in the
parameters' dtype runs exactly as plain ``nn.Conv2d``, ``nn.Linear`` and
``nn.GroupNorm``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

GN_EPS = 1e-6
SE_REDUCTION = 16


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Linear(nn.Linear):
    """``nn.Linear`` computing in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` computed in the parameters' dtype and cast back to
    the input's (a no-op where the two agree)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.to(self.weight.dtype), self.num_groups, self.weight, self.bias,
                            self.eps).to(x.dtype)


def group_norm(ngroups: int, channels: int) -> GroupNorm:
    return GroupNorm(ngroups, channels, eps=GN_EPS)


class SEModule(nn.Module):
    """Squeeze-excitation gate: spatial mean, ``excite`` (Linear to
    channels // 16, ReLU, Linear back, Sigmoid), then a channel scale."""

    def __init__(self, channels: int, r: int = SE_REDUCTION):
        super().__init__()
        self.excite = nn.Sequential(Linear(channels, channels // r), nn.ReLU(True),
                                    Linear(channels // r, channels), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.excite(x.mean(dim=(2, 3)))[:, :, None, None]


def _downsample(inplanes: int, outplanes: int, ngroups: int, stride: int) -> nn.Sequential:
    return nn.Sequential(Conv2d(inplanes, outplanes, 1, stride=stride, bias=False),
                         group_norm(ngroups, outplanes))


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
        self.downsample = _downsample(inplanes, planes, ngroups, stride) if downsample else None
        self.relu = nn.ReLU(True)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(self.convs(x) + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, grouped by ``cardinality``) -> 1x1 to
    ``planes * expansion``, each with GroupNorm; the SE gate after the
    last GroupNorm, before the residual add."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, ngroups: int, stride: int = 1,
                 downsample: bool = False, cardinality: int = 1, use_se: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.convs = nn.Sequential(
            Conv2d(inplanes, planes, 1, bias=False),
            group_norm(ngroups, planes),
            nn.ReLU(True),
            Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False,
                   groups=cardinality),
            group_norm(ngroups, planes),
            nn.ReLU(True),
            Conv2d(planes, out, 1, bias=False),
            group_norm(ngroups, out),
        )
        self.se = SEModule(out) if use_se else None
        self.downsample = _downsample(inplanes, out, ngroups, stride) if downsample else None
        self.relu = nn.ReLU(True)

    def forward(self, x):
        y = self.convs(x)
        if self.se is not None:
            y = self.se(y)
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class ResNeXtBottleneck(Bottleneck):
    expansion = 2


_BLOCKS = {"basic": BasicBlock, "bottleneck": Bottleneck, "resnext": ResNeXtBottleneck}


class GNResNet(nn.Module):
    """7x7/2 stem + GN + ReLU, 3x3/2 max-pool, four stages at widths
    base * (1, 2, 4, 8) (twice that for ResNeXt) with stride-2
    transitions; overall stride 1/32."""

    def __init__(self, in_channels: int, base_planes: int = 32, ngroups: int = 16,
                 block: str = "basic", layers: Sequence[int] = (2, 2, 2, 2),
                 cardinality: int = 1, use_se: bool = False):
        super().__init__()
        block_cls = _BLOCKS[block]
        self.conv1 = nn.Sequential(
            Conv2d(in_channels, base_planes, 7, stride=2, padding=3, bias=False),
            group_norm(ngroups, base_planes),
            nn.ReLU(True),
        )
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = base_planes
        stage_base = base_planes * (2 if block == "resnext" else 1)
        for stage, n_blocks in enumerate(layers):
            planes = stage_base * 2 ** stage
            stride = 1 if stage == 0 else 2
            blocks = []
            for j in range(n_blocks):
                s = stride if j == 0 else 1
                down = j == 0 and (s != 1 or inplanes != planes * block_cls.expansion)
                # the reference's quirk: cardinality reaches each stage's
                # first block only
                kw = {} if block_cls is BasicBlock else dict(
                    cardinality=cardinality if j == 0 else 1, use_se=use_se)
                blocks.append(block_cls(inplanes, planes, ngroups, s, down, **kw))
                inplanes = planes * block_cls.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.final_channels = inplanes
        self.final_spatial_compress = 1.0 / 32

    def forward(self, x):
        x = self.maxpool(self.conv1(x))
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


def resnet18(in_channels: int, base_planes: int = 32, ngroups: int = 16) -> GNResNet:
    return GNResNet(in_channels, base_planes, ngroups, "basic", (2, 2, 2, 2))


def resnet50(in_channels: int, base_planes: int = 32, ngroups: int = 16) -> GNResNet:
    return GNResNet(in_channels, base_planes, ngroups, "bottleneck", (3, 4, 6, 3))


def resnet101(in_channels: int, base_planes: int = 32, ngroups: int = 16) -> GNResNet:
    return GNResNet(in_channels, base_planes, ngroups, "bottleneck", (3, 4, 23, 3))


def resneXt50(in_channels: int, base_planes: int = 32, ngroups: int = 16) -> GNResNet:
    return GNResNet(in_channels, base_planes, ngroups, "resnext", (3, 4, 6, 3),
                    cardinality=base_planes // 2)


def se_resnet50(in_channels: int, base_planes: int = 32, ngroups: int = 16) -> GNResNet:
    return GNResNet(in_channels, base_planes, ngroups, "bottleneck", (3, 4, 6, 3),
                    use_se=True)


def se_resneXt50(in_channels: int, base_planes: int = 32, ngroups: int = 16) -> GNResNet:
    return GNResNet(in_channels, base_planes, ngroups, "resnext", (3, 4, 6, 3),
                    cardinality=base_planes // 2, use_se=True)


def se_resneXt101(in_channels: int, base_planes: int = 32, ngroups: int = 16) -> GNResNet:
    return GNResNet(in_channels, base_planes, ngroups, "resnext", (3, 4, 23, 3),
                    cardinality=base_planes // 2, use_se=True)


BACKBONES = {
    "resnet18": resnet18,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resneXt50": resneXt50,
    "se_resnet50": se_resnet50,
    "se_resneXt50": se_resneXt50,
    "se_resneXt101": se_resneXt101,
}
