"""SE-ResNeXt-101 as habitat-baselines' ``resnet.py::se_resneXt101`` builds
it, DD-PPO's largest PointGoal encoder (Wijmans et al., ICLR 2020), in
plain torch, float32, NCHW.

Plan (3, 4, 23, 3).  Each block, with ``planes = 2 * base * 2**stage`` and
``out = 2 * planes``::

    y = GN(conv1x1(relu(GN(gconv3x3(relu(GN(conv1x1(x))))))))
    y = y * sigmoid(W2 relu(W1 mean_hw(y) + b1) + b2)
    out = relu(y + down(x))

``gconv3x3`` carries the stride and ``base / 2`` groups in the first block
of each stage, one group elsewhere; ``down`` is a 1x1 conv (the stride) and
a GroupNorm where the first block changes width or stride, else identity.

Departures from Xie et al. (ResNeXt) and Hu et al. (SE) that the source
makes and this file copies:

- GroupNorm, ``base / 2`` groups, in place of BatchNorm; eps 1e-6 as the
  rest of the reference (``nets.GN_EPS``), where habitat-baselines keeps
  torch's 1e-5;
- base width 32 (64 published) and stages twice as wide as a ResNet's,
  ``2 * base * 2**stage``, with expansion 2 (4 published), so the stages
  end at 128, 256, 512 and 1,024 channels at base 32 (256 to 2,048);
- cardinality ``base / 2`` (16 at base 32; 32 published) in each stage's
  first block only; the other 29 blocks' 3x3 convs are dense;
- a downsample wherever a stage's first block changes width, stride 1
  included (layer1: 32 -> 128 channels);
- the SE gate on every block, after the last GroupNorm and before the
  residual add, reduction 16, with biases, as Hu et al. place it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.flops import _conv, _out
from benchmark.reference.nets import GN_EPS

LAYERS = (3, 4, 23, 3)
EXPANSION = 2
SE_REDUCTION = 16


def _gn(groups: int, ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(groups, ch, eps=GN_EPS)


def _conv2d(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, groups=groups, bias=False)


class _SE(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        # the names are the source's: excite.0 and excite.2
        self.excite = nn.Sequential(nn.Linear(ch, ch // SE_REDUCTION), nn.ReLU(),
                                    nn.Linear(ch // SE_REDUCTION, ch), nn.Sigmoid())

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        e = self.excite
        g = torch.sigmoid(e[2](F.relu(e[0](y.mean(dim=(2, 3))))))
        return y * g[:, :, None, None]


class _Block(nn.Module):
    def __init__(self, cin: int, planes: int, groups: int, stride: int, cardinality: int,
                 down: bool):
        super().__init__()
        out = planes * EXPANSION
        # convs.{0,1,3,4,6,7}: the ReLUs hold indices 2 and 5, as in the source
        self.convs = nn.Sequential(
            _conv2d(cin, planes, 1), _gn(groups, planes), nn.ReLU(),
            _conv2d(planes, planes, 3, stride, cardinality), _gn(groups, planes), nn.ReLU(),
            _conv2d(planes, out, 1), _gn(groups, out))
        self.se = _SE(out)
        self.downsample = (nn.Sequential(_conv2d(cin, out, 1, stride), _gn(groups, out))
                           if down else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.convs
        y = c[7](c[6](F.relu(c[4](c[3](F.relu(c[1](c[0](x))))))))
        y = self.se(y)
        r = x if self.downsample is None else self.downsample(x)
        return F.relu(y + r)


class SEResNeXt101(nn.Module):
    def __init__(self, cin: int, base: int):
        super().__init__()
        groups = base // 2
        self.conv1 = nn.Sequential(_conv2d(cin, base, 7, 2), _gn(groups, base), nn.ReLU())
        inp = base
        for s, n in enumerate(LAYERS):
            planes = 2 * base * 2 ** s
            blocks = []
            for j in range(n):
                stride = 2 if s > 0 and j == 0 else 1
                down = j == 0 and (stride != 1 or inp != planes * EXPANSION)
                blocks.append(_Block(inp, planes, groups, stride,
                                     base // 2 if j == 0 else 1, down))
                inp = planes * EXPANSION
            setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))
        self.final_channels = inp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.max_pool2d(self.conv1(x), 3, 2, 1)
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


def build(cin: int, base: int) -> SEResNeXt101:
    return SEResNeXt101(cin, base)


def macs(cin: int, h: int, w: int, base: int):
    """From the plan: the stem; each block's 1x1, grouped 3x3 (stride; a
    group's ``planes / groups`` input channels an output) and 1x1 to
    ``2 * planes``; its SE gate's two linears; a downsample's 1x1 where one
    is built."""
    total, h, w = _conv(cin, base, 7, 2, 3, h, w)
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)  # max-pool
    inp = base
    for s, n in enumerate(LAYERS):
        planes = 2 * base * 2 ** s
        out = planes * EXPANSION
        for j in range(n):
            stride = 2 if s > 0 and j == 0 else 1
            card = base // 2 if j == 0 else 1
            if j == 0 and (stride != 1 or inp != out):
                total += _conv(inp, out, 1, stride, 0, h, w)[0]
            m1, _, _ = _conv(inp, planes, 1, 1, 0, h, w)
            m2, oh, ow = _conv(planes // card, planes, 3, stride, 1, h, w)
            m3, _, _ = _conv(planes, out, 1, 1, 0, oh, ow)
            total += m1 + m2 + m3 + 2 * out * (out // SE_REDUCTION)
            h, w, inp = oh, ow, out
    return total, inp, h, w
