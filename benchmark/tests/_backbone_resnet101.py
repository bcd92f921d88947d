"""A backbone file for the tests alone: GroupNorm ResNet-101, ``nets.Block``
bottlenecks at plan (3, 4, 23, 3), a plan that the port's ``BACKBONES``
holds and ``nets.PLANS`` lacks.  A test puts it into ``sys.modules`` as
``benchmark.reference.backbones.resnet101``, where a configuration's own
file would lie."""

import torch.nn.functional as F
from torch import nn

from benchmark.flops import _conv, _out
from benchmark.reference import nets

LAYERS = (3, 4, 23, 3)


class ResNet101(nn.Module):
    def __init__(self, cin: int, base: int):
        super().__init__()
        groups = base // 2
        self.conv1 = nn.Sequential(nets.conv(cin, base, 7, 2, 3), nets.gn(groups, base),
                                   nn.ReLU())
        inp = base
        for s, n in enumerate(LAYERS):
            planes = base * 2 ** s
            blocks = []
            for j in range(n):
                stride = (1 if s == 0 else 2) if j == 0 else 1
                down = j == 0 and (stride != 1 or inp != planes * 4)
                blocks.append(nets.Block("bottleneck", inp, planes, groups, stride, down))
                inp = planes * 4
            setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))
        self.final_channels = inp

    def forward(self, x):
        x = F.max_pool2d(self.conv1(x), 3, 2, 1)
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


def build(cin: int, base: int) -> ResNet101:
    return ResNet101(cin, base)


def macs(cin: int, h: int, w: int, base: int):
    """From the plan: the stem, then each bottleneck's 1x1, 3x3 (stride) and
    1x1 to ``4 * planes``, and a downsample's 1x1 where one is built."""
    total, h, w = _conv(cin, base, 7, 2, 3, h, w)
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)  # max-pool
    inp = base
    for s, n in enumerate(LAYERS):
        planes = base * 2 ** s
        for j in range(n):
            stride = (1 if s == 0 else 2) if j == 0 else 1
            if j == 0 and (stride != 1 or inp != planes * 4):
                total += _conv(inp, planes * 4, 1, stride, 0, h, w)[0]
            m1, _, _ = _conv(inp, planes, 1, 1, 0, h, w)
            m2, oh, ow = _conv(planes, planes, 3, stride, 1, h, w)
            m3, _, _ = _conv(planes, planes * 4, 1, 1, 0, oh, ow)
            total += m1 + m2 + m3
            h, w, inp = oh, ow, planes * 4
    return total, inp, h, w
