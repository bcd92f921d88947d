"""GroupNorm ResNets, the VO CNN and the ResNet + LSTM policy in plain
PyTorch, float32.  Module and parameter names are the published
checkpoints' (``visual_encoder.backbone.layer1.0.convs.0.weight``...), so
one state dict loads here and into the measured program alike.

GroupNorm uses eps 1e-6 and ``ngroups = base_planes // 2``; a basic block
is conv3x3-GN-ReLU-conv3x3-GN, a bottleneck 1x1-3x3(stride)-1x1 (x4), each
followed by GN; a downsample (1x1 conv + GN) is built where a stage's first
block changes width or stride.  The compression conv leaves
``round(2048 / (fh * fw))`` channels of the 1/32 map.  The LSTM is written
out by gates (i, f, g, o).

The encoders build their backbone through :func:`make_backbone`:
``ResNet`` for a name in ``PLANS`` (``resnet18``, ``resnet50``), and for
any other name the module that ``benchmark/reference/backbones/<name>.py``
builds, looked up while the encoder is built; a name that no file serves
fails there, naming the file.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import backbones

GN_EPS = 1e-6
PLANS = {"resnet18": ("basic", (2, 2, 2, 2)), "resnet50": ("bottleneck", (3, 4, 6, 3))}
EXPANSION = {"basic": 1, "bottleneck": 4}


def conv(cin, cout, k, stride=1, padding=0):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False)


def gn(groups, ch):
    return nn.GroupNorm(groups, ch, eps=GN_EPS)


class Block(nn.Module):
    def __init__(self, kind, cin, planes, groups, stride, down):
        super().__init__()
        out = planes * EXPANSION[kind]
        if kind == "basic":
            self.convs = nn.Sequential(conv(cin, planes, 3, stride, 1), gn(groups, planes),
                                       nn.ReLU(), conv(planes, planes, 3, 1, 1),
                                       gn(groups, planes))
        else:
            self.convs = nn.Sequential(conv(cin, planes, 1), gn(groups, planes), nn.ReLU(),
                                       conv(planes, planes, 3, stride, 1), gn(groups, planes),
                                       nn.ReLU(), conv(planes, out, 1), gn(groups, out))
        self.downsample = (nn.Sequential(conv(cin, out, 1, stride), gn(groups, out))
                           if down else None)

    def forward(self, x):
        y = self.convs(x)
        r = x if self.downsample is None else self.downsample(x)
        return F.relu(y + r)


class ResNet(nn.Module):
    def __init__(self, name: str, cin: int, base: int = 32):
        super().__init__()
        kind, layers = PLANS[name]
        groups = base // 2
        self.conv1 = nn.Sequential(conv(cin, base, 7, 2, 3), gn(groups, base), nn.ReLU())
        inp = base
        for s, n in enumerate(layers):
            planes = base * 2 ** s
            blocks = []
            for j in range(n):
                stride = (1 if s == 0 else 2) if j == 0 else 1
                down = j == 0 and (stride != 1 or inp != planes * EXPANSION[kind])
                blocks.append(Block(kind, inp, planes, groups, stride, down))
                inp = planes * EXPANSION[kind]
            setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))
        self.final_channels = inp

    def forward(self, x):
        x = F.max_pool2d(self.conv1(x), 3, 2, 1)
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


def make_backbone(name: str, cin: int, base: int = 32) -> nn.Module:
    """The backbone ``name`` on ``cin`` channels: a plan of ``PLANS``, or
    the module of its file under ``backbones/``."""
    if name in PLANS:
        return ResNet(name, cin, base)
    return backbones.lookup(name).build(cin, base)


class Whitening(nn.Module):
    """Per-channel running mean and variance; a batch merges by Chan's
    formula before it is normalised (std floored at 0.1)."""

    def __init__(self, c: int):
        super().__init__()
        self.register_buffer("_mean", torch.zeros(1, c, 1, 1))
        self.register_buffer("_var", torch.zeros(1, c, 1, 1))
        self.register_buffer("_count", torch.zeros(()))

    @torch.no_grad()
    def update(self, x: torch.Tensor, mask: torch.Tensor) -> None:
        m = mask.float()[:, None]
        c = self._mean
        xs = x - c
        s1 = (xs.mean(dim=(2, 3)) * m).sum(0).view_as(c)
        s2 = ((xs * xs).mean(dim=(2, 3)) * m).sum(0).view_as(c)
        n = torch.clamp(m.sum(), min=1e-6)
        d = s1 / n
        mean_b, var_b = c + d, s2 / n - d * d
        n0 = self._count
        tot = n0 + n
        m2 = self._var * n0 + var_b * n + (mean_b - c) ** 2 * n0 * n / tot
        self._var.copy_(m2 / tot)
        self._mean.copy_((n0 * c + n * mean_b) / tot)
        self._count.copy_(tot)

    def forward(self, x):
        return (x - self._mean) / torch.sqrt(torch.clamp(self._var, min=1e-2))


def compression(cin: int, fh: int, fw: int) -> Tuple[nn.Sequential, int]:
    ch = int(round(2048 / (fh * fw)))
    return nn.Sequential(conv(cin, ch, 3, 1, 1), nn.GroupNorm(1, ch, eps=GN_EPS), nn.ReLU()), ch


class VOEncoder(nn.Module):
    def __init__(self, cin: int, h: int, w: int, backbone: str, base: int = 32):
        super().__init__()
        self.running_mean_and_var = Whitening(cin)
        self.backbone = make_backbone(backbone, cin, base)
        fh, fw = math.ceil(h / 32), math.ceil(w / 32)
        self.compression, ch = compression(self.backbone.final_channels, fh, fw)
        self.flat = ch * fh * fw

    def forward(self, packed, update_mask: Optional[torch.Tensor] = None):
        x = packed.permute(0, 3, 1, 2)
        rmv = self.running_mean_and_var
        if update_mask is not None:
            rmv.update(x, update_mask)
        return self.compression(self.backbone(rmv(x)))


class VOCNN(nn.Module):
    """One VO expert: encoder over the packed pair ``[B, H, W, C]`` -> flat
    features -> dropout -> Linear(hidden) -> ReLU -> dropout -> Linear(3)."""

    def __init__(self, cin: int, h: int, w: int, backbone: str = "resnet18",
                 hidden: int = 512, dropout_p: float = 0.2):
        super().__init__()
        self.args = (cin, h, w, backbone, hidden, dropout_p)
        self.visual_encoder = VOEncoder(cin, h, w, backbone)
        self.flat = self.visual_encoder.flat
        self.hidden = hidden
        self.p = dropout_p
        self.visual_fc = nn.Sequential(nn.Flatten(), nn.Dropout(dropout_p),
                                       nn.Linear(self.flat, hidden), nn.ReLU())
        self.output_head = nn.Sequential(nn.Dropout(dropout_p), nn.Linear(hidden, 3))

    def forward(self, packed, update_mask=None, keep: Optional[Sequence[torch.Tensor]] = None):
        f = self.visual_encoder(packed, update_mask).flatten(1)
        fc, head = self.visual_fc[2], self.output_head[1]
        if keep is None:
            return head(F.relu(fc(f)))
        q = 1.0 - self.p
        x = F.relu(fc(f * (keep[0].to(f.dtype) / q)))
        return head(x * (keep[1].to(f.dtype) / q))


class LSTM(nn.Module):
    """Stacked LSTM, parameters named as ``nn.LSTM``'s; one step."""

    def __init__(self, din: int, hidden: int, layers: int):
        super().__init__()
        self.layers, self.hidden = layers, hidden
        for k in range(layers):
            i = din if k == 0 else hidden
            self.register_parameter(f"weight_ih_l{k}", nn.Parameter(torch.empty(4 * hidden, i)))
            self.register_parameter(f"weight_hh_l{k}",
                                    nn.Parameter(torch.empty(4 * hidden, hidden)))
            self.register_parameter(f"bias_ih_l{k}", nn.Parameter(torch.empty(4 * hidden)))
            self.register_parameter(f"bias_hh_l{k}", nn.Parameter(torch.empty(4 * hidden)))

    def step(self, x, hc):
        """x ``[N, D]``; hc ``[2L, N, H]`` packed as ``[h_0..h_L-1, c_0..c_L-1]``."""
        L = self.layers
        hs, cs = [], []
        for k in range(L):
            g = (x @ getattr(self, f"weight_ih_l{k}").t() + getattr(self, f"bias_ih_l{k}")
                 + hc[k] @ getattr(self, f"weight_hh_l{k}").t() + getattr(self, f"bias_hh_l{k}"))
            i, f, gg, o = g.chunk(4, dim=-1)
            c = torch.sigmoid(f) * hc[L + k] + torch.sigmoid(i) * torch.tanh(gg)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
            cs.append(c)
            x = h
        return x, torch.stack(hs + cs)


class _PolicyEncoder(nn.Module):
    def __init__(self, h, w, backbone, base=32):
        super().__init__()
        self.backbone = make_backbone(backbone, 1, base)
        fh, fw = math.ceil((h // 2) / 32), math.ceil((w // 2) / 32)
        self.compression, ch = compression(self.backbone.final_channels, fh, fw)
        self.flat = ch * fh * fw

    def forward(self, depth):
        x = F.avg_pool2d(depth.permute(0, 3, 1, 2), 2)
        return self.compression(self.backbone(x))


class _PolicyNet(nn.Module):
    def __init__(self, h, w, backbone, hidden, layers):
        super().__init__()
        self.visual_encoder = _PolicyEncoder(h, w, backbone)
        self.visual_fc = nn.Sequential(nn.Flatten(), nn.Linear(self.visual_encoder.flat, hidden),
                                       nn.ReLU())
        self.tgt_embeding = nn.Linear(3, 32)
        self.prev_action_embedding = nn.Embedding(5, 32)
        self.state_encoder = nn.Module()
        self.state_encoder.rnn = LSTM(hidden + 64, hidden, layers)


class _Head(nn.Module):
    def __init__(self, name, din, dout):
        super().__init__()
        setattr(self, name, nn.Linear(din, dout))


class Policy(nn.Module):
    """``resnet_rnn_policy`` on depth: 2x2 average pool, ResNet, compression,
    Linear(hidden); the goal ``[rho, cos(-phi), sin(-phi)]`` -> Linear(32); a
    32-d embedding of ``(prev_action + 1) * mask``; the LSTM; a 4-way
    categorical head and a critic."""

    def __init__(self, h, w, backbone="resnet18", hidden=512, layers=2):
        super().__init__()
        self.args = (h, w, backbone, hidden, layers)
        self.net = _PolicyNet(h, w, backbone, hidden, layers)
        self.action_distribution = _Head("linear", hidden, 4)
        self.critic = _Head("fc", hidden, 1)

    def forward(self, depth, goal_polar, hidden, prev_actions, masks):
        net = self.net
        vis = net.visual_fc(net.visual_encoder(depth))
        goal3 = torch.stack([goal_polar[:, 0], torch.cos(-goal_polar[:, 1]),
                             torch.sin(-goal_polar[:, 1])], dim=-1)
        idx = ((prev_actions.float() + 1.0) * masks).long()[:, 0]
        x = torch.cat([vis, net.tgt_embeding(goal3), net.prev_action_embedding.weight[idx]], -1)
        out, hc = net.state_encoder.rnn.step(x, hidden * masks[None])
        return self.action_distribution.linear(out), self.critic.fc(out), hc
