"""Swin-B (Liu et al., ICCV 2021, arXiv:2103.14030) in plain torch,
float32, in the dense-prediction form of Swin-Transformer-Object-Detection's
``mmdet/models/backbones/swin_transformer.py``, which takes any input size.

The published ``swin_base_patch4_window7_224`` plan: patch 4, embed 128,
depths (2, 2, 18, 2), heads (4, 8, 16, 32), window 7, MLP ratio 4, qkv
bias, no absolute position embedding, patch norm; LayerNorm eps 1e-5.

- Patch embedding: zero-pad right and bottom to multiples of 4, a 4x4/4
  conv with bias, LayerNorm over the tokens.
- Block ``j`` of a stage (shift 3 where ``j`` is odd): ``y = LN1(x)``,
  zero-padded right and bottom to whole windows, rolled by ``(-3, -3)``,
  cut into 7x7 windows; in each, ``softmax(q k^T / sqrt(32) + bias [+
  mask]) v`` per head, then ``proj``; the windows put back, rolled back,
  cropped; ``x = x + y``; then ``x = x + fc2(gelu(fc1(LN2(x))))``.
  ``bias[h, p, q] = table[(r_p - r_q + 6) * 13 + (c_p - c_q + 6), h]``;
  the mask is -100 between tokens whose labels differ, labelling the
  padded map's slices ``(0:-7, -7:-3, -3:)`` on each axis.
- Patch merging after stages 1-3: pad an odd side by one, concatenate the
  2x2 neighbours ``(0,0), (1,0), (0,1), (1,1)``, LayerNorm, a linear to
  twice the width without bias.
- Output: ``norm3`` over stage 4's tokens, NCHW.

The attention is written out (``q @ k^T``, softmax, ``@ v``), every
constant is built in the forward on the input's device, and nothing of the
measured program is imported.  ``base`` is ignored: Swin's widths are its
own.
"""

from __future__ import annotations

import math

import torch
from torch import nn

PATCH = 4
EMBED = 128
DEPTHS = (2, 2, 18, 2)
HEADS = (4, 8, 16, 32)
WINDOW = 7
SHIFT = 3
MLP_RATIO = 4
LN_EPS = 1e-5


def _ln(ch: int) -> nn.LayerNorm:
    return nn.LayerNorm(ch, eps=LN_EPS)


def _partition(x: torch.Tensor) -> torch.Tensor:
    """``[B, Hp, Wp, C]`` -> ``[B, nW, 49, C]``."""
    b, hp, wp, c = x.shape
    x = x.view(b, hp // WINDOW, WINDOW, wp // WINDOW, WINDOW, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, -1, WINDOW * WINDOW, c)


def _reverse(x: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    b, c = x.shape[0], x.shape[-1]
    x = x.view(b, hp // WINDOW, wp // WINDOW, WINDOW, WINDOW, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)


def _bias_index(device) -> torch.Tensor:
    """``[49, 49]``: the published ``relative_position_index``."""
    coords = torch.stack(torch.meshgrid(torch.arange(WINDOW, device=device),
                                        torch.arange(WINDOW, device=device),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (WINDOW - 1)
    return rel[:, :, 0] * (2 * WINDOW - 1) + rel[:, :, 1]


def _region_mask(hp: int, wp: int, device) -> torch.Tensor:
    """``[nW, 49, 49]``, as the published ``BasicLayer`` builds it."""
    img = torch.zeros((1, hp, wp, 1), device=device)
    cnt = 0
    for hs in (slice(0, -WINDOW), slice(-WINDOW, -SHIFT), slice(-SHIFT, None)):
        for ws in (slice(0, -WINDOW), slice(-WINDOW, -SHIFT), slice(-SHIFT, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    win = _partition(img)[0, :, :, 0]
    mask = win[:, None, :] - win[:, :, None]
    return mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * WINDOW - 1) ** 2, heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask) -> torch.Tensor:
        """``x [B, nW, 49, C]`` (the batch stays the first axis of every
        linear's input); ``mask [nW, 49, 49]`` or None."""
        b, nw, n, c = x.shape
        h, d = self.heads, c // self.heads
        q, k, v = self.qkv(x).view(b, nw, n, 3, h, d).permute(3, 0, 1, 4, 2, 5)
        attn = (q * d ** -0.5) @ k.transpose(-2, -1)  # [B, nW, heads, 49, 49]
        idx = _bias_index(x.device).flatten()
        attn = attn + self.relative_position_bias_table[idx].view(n, n, h).permute(2, 0, 1)
        if mask is not None:
            attn = attn + mask[:, None]
        y = attn.softmax(dim=-1) @ v
        return self.proj(y.transpose(2, 3).reshape(b, nw, n, c))


class _Mlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, MLP_RATIO * dim)
        self.fc2 = nn.Linear(MLP_RATIO * dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(nn.functional.gelu(self.fc1(x)))


class _Block(nn.Module):
    def __init__(self, dim: int, heads: int, shift: int):
        super().__init__()
        self.shift = shift
        self.norm1 = _ln(dim)
        self.attn = _Attention(dim, heads)
        self.norm2 = _ln(dim)
        self.mlp = _Mlp(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        hp, wp = math.ceil(h / WINDOW) * WINDOW, math.ceil(w / WINDOW) * WINDOW
        y = nn.functional.pad(self.norm1(x), (0, 0, 0, wp - w, 0, hp - h))
        mask = None
        if self.shift:
            y = torch.roll(y, (-self.shift, -self.shift), dims=(1, 2))
            mask = _region_mask(hp, wp, x.device)
        y = _reverse(self.attn(_partition(y), mask), hp, wp)
        if self.shift:
            y = torch.roll(y, (self.shift, self.shift), dims=(1, 2))
        x = x + y[:, :h, :w]
        return x + self.mlp(self.norm2(x))


class _Merge(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = _ln(4 * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        x = nn.functional.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      -1)
        return self.reduction(self.norm(x))


class _Stage(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, merge: bool):
        super().__init__()
        self.blocks = nn.ModuleList(_Block(dim, heads, SHIFT if j % 2 else 0)
                                    for j in range(depth))
        self.downsample = _Merge(dim) if merge else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x if self.downsample is None else self.downsample(x)


class _PatchEmbed(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, EMBED, PATCH, stride=PATCH)
        self.norm = _ln(EMBED)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        x = nn.functional.pad(x, (0, -w % PATCH, 0, -h % PATCH))
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class SwinB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.patch_embed = _PatchEmbed(cin)
        self.layers = nn.ModuleList(_Stage(EMBED * 2 ** i, d, n, i < 3)
                                    for i, (d, n) in enumerate(zip(DEPTHS, HEADS)))
        self.final_channels = EMBED * 8
        self.norm3 = _ln(self.final_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)
        for stage in self.layers:
            x = stage(x)
        return self.norm3(x).permute(0, 3, 1, 2).contiguous()


def build(cin: int, base: int) -> SwinB:
    return SwinB(cin)


def macs(cin: int, h: int, w: int, base: int):
    """From the plan, what the file contract counts (convs and linears):
    the patch conv over ``ceil(h/4) x ceil(w/4)`` tokens; in each block
    qkv and proj over the map padded to whole windows, ``Hp x Wp``, and
    the MLP over the real ``H x W``; each merge over its output tokens.

    Left out: the attention's own matmuls, ``q k^T`` and the weights times
    ``v``, ``2 * 49 * C`` multiply-adds a padded token in each block.  At
    the eval cell's 341x192 they are 0.55 G of the pair's 23.45 G, so the
    step's analytic FLOPs read about 2.4 % low there."""
    h, w = math.ceil(h / PATCH), math.ceil(w / PATCH)
    total = EMBED * cin * PATCH * PATCH * h * w
    for i, depth in enumerate(DEPTHS):
        c = EMBED * 2 ** i
        hp, wp = math.ceil(h / WINDOW) * WINDOW, math.ceil(w / WINDOW) * WINDOW
        total += depth * (hp * wp * 4 * c * c + h * w * 2 * MLP_RATIO * c * c)
        if i < len(DEPTHS) - 1:
            h, w = math.ceil(h / 2), math.ceil(w / 2)
            total += h * w * 4 * c * 2 * c
    return total, EMBED * 8, h, w
