"""Swin-B (Liu et al., "Swin Transformer: Hierarchical Vision Transformer
using Shifted Windows", ICCV 2021, arXiv:2103.14030) as a backbone of
``resnet.BACKBONES``: NCHW in, the 1/32 map ``[B, 1024, ceil(H/32),
ceil(W/32)]`` out, as the ResNets give it.

The plan is the published ``swin_base_patch4_window7_224``: a 4x4 patch
embedding to 128 channels, stages of depth (2, 2, 18, 2) at widths 128,
256, 512 and 1024 with (4, 8, 16, 32) heads of 32 channels, window 7, MLP
ratio 4, a bias on qkv, no absolute position embedding, a LayerNorm after
the patch embedding.  The form is the dense-prediction backbone's
(Swin-Transformer-Object-Detection, ``mmdet/models/backbones/
swin_transformer.py``), which takes any input size:

- the patch embedding zero-pads the input right and bottom to multiples of
  4, and patch merging pads a map with an odd side by one;
- every block pads its map right and bottom to whole windows *after* its
  first LayerNorm, and the padded tokens take part in the attention
  unmasked; the window stays 7 on maps smaller than a window;
- the odd blocks of a stage roll the map by (-3, -3) before the windows
  are cut and add the region mask, -100 between tokens of different
  regions (the slices ``(0:-7, -7:-3, -3:)`` of each axis of the padded
  map), and roll back after;
- the output is ``norm3``, a LayerNorm over the last stage's channels.

Each window's logits get a learned relative-position bias,
``relative_position_bias_table[(r_p - r_q + 6) * 13 + (c_p - c_q + 6), h]``
over the window's row-major positions.  The attention itself is
``F.scaled_dot_product_attention`` with the bias and the region mask folded
into one additive mask.

Parameter names are the published checkpoints' (``patch_embed.proj``,
``layers.{i}.blocks.{j}.attn.qkv``, ``layers.{i}.downsample.reduction``,
``norm3``...).  The bias index (a buffer built with the module) and the
region masks (built on the input's card by device ops the first time a
stage meets a padded map size, then cached on the stage) are in no state
dict, so no upload from the host happens in a step or in a CUDA graph's
capture.  Each attention call counts its windows, ``B * nW``, in the
tracer's ``swin_windows``.

Compute runs in the input's dtype over parameters in theirs
(``layers.Conv2d``, ``layers.Linear``); LayerNorm takes its statistics in
the parameters' dtype and casts back, as the ResNets' GroupNorm.  LayerNorm
uses eps 1e-5, the published value.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from pointnav_vo_tpu_torch.models.layers import Conv2d, Linear
from pointnav_vo_tpu_torch.utils.logging import TRACER

PATCH = 4
EMBED_DIM = 128
DEPTHS = (2, 2, 18, 2)
HEADS = (4, 8, 16, 32)
WINDOW = 7
SHIFT = WINDOW // 2
MLP_RATIO = 4
LN_EPS = 1e-5
MASK_VALUE = -100.0  # between tokens of different regions of a shifted window


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computed in the parameters' dtype and cast back to
    the input's (a no-op where the two agree)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.to(self.weight.dtype), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


def _up(n: int) -> int:
    """``n`` rounded up to whole windows."""
    return math.ceil(n / WINDOW) * WINDOW


def window_partition(x: torch.Tensor) -> torch.Tensor:
    """``[B, Hp, Wp, C]`` -> ``[B, nW, 49, C]``, windows in row-major order."""
    b, hp, wp, c = x.shape
    x = x.view(b, hp // WINDOW, WINDOW, wp // WINDOW, WINDOW, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, -1, WINDOW * WINDOW, c)


def window_reverse(x: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """The inverse of :func:`window_partition`."""
    b, _, _, c = x.shape
    x = x.view(b, hp // WINDOW, wp // WINDOW, WINDOW, WINDOW, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)


def relative_position_index() -> torch.Tensor:
    """``[49 * 49]`` int64: the bias table's row for each (query, key) pair
    of a window's row-major positions."""
    r = torch.arange(WINDOW)
    rows, cols = r.repeat_interleave(WINDOW), r.repeat(WINDOW)
    span = 2 * WINDOW - 1
    return ((rows[:, None] - rows[None, :] + WINDOW - 1) * span
            + cols[:, None] - cols[None, :] + WINDOW - 1).flatten()


def shift_mask(hp: int, wp: int, device=None) -> torch.Tensor:
    """``[nW, 49, 49]`` float32: :data:`MASK_VALUE` where two tokens of a
    window of the rolled ``hp x wp`` map lie in different regions, else 0.
    Device ops only: no upload from the host."""

    def band(n):  # 0, 1, 2 over the slices (0:-7, -7:-3, -3:)
        i = torch.arange(n, device=device)
        return (i >= n - WINDOW).long() + (i >= n - SHIFT).long()

    labels = band(hp)[:, None] * 3 + band(wp)[None, :]
    labels = window_partition(labels[None, :, :, None])[0, :, :, 0]  # [nW, 49]
    differ = labels[:, :, None] != labels[:, None, :]
    return torch.zeros(differ.shape, device=device).masked_fill_(differ, MASK_VALUE)


class WindowAttention(nn.Module):
    """Multi-head self-attention within each 7x7 window, with the learned
    relative-position bias, over ``[B, nW, 49, C]``."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * WINDOW - 1) ** 2, heads))
        self.register_buffer("relative_position_index", relative_position_index(),
                             persistent=False)
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mask``: a shifted block's ``[nW, 49, 49]`` region mask."""
        b, nw, n, c = x.shape
        h, d = self.heads, c // self.heads
        TRACER.count("swin_windows", b * nw)
        # [3, B * nW, heads, 49, d]: one layout that also views as
        # [3, B, nW * heads, 49, d], where a region mask varies by window
        qkv = self.qkv(x).view(b * nw, n, 3, h, d).permute(2, 0, 3, 1, 4).contiguous()
        bias = self.relative_position_bias_table.index_select(
            0, self.relative_position_index).view(n, n, h).permute(2, 0, 1).contiguous()
        if mask is None:
            q, k, v = qkv.unbind(0)
            add = bias[None]
        else:
            q, k, v = qkv.view(3, b, nw * h, n, d).unbind(0)
            add = (bias[None] + mask[:, None]).reshape(1, nw * h, n, n)
        y = F.scaled_dot_product_attention(q, k, v, attn_mask=add.to(x.dtype))
        return self.proj(y.reshape(b, nw, h, n, d).transpose(2, 3).reshape(b, nw, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = Linear(dim, MLP_RATIO * dim)
        self.fc2 = Linear(MLP_RATIO * dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """Pre-norm window attention (shifted by ``shift``) and MLP, each with
    its residual, over ``[B, H, W, C]``."""

    def __init__(self, dim: int, heads: int, shift: int):
        super().__init__()
        self.shift = shift
        self.norm1 = LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, heads)
        self.norm2 = LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        _, h, w, _ = x.shape
        hp, wp = _up(h), _up(w)
        y = self.norm1(x)
        if (hp, wp) != (h, w):
            y = F.pad(y, (0, 0, 0, wp - w, 0, hp - h))
        s = self.shift
        if s:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
        y = window_reverse(self.attn(window_partition(y), mask if s else None), hp, wp)
        if s:
            y = torch.roll(y, (s, s), dims=(1, 2))
        x = x + y[:, :h, :w]
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """2x2 neighbours concatenated (an odd side padded by one), LayerNorm,
    then a linear to twice the width: ``[B, H, W, C]`` -> ``[B, ceil(H/2),
    ceil(W/2), 2C]``."""

    def __init__(self, dim: int):
        super().__init__()
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)
        self.norm = LayerNorm(4 * dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        return self.reduction(self.norm(x))


class SwinStage(nn.Module):
    """A stage's blocks (the odd ones shifted), then patch merging where
    ``downsample``.  The region masks are cached here by padded map size
    and card."""

    def __init__(self, dim: int, depth: int, heads: int, downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(SwinBlock(dim, heads, SHIFT if j % 2 else 0)
                                    for j in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None
        self._masks: Dict[tuple, torch.Tensor] = {}

    def mask(self, hp: int, wp: int, device: torch.device) -> torch.Tensor:
        """The region mask of an ``hp x wp`` map, built once.  During a
        stream capture a missing one is built into the graph and not kept:
        a capture records its kernels without running them."""
        key = (hp, wp, device)
        m = self._masks.get(key)
        if m is None:
            m = shift_mask(hp, wp, device)
            if not (device.type == "cuda" and torch.cuda.is_current_stream_capturing()):
                self._masks[key] = m
        return m

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mask = self.mask(_up(x.shape[1]), _up(x.shape[2]), x.device)
        for block in self.blocks:
            x = block(x, mask)
        return x if self.downsample is None else self.downsample(x)


class PatchEmbed(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.proj = Conv2d(in_channels, EMBED_DIM, PATCH, stride=PATCH)
        self.norm = LayerNorm(EMBED_DIM, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW -> ``[B, ceil(H/4), ceil(W/4), 128]``."""
        h, w = x.shape[-2:]
        if h % PATCH or w % PATCH:
            x = F.pad(x, (0, -w % PATCH, 0, -h % PATCH))
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class SwinTransformer(nn.Module):
    """Swin-B over ``in_channels``: NCHW in, ``[B, 1024, ceil(H/32),
    ceil(W/32)]`` out."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.patch_embed = PatchEmbed(in_channels)
        last = len(DEPTHS) - 1
        self.layers = nn.ModuleList(
            SwinStage(EMBED_DIM * 2 ** i, depth, heads, i < last)
            for i, (depth, heads) in enumerate(zip(DEPTHS, HEADS)))
        self.final_channels = EMBED_DIM * 2 ** last
        self.norm3 = LayerNorm(self.final_channels, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)
        for stage in self.layers:
            x = stage(x)
        return self.norm3(x).permute(0, 3, 1, 2).contiguous()


def swin_b(in_channels: int, base_planes: int = 32, ngroups: int = 16) -> SwinTransformer:
    """Swin-B on ``in_channels``.  ``base_planes`` and ``ngroups`` are the
    ResNets' arguments, accepted for the registry's one signature and
    ignored: Swin's widths are its own, and it has no GroupNorm."""
    return SwinTransformer(in_channels)
