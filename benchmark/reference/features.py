"""Per-frame VO features: rgb/255, depth, 10-bin discretized depth and the
egocentric top-down view, packed as ``[B, H, W, 15]`` float32.

The top-down view keeps the published model's quirks: the HFOV of 70 is
used as radians, zero-depth pixels inside the band still project to
``min_depth``, and the counts are normalised by each image's largest.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MIN_DEPTH = 0.1
MAX_DEPTH = 10.0
HFOV = 70.0  # radians, as the reference's call sites pass it
ROWS_AROUND_CENTER = 50
EPS = 0.01


def discretize_depth(depth: torch.Tensor, n: int = 10) -> torch.Tensor:
    idx = torch.clamp(torch.floor(depth * n).long(), 0, n - 1)
    return F.one_hot(idx, n).to(depth.dtype)


def blur3(img: torch.Tensor) -> torch.Tensor:
    """OpenCV's 3x3 Gaussian (taps 1/4, 1/2, 1/4) with zero borders, rows
    first."""
    p = F.pad(img, (0, 0, 1, 1))
    x = 0.25 * p[..., :-2, :] + 0.5 * p[..., 1:-1, :] + 0.25 * p[..., 2:, :]
    p = F.pad(x, (1, 1))
    return 0.25 * p[..., :-2] + 0.5 * p[..., 1:-1] + 0.25 * p[..., 2:]


def _first_last(mask: torch.Tensor):
    n = mask.shape[-1]
    idx = torch.arange(n, device=mask.device)
    return (torch.where(mask, idx, n).amin(-1), torch.where(mask, idx, -1).amax(-1))


def top_down_counts(depth: torch.Tensor) -> torch.Tensor:
    """Point counts ``[B, H, W]`` of depth ``[B, H, W]`` (normalised depth)."""
    b, h, w = depth.shape
    dev = depth.device

    def c(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    focal = (w / 2.0) / math.tan(HFOV / 2.0)
    x_bound = (w - 0.5 - w / 2.0) / focal * MAX_DEPTH
    row_has, col_has = depth.sum(2) > 0, depth.sum(1) > 0
    r0, r1 = _first_last(row_has)
    c0, c1 = _first_last(col_has)
    nonempty = row_has.any(1)
    blurred = blur3(depth)
    crop_h = r1 - r0 + 1
    center = torch.div(crop_h + 1, 2, rounding_mode="floor")
    lo = torch.clamp(center - ROWS_AROUND_CENTER, min=0)
    hi = torch.minimum(crop_h, center + ROWS_AROUND_CENTER)
    band = min(2 * ROWS_AROUND_CENTER, h)
    start = torch.clamp(r0 + lo, 0, h - band)
    rows = start[:, None] + torch.arange(band, device=dev)
    d = torch.gather(blurred, 1, rows[:, :, None].expand(-1, -1, w))
    cols = torch.arange(w, device=dev)[None, None, :]
    crow = (rows - r0[:, None])[:, :, None]
    valid = ((crow >= lo[:, None, None]) & (crow < hi[:, None, None])
             & (cols >= c0[:, None, None]) & (cols <= c1[:, None, None])
             & nonempty[:, None, None])
    z = d * c(MAX_DEPTH - MIN_DEPTH) + c(MIN_DEPTH)
    x = (cols.float() + c(0.5) - c(w / 2.0)) / c(focal) * z
    ndc_x = (x - c(-x_bound)) / c(2.0 * x_bound * (1.0 + EPS))
    ndc_d = (z - c(MIN_DEPTH)) / c((MAX_DEPTH - MIN_DEPTH) * (1.0 + EPS))
    pr = (c(h) - torch.ceil(c(h) * ndc_d)).to(torch.int32).long()
    pc = torch.floor(c(w) * ndc_x).to(torch.int32).long()
    ok = valid & (pr >= 0) & (pr < h) & (pc >= 0) & (pc < w)
    img = torch.arange(b, device=dev).view(b, 1, 1)
    flat = torch.where(ok, (img * h + pr) * w + pc, b * h * w).reshape(-1)
    out = torch.zeros(b * h * w + 1, dtype=torch.float32, device=dev)
    out.scatter_add_(0, flat, torch.ones(flat.shape, dtype=torch.float32, device=dev))
    return out[:-1].view(b, h, w)


def top_down_view(depth: torch.Tensor) -> torch.Tensor:
    counts = top_down_counts(depth)
    top = counts.amax(dim=(-2, -1), keepdim=True)
    return torch.where(top > 0, torch.clamp(counts / torch.clamp(top, min=1.0), max=1.0),
                       torch.zeros_like(counts))


def pack_frame(rgb: torch.Tensor, depth: torch.Tensor, dd: int = 10) -> torch.Tensor:
    """rgb ``[B, H, W, 3]`` (uint8 or float), depth ``[B, H, W, 1]`` ->
    ``[B, H, W, 3 + 1 + dd + 1]`` float32: rgb/255, depth, discretized
    depth, top-down view."""
    rgb, depth = rgb.float(), depth.float()
    d = depth[..., 0]
    return torch.cat([rgb / torch.tensor(255.0, device=rgb.device), depth,
                      discretize_depth(d, dd), top_down_view(d)[..., None]], dim=-1)
