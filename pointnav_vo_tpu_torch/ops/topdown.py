"""Egocentric top-down projection of a depth map (counterpart of
``ops/topdown.py``), vectorised over the batch.

Per image: strip all-zero border rows/cols (as masking), 3x3-blur, take
the <= 2 * rows_around_center row band around the crop's vertical centre,
unproject those pixels through the pinhole intrinsics, bin the (x, forward)
points into an H x W count grid (:func:`topdown_kernels.bin_counts`) and
normalise by the per-image max count.

Parity quirks kept on purpose (the published checkpoints bake them in):

- ``hfov`` is consumed as radians but every reference call site passes the
  HFOV in degrees (70), so the intrinsics use ``tan(35 rad)``;
- zero-depth pixels inside the selection window still unproject (to a point
  at ``min_depth``) and are counted.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from pointnav_vo_tpu_torch.ops.depth import gaussian_blur_3x3
from pointnav_vo_tpu_torch.ops.topdown_kernels import bin_counts

_EPSILON = 0.01


@dataclasses.dataclass(frozen=True)
class TopDownParams:
    """Static projection parameters."""

    min_depth: float = 0.1
    max_depth: float = 10.0
    vis_size_h: int = 192
    vis_size_w: int = 341
    # NOTE: the reference passes HFOV in degrees into a radians slot; keep the
    # raw number to stay checkpoint-compatible.
    hfov_rad: float = 70.0
    rows_around_center: int = 50

    @property
    def focal(self) -> float:
        return (self.vis_size_w / 2.0) / math.tan(self.hfov_rad / 2.0)

    @property
    def x_bound(self) -> float:
        """Half-width of the x range at max_depth."""
        u0 = self.vis_size_w / 2.0
        return (self.vis_size_w - 0.5 - u0) / self.focal * self.max_depth


def _crop_bounds(mask_any: torch.Tensor):
    """Per row of ``[B, n]``: first/last True index (all False -> (n, -1))."""
    n = mask_any.shape[-1]
    idx = torch.arange(n, device=mask_any.device)
    first = torch.where(mask_any, idx, n).amin(-1)
    last = torch.where(mask_any, idx, -1).amax(-1)
    return first, last


def pixel_bins(depth: torch.Tensor, params: TopDownParams = TopDownParams()):
    """Per-candidate-point output bins ``(pix_r, pix_c, keep)``, each
    ``[B, band, W]``, for depth ``[B, H, W]``.

    Constants enter the arithmetic as float32 tensors on the depth's device:
    CUDA divides by a host scalar as a multiply by its reciprocal, which is
    not the true division the CPU and the JAX twin do.
    """
    h, w = params.vis_size_h, params.vis_size_w
    if depth.dim() != 3 or tuple(depth.shape[1:]) != (h, w):
        raise ValueError(f"expected [B, {h}, {w}], got {tuple(depth.shape)}")
    dev = depth.device
    depth = depth.float()

    def const(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    row_has = depth.sum(2) > 0  # [B, H]
    col_has = depth.sum(1) > 0  # [B, W]
    min_row, max_row = _crop_bounds(row_has)
    min_col, max_col = _crop_bounds(col_has)
    nonempty = row_has.any(1)

    blurred = gaussian_blur_3x3(depth)

    # rows around ceil(crop_h / 2) of the crop (the reference's centre crop)
    rac = params.rows_around_center
    crop_h = max_row - min_row + 1
    center = torch.div(crop_h + 1, 2, rounding_mode="floor")
    sel_lo = torch.clamp(center - rac, min=0)
    sel_hi = torch.minimum(crop_h, center + rac)

    band = min(2 * rac, h)
    start = torch.clamp(min_row + sel_lo, 0, h - band)  # [B]
    band_rows = start[:, None] + torch.arange(band, device=dev)  # [B, band]
    band_depth = torch.gather(
        blurred, 1, band_rows[:, :, None].expand(-1, -1, w))  # [B, band, W]

    cols = torch.arange(w, device=dev)[None, None, :]
    crop_row = (band_rows - min_row[:, None])[:, :, None]
    valid = (
        (crop_row >= sel_lo[:, None, None])
        & (crop_row < sel_hi[:, None, None])
        & (cols >= min_col[:, None, None])
        & (cols <= max_col[:, None, None])
        & nonempty[:, None, None]
    )

    # unproject: only x (right) and true depth (forward) matter for binning
    true_depth = (band_depth * const(params.max_depth - params.min_depth)
                  + const(params.min_depth))
    x = ((cols.float() + const(0.5) - const(w / 2.0)) / const(params.focal)
         * true_depth)

    # NDC + pixelization
    ndc_x = (x - const(-params.x_bound)) / const(
        2.0 * params.x_bound * (1.0 + _EPSILON))
    ndc_d = (true_depth - const(params.min_depth)) / const(
        (params.max_depth - params.min_depth) * (1.0 + _EPSILON))
    pix_r = (const(h) - torch.ceil(const(h) * ndc_d)).to(torch.int32)
    pix_c = torch.floor(const(w) * ndc_x).to(torch.int32)
    keep = valid & (pix_r >= 0) & (pix_r < h) & (pix_c >= 0) & (pix_c < w)
    return pix_r.contiguous(), pix_c.contiguous(), keep.contiguous()


def top_down_counts(depth: torch.Tensor,
                    params: TopDownParams = TopDownParams()) -> torch.Tensor:
    """Raw per-cell point counts ``[..., H, W]`` before normalisation."""
    flat = depth.reshape((-1,) + tuple(depth.shape[-2:]))
    pix_r, pix_c, keep = pixel_bins(flat, params)
    counts = bin_counts(pix_r, pix_c, keep, params.vis_size_h, params.vis_size_w)
    return counts.reshape(depth.shape)


def top_down_view_batch(depth: torch.Tensor,
                        params: TopDownParams = TopDownParams()) -> torch.Tensor:
    """Batched projection ``[..., H, W] -> [..., H, W]`` in [0, 1]."""
    return normalize_counts(top_down_counts(depth, params))


def normalize_counts(counts: torch.Tensor) -> torch.Tensor:
    """Per-cell counts ``[..., H, W]`` over each image's largest count,
    clamped to 1; an image with no point is all zeros."""
    bound = counts.amax(dim=(-2, -1), keepdim=True)
    return torch.where(bound > 0,
                       torch.clamp(counts / torch.clamp(bound, min=1.0), max=1.0),
                       torch.zeros_like(counts))
