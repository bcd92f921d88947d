"""Observation resize and crop transforms (counterpart of
``ops/transforms.py``), on NHWC images ``[..., H, W, C]``.

``VO.OBS_TRANSFORM`` selects one (:func:`apply_obs_transform`):
``resize`` (area resize of the shortest edge to the smaller of the target
sides), ``resize_crop`` (area resize of the shortest edge to the larger
side, then a center crop to the target) and ``resize_nearest`` (nearest
resize of the shortest edge to the smaller side).

Area resize is adaptive box averaging: output cell ``i`` of an axis
averages input ``[floor(i * n / m), ceil((i + 1) * n / m))``, which is
``F.adaptive_avg_pool2d``.  Nearest resize picks input row ``i * h // oh``
(and column ``j * w // ow``), the JAX package's integer rule; it is not
``F.interpolate(mode="nearest")``, which floors a float scale and can
pick another row.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

TRANSFORMS = ("none", "resize", "resize_crop", "resize_nearest")


def resize_area(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Area resize ``[..., H, W, C]`` to ``[..., out_h, out_w, C]``,
    computed in float32 and returned in the input's dtype."""
    h, w, c = img.shape[-3:]
    if (h, w) == tuple(out_hw):
        return img
    lead = img.shape[:-3]
    x = img.float().reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.adaptive_avg_pool2d(x, tuple(out_hw)).permute(0, 2, 3, 1)
    return y.reshape(*lead, *out_hw, c).to(img.dtype)


def resize_nearest(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize ``[..., H, W, C]`` to ``[..., out_h, out_w, C]``."""
    h, w = img.shape[-3], img.shape[-2]
    oh, ow = out_hw
    rows = torch.arange(oh, device=img.device) * h // oh
    cols = torch.arange(ow, device=img.device) * w // ow
    return img.index_select(-3, rows).index_select(-2, cols)


def center_crop(img: torch.Tensor, size_wh: Tuple[int, int]) -> torch.Tensor:
    """Center crop ``[..., H, W, C]`` to ``(crop_w, crop_h)``, the
    reference's argument order."""
    crop_w, crop_h = size_wh
    h, w = img.shape[-3], img.shape[-2]
    x0 = w // 2 - crop_w // 2
    y0 = h // 2 - crop_h // 2
    return img[..., y0:y0 + crop_h, x0:x0 + crop_w, :]


def _shortest_edge_hw(h: int, w: int, size: int) -> Tuple[int, int]:
    scale = size / min(h, w)
    return int(h * scale), int(w * scale)


def resize_shortest_edge(img: torch.Tensor, size: int) -> torch.Tensor:
    h, w = img.shape[-3], img.shape[-2]
    return resize_area(img, _shortest_edge_hw(h, w, size))


def apply_obs_transform(img: torch.Tensor, kind: str, size_wh: Tuple[int, int]) -> torch.Tensor:
    """The ``VO.OBS_TRANSFORM`` value ``kind`` on ``[..., H, W, C]``, with
    ``size_wh`` = (``VIS_SIZE_W``, ``VIS_SIZE_H``)."""
    if kind in (None, "none"):
        return img
    if kind == "resize":
        return resize_shortest_edge(img, min(size_wh))
    if kind == "resize_crop":
        return center_crop(resize_shortest_edge(img, max(size_wh)), size_wh)
    if kind == "resize_nearest":
        h, w = img.shape[-3], img.shape[-2]
        return resize_nearest(img, _shortest_edge_hw(h, w, min(size_wh)))
    raise ValueError(f"unknown obs transform {kind!r}; have {TRANSFORMS}")
