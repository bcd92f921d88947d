"""Depth-derived observation channels (counterpart of ``ops/depth.py``).

- depth discretization: 10-bin one-hot over normalized depth [0, 1];
- 3x3 Gaussian blur matching ``cv2.GaussianBlur(ksize=3, sigma=0,
  borderType=BORDER_ISOLATED)``: OpenCV's fixed separable kernel
  [1/4, 1/2, 1/4] with zero padding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def discretize_depth(depth: torch.Tensor, n_channels: int = 10) -> torch.Tensor:
    """Hard-bin normalized depth into a one-hot ``[..., n_channels]`` volume.

    Bin i covers [i/n, (i+1)/n); d == 1.0 is clipped into the last bin, so
    every row sums to exactly 1.
    """
    idx = torch.clamp(torch.floor(depth * n_channels).long(), 0, n_channels - 1)
    return F.one_hot(idx, n_channels).to(depth.dtype)


def gaussian_blur_3x3(img: torch.Tensor) -> torch.Tensor:
    """Separable 3-tap blur with zero padding over the last two dims.

    ``img``: ``[..., H, W]``.  Shifted adds rather than a convolution: the
    taps are powers of two, so every product is exact and the result is
    independent of cuDNN's TF32 setting; only the sum order differs from
    the JAX banded matmul (a few ulp).
    """
    x = img.float()
    p = F.pad(x, (0, 0, 1, 1))  # rows first, as the JAX twin does
    x = 0.25 * p[..., :-2, :] + 0.5 * p[..., 1:-1, :] + 0.25 * p[..., 2:, :]
    p = F.pad(x, (1, 1))
    x = 0.25 * p[..., :-2] + 0.5 * p[..., 1:-1] + 0.25 * p[..., 2:]
    return x.to(img.dtype)
