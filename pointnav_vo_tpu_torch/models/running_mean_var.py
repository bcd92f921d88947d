"""Per-channel input whitening with frozen statistics (counterpart of
``models/running_mean_var.py``, inference only).

Buffers keep the reference's names and shapes: ``_mean`` and ``_var``
``(1, C, 1, 1)``, ``_count`` ``()``.  The stddev is floored at 0.1.
"""

from __future__ import annotations

import torch
from torch import nn


class RunningMeanAndVar(nn.Module):
    def __init__(self, n_channels: int):
        super().__init__()
        self.register_buffer("_mean", torch.zeros(1, n_channels, 1, 1))
        self.register_buffer("_var", torch.zeros(1, n_channels, 1, 1))
        self.register_buffer("_count", torch.zeros(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: ``[B, C, H, W]``."""
        return (x - self._mean) / torch.sqrt(torch.clamp(self._var, min=1e-2))
