"""Conv and linear layers that compute in the input's dtype, shared by the
GroupNorm ResNets (``models/resnet.py``) and Swin (``models/swin.py``).

The parameters stay in their dtype, as flax's ``dtype=`` beside
``param_dtype=``: a bfloat16 input runs over float32 weights cast in the
forward (gradients reach the float32 parameters through the cast).  An
input in the parameters' dtype runs exactly as plain ``nn.Conv2d`` and
``nn.Linear``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Linear(nn.Linear):
    """``nn.Linear`` computing in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)
