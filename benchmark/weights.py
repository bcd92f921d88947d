"""Seeded weights, made by the benchmark on the device and handed alike to
the measured program and to the reference.

One ``torch.randn`` on a generator on the device fills every float entry
of a state dict, which is then scaled by the entry's kind: a conv or linear
weight by ``1 / sqrt(fan_in)``, an LSTM matrix by ``1 / sqrt(hidden)``, an
embedding by 1; a GroupNorm scale as ``1 + 0.1 n``, a bias as ``0.1 n``.
A whitening layer is either fresh (mean 0, variance 1, count 0: training
from scratch) or as a trained one leaves it (means about 0.3, variances
0.05 to 0.1, count 1e5).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn


def seeded_state_dict(module: nn.Module, seed: int, device, fresh_whitening: bool
                      ) -> Dict[str, torch.Tensor]:
    """A state dict with ``module``'s keys and shapes (build it on the meta
    device), drawn from ``seed``."""
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    total = sum(math.prod(s) for s in shapes.values())
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for k, shape in shapes.items():
        n = math.prod(shape)
        x = flat[at:at + n].view(shape)
        at += n
        leaf = k.rsplit(".", 1)[-1]
        if leaf == "_mean":
            x = torch.zeros_like(x) if fresh_whitening else 0.3 + 0.05 * x
        elif leaf == "_var":
            x = torch.ones_like(x) if fresh_whitening else 0.05 + 0.05 * x.abs()
        elif leaf == "_count":
            x = torch.zeros_like(x) if fresh_whitening else torch.full_like(x, 1e5)
        elif "embedding" in k and leaf == "weight":
            x = x.clone()
        elif leaf.startswith("weight_") and len(shape) == 2:  # an LSTM matrix
            x = x * (1.0 / math.sqrt(shape[0] // 4))
        elif leaf == "weight" and len(shape) >= 2:
            x = x * (1.0 / math.sqrt(math.prod(shape[1:])))
        elif leaf == "weight":  # a GroupNorm scale
            x = 1.0 + 0.1 * x
        else:  # a bias
            x = 0.1 * x
        out[k] = x.contiguous()
    return out
