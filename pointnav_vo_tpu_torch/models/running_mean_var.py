"""Per-channel running input whitening (counterpart of
``models/running_mean_var.py``).

Buffers keep the reference's names and shapes: ``_mean`` and ``_var``
``(1, C, 1, 1)``, ``_count`` ``()``.  The stddev is floored at 0.1.

With ``update_stats`` a forward first merges the batch into the buffers, as
the JAX module does: one shifted-data pass (per-sample spatial means of
``x - c`` and ``(x - c)^2``, ``c`` the running mean) gives the batch mean
and variance, Chan's formula merges them, and the output is normalised with
the updated buffers.  The buffers change under ``torch.no_grad()``: the
output depends on no parameter.  Both run in the buffers' dtype (float32,
or float64 for a reference run) whatever the input's; ``dtype`` casts the
output (bfloat16 compute, as the JAX module's ``dtype``).

With ``group`` (a ``parallel.dist.Group``, set by the trainer or engine
that runs data-parallel) the batch's ``(s1, s2, count)`` are summed over
the ranks in one all-reduce before the merge, as the JAX module's ``psum``
over ``axis_name``: every rank's buffers take the whole global batch.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class RunningMeanAndVar(nn.Module):
    def __init__(self, n_channels: int):
        super().__init__()
        self.register_buffer("_mean", torch.zeros(1, n_channels, 1, 1))
        self.register_buffer("_var", torch.zeros(1, n_channels, 1, 1))
        self.register_buffer("_count", torch.zeros(()))
        self.group = None

    @torch.no_grad()
    def _update(self, x: torch.Tensor, stats_mask: Optional[torch.Tensor]) -> None:
        m = (torch.ones(x.shape[0], device=x.device) if stats_mask is None
             else stats_mask.float())[:, None]
        c = self._mean
        xs = x.to(c.dtype) - c
        s1 = (xs.mean(dim=(2, 3)) * m).sum(0).view_as(c)
        s2 = ((xs * xs).mean(dim=(2, 3)) * m).sum(0).view_as(c)
        count = m.sum()
        if self.group is not None:
            count = count.to(c.dtype)
            self.group.all_reduce_([s1, s2, count])
        # a batch none of whose samples count still merges a mass of 1e-6
        # (the JAX module's floor), so the buffers move as they do there
        new_count = torch.clamp(count, min=1e-6)
        d = s1 / new_count
        new_mean = c + d
        new_var = s2 / new_count - d * d
        old_count = self._count
        tot = old_count + new_count
        m2 = (self._var * old_count + new_var * new_count
              + (new_mean - c) ** 2 * old_count * new_count / tot)
        self._var.copy_(m2 / tot)
        self._mean.copy_((old_count * c + new_count * new_mean) / tot)
        self._count.copy_(tot)

    def forward(self, x: torch.Tensor, update_stats: bool = False,
                stats_mask: Optional[torch.Tensor] = None,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """x: ``[B, C, H, W]``; ``stats_mask`` ``[B]`` picks the samples that
        feed the statistics (all of them when it is None); the output is in
        ``dtype``, the buffers' where it is None."""
        if update_stats:
            self._update(x, stats_mask)
        y = (x.to(self._mean.dtype) - self._mean) / torch.sqrt(torch.clamp(self._var, min=1e-2))
        return y if dtype is None else y.to(dtype)


def set_stats_group(module: nn.Module, group) -> None:
    """Sum the whitening statistics of every :class:`RunningMeanAndVar` in
    ``module`` over ``group``'s ranks (None: this process alone)."""
    for m in module.modules():
        if isinstance(m, RunningMeanAndVar):
            m.group = group
