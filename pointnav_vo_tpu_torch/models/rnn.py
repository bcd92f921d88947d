"""Recurrent state encoder, LSTM (counterpart of ``models/rnn.py``): one
step ``[N, D]`` for acting, and the ``[T, N, D]`` sequence form of the PPO
update.

The hidden state is packed along the layer axis as
``[h_0..h_{L-1}, c_0..c_{L-1}]``, shape ``[2L, N, H]``, and the episode mask
multiplies it before each step (a zero mask resets).  Parameters live in an
``nn.LSTM`` named ``rnn``, so the keys are the reference's
``rnn.weight_ih_l0`` etc.  The GRU is not ported yet.

The sequence form computes the JAX scan ``h_t = step(x_t, h_{t-1} * m_t)``
without a Python loop over steps: where every mask of a step is 1 the
multiply does nothing, so the sequence splits at the steps where some mask
is not 1, and each stretch runs as one cuDNN LSTM call from the hidden state
times the mask of its first step (the reference's ``seq_forward``).  Finding
the splits reads the masks back to the host once per call.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn


def mask_splits(masks: torch.Tensor) -> List[int]:
    """Start steps of the stretches of a ``[T, N, 1]`` mask sequence: 0,
    and every later step at which some env's mask is not 1."""
    later = (masks[1:] != 1).flatten(1).any(dim=1)
    return [0] + (torch.nonzero(later).flatten() + 1).tolist()


class RNNStateEncoder(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1):
        super().__init__()
        self.num_layers = num_layers
        self.rnn = nn.LSTM(input_size, hidden_size, num_layers)

    @property
    def num_recurrent_layers(self) -> int:
        return 2 * self.num_layers

    def _run(self, x: torch.Tensor, hidden: torch.Tensor):
        h, c = hidden[: self.num_layers], hidden[self.num_layers:]
        out, (h, c) = self.rnn(x, (h.contiguous(), c.contiguous()))
        return out, torch.cat([h, c], dim=0)

    def forward(self, x: torch.Tensor, hidden: torch.Tensor, masks: torch.Tensor):
        """One step: x ``[N, D]``, masks ``[N, 1]`` -> (out ``[N, H]``,
        hidden ``[2L, N, H]``).  A sequence: x ``[T, N, D]``, masks
        ``[T, N, 1]`` -> (out ``[T, N, H]``, final hidden)."""
        if x.dim() == 2:
            out, hidden = self._run(x[None], hidden * masks[None])
            return out[0], hidden
        starts = mask_splits(masks)
        outs = []
        for s, e in zip(starts, starts[1:] + [x.shape[0]]):
            out, hidden = self._run(x[s:e], hidden * masks[s][None])
            outs.append(out)
        return torch.cat(outs, dim=0), hidden
