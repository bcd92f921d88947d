"""Recurrent state encoder, LSTM, single step (counterpart of
``models/rnn.py``).

The hidden state is packed along the layer axis as
``[h_0..h_{L-1}, c_0..c_{L-1}]``, shape ``[2L, N, H]``, and the episode mask
multiplies it before the step (a zero mask resets).  Parameters live in an
``nn.LSTM`` named ``rnn``, so the keys are the reference's
``rnn.weight_ih_l0`` etc.  The GRU and the ``[T, N]`` sequence form (for
training) are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn


class RNNStateEncoder(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1):
        super().__init__()
        self.num_layers = num_layers
        self.rnn = nn.LSTM(input_size, hidden_size, num_layers)

    @property
    def num_recurrent_layers(self) -> int:
        return 2 * self.num_layers

    def forward(self, x: torch.Tensor, hidden: torch.Tensor, masks: torch.Tensor):
        """x ``[N, D]``, hidden ``[2L, N, H]``, masks ``[N, 1]`` ->
        (out ``[N, H]``, hidden ``[2L, N, H]``)."""
        hidden = hidden * masks[None]
        h, c = hidden[: self.num_layers], hidden[self.num_layers:]
        out, (h, c) = self.rnn(x[None], (h.contiguous(), c.contiguous()))
        return out[0], torch.cat([h, c], dim=0)
