"""Rollout storage and returns (counterpart of ``rl/rollout.py``).

Preallocated device tensors of shape ``[T+1, N, ...]`` (``[T, N, ...]`` for
what a step produces), laid out as the JAX storage: observations by key,
the packed recurrent state ``[T+1, 2L, N, H]``, rewards, value predictions,
returns, action log-probs, actions, previous actions and episode masks.
:meth:`RolloutStorage.insert_step`, :meth:`~RolloutStorage.after_update`
and :meth:`~RolloutStorage.compute_returns` write in place and return the
storage.  GAE is a reversed loop over T on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch


@dataclasses.dataclass
class RolloutStorage:
    observations: Dict[str, torch.Tensor]  # each [T+1, N, ...]
    hidden_states: torch.Tensor  # [T+1, L_pack, N, H]
    rewards: torch.Tensor  # [T, N, 1]
    value_preds: torch.Tensor  # [T+1, N, 1]
    returns: torch.Tensor  # [T+1, N, 1]
    action_log_probs: torch.Tensor  # [T, N, 1]
    actions: torch.Tensor  # [T, N, 1] int64
    prev_actions: torch.Tensor  # [T+1, N, 1] int64
    masks: torch.Tensor  # [T+1, N, 1]

    @property
    def num_steps(self) -> int:
        return self.rewards.shape[0]

    @property
    def num_envs(self) -> int:
        return self.rewards.shape[1]

    @classmethod
    def create(cls, num_steps: int, num_envs: int, obs_shapes: Mapping[str, tuple],
               num_packed_hidden: int, hidden_size: int, device=None) -> "RolloutStorage":
        """Zeroed storage, observations in float32."""
        t, n = num_steps, num_envs

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        return cls(
            observations={k: zeros(t + 1, n, *s) for k, s in obs_shapes.items()},
            hidden_states=zeros(t + 1, num_packed_hidden, n, hidden_size),
            rewards=zeros(t, n, 1),
            value_preds=zeros(t + 1, n, 1),
            returns=zeros(t + 1, n, 1),
            action_log_probs=zeros(t, n, 1),
            actions=zeros(t, n, 1, dtype=torch.int64),
            prev_actions=zeros(t + 1, n, 1, dtype=torch.int64),
            masks=zeros(t + 1, n, 1),
        )

    def to(self, device=None, dtype: Optional[torch.dtype] = None) -> "RolloutStorage":
        """A copy on ``device``, its floating tensors cast to ``dtype`` where
        given (a reference run in float64)."""

        def move(x):
            return x.to(device=device, dtype=dtype if x.is_floating_point() else None)

        return RolloutStorage(**{
            f.name: ({k: move(v) for k, v in getattr(self, f.name).items()}
                     if f.name == "observations" else move(getattr(self, f.name)))
            for f in dataclasses.fields(self)})

    def insert_step(self, step: int, observations: Mapping[str, torch.Tensor],
                    hidden_states: torch.Tensor, actions: torch.Tensor,
                    action_log_probs: torch.Tensor, value_preds: torch.Tensor,
                    rewards: torch.Tensor, masks: torch.Tensor) -> "RolloutStorage":
        """Step ``step``'s act outputs, reward and the observations, state
        and masks that follow it (slot ``step + 1``)."""
        for k, v in observations.items():
            self.observations[k][step + 1].copy_(v)
        self.hidden_states[step + 1].copy_(hidden_states)
        self.actions[step].copy_(actions)
        self.prev_actions[step + 1].copy_(actions)
        self.action_log_probs[step].copy_(action_log_probs)
        self.value_preds[step].copy_(value_preds)
        self.rewards[step].copy_(rewards)
        self.masks[step + 1].copy_(masks)
        return self

    def after_update(self) -> "RolloutStorage":
        """Carry the last slot to slot 0 for the next rollout."""
        t = self.num_steps
        for v in self.observations.values():
            v[0].copy_(v[t])
        for v in (self.hidden_states, self.masks, self.prev_actions):
            v[0].copy_(v[t])
        return self

    @torch.no_grad()
    def compute_returns(self, next_value: torch.Tensor, use_gae: bool = True,
                        gamma: float = 0.99, tau: float = 0.95) -> "RolloutStorage":
        """GAE returns (``value_preds[T]`` set to ``next_value``), or plain
        discounted returns (``returns[T]`` set to ``next_value``)."""
        t = self.num_steps
        if use_gae:
            self.value_preds[t].copy_(next_value)
            gae = torch.zeros_like(next_value)
            for i in reversed(range(t)):
                delta = (self.rewards[i] + gamma * self.value_preds[i + 1] * self.masks[i + 1]
                         - self.value_preds[i])
                gae = delta + gamma * tau * self.masks[i + 1] * gae
                self.returns[i].copy_(gae + self.value_preds[i])
            return self
        self.returns[t].copy_(next_value)
        for i in reversed(range(t)):
            self.returns[i].copy_(self.returns[i + 1] * gamma * self.masks[i + 1] + self.rewards[i])
        return self
