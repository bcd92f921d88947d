"""Policy act step and VO goal propagation (counterpart of the inference
pieces of ``rl/trainer.py``; PPO training is not ported yet)."""

from __future__ import annotations

import torch

from pointnav_vo_tpu_torch.models.policy import action_log_prob, mode_action, sample_action
from pointnav_vo_tpu_torch.ops import geometry as geo


@torch.no_grad()
def act_step(model, observations, hidden, prev_actions, masks, generator=None):
    """One policy step -> (value, action ``[N, 1]``, logp, hidden'): the
    mode action, or one drawn from ``generator`` where it is given."""
    logits, value, new_hidden = model(observations, hidden, prev_actions, masks)
    action = mode_action(logits) if generator is None else sample_action(generator, logits)
    return value, action, action_log_prob(logits, action), new_hidden


def propagate_goal(goal_cart, delta, reset_mask, sensor_polar):
    """Dead-reckon the goal through a VO delta; re-seed it from the sensor
    where ``reset_mask`` ``[N, 1]`` marks a new episode."""
    prop = geo.compute_goal_pos(goal_cart, delta)
    seeded = geo.pointgoal_polar2cartesian(sensor_polar)
    new_cart = torch.where(reset_mask > 0, seeded, prop["cartesian"])
    rho, phi = geo.cartesian_to_polar(-new_cart[..., 2], new_cart[..., 0])
    return new_cart, torch.stack([rho, -phi], dim=-1)
