"""Deployment agent (counterpart of ``deploy/challenge_agent.py``): the
Habitat-Challenge-2020 submission surface.

A ``habitat.Agent``-shaped object (``reset()`` / ``act(observations) ->
{"action": id}``) that owns the policy and the VO ensemble and keeps the
dead-reckoned point goal itself, because the challenge task gives only
the episode-start ``pointgoal`` (no GPS/compass):

- on the first step of an episode the polar ``pointgoal`` reading seeds
  the cartesian goal and the policy acts on it directly;
- every later step propagates the goal through the VO delta of the
  (previous, current) frame pair and the previous action: in det mode
  through ``predict_step_cached`` with the frame features cached across
  steps (one ``bin_counts`` a step, one more on the first VO step for the
  previous frame), in rnd mode through ``predict_rnd_packed`` on the same
  cache with the agent's generator, or through a ``vo_fn`` hook;
- once the policy emits STOP the agent stays STOP for the episode.

The agent runs on ``device`` (``None``: the card); ``generator`` (on that
device) draws rnd-mode dropout and, with ``deterministic=False``, actions.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from pointnav_vo_tpu_torch.common import STOP, resolve_device
from pointnav_vo_tpu_torch.ops import geometry as geo
from pointnav_vo_tpu_torch.rl.trainer import GOAL_KEY, act_step, propagate_goal
from pointnav_vo_tpu_torch.vo.ensemble import frame_features_packed


class PointNavVOAgent:
    def __init__(self, *, policy_model, vo_ensemble=None, vo_fn=None,
                 deterministic: bool = True, goal_sensor: str = "pointgoal",
                 generator: Optional[torch.Generator] = None, device=None):
        """``policy_model`` carries its weights.  ``vo_fn(prev_rgb,
        prev_depth, rgb, depth, prev_action, observations) -> (delta [1, 3],
        std)`` replaces the ensemble where it is given."""
        if vo_ensemble is None and vo_fn is None:
            raise ValueError("the agent needs a VO ensemble or a vo_fn")
        self.device = resolve_device(device)
        self.model = policy_model.to(self.device).eval()
        self.vo = vo_ensemble
        if self.vo is not None and self.vo.device != self.device:
            raise ValueError(f"VO ensemble on {self.vo.device}, agent on {self.device}")
        self.vo_fn = vo_fn
        self.deterministic = deterministic
        self.goal_sensor = goal_sensor
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.generator = generator
        self.reset()

    def reset(self) -> None:
        self._hidden = self.model.initial_hidden(1, device=self.device)
        self._prev_action = torch.zeros((1, 1), dtype=torch.int64, device=self.device)
        self._prev_action_np = np.zeros(1, np.int64)  # its host copy
        self._mask = torch.zeros((1, 1), device=self.device)
        self._prev_obs = None
        self._feats = None  # the previous frame's VO features
        self._goal_cart = None
        self._stopped = False

    @staticmethod
    def _goal_polar(goal_cart: torch.Tensor) -> torch.Tensor:
        rho, phi = geo.cartesian_to_polar(-goal_cart[..., 2], goal_cart[..., 0])
        return torch.stack([rho, -phi], dim=-1)

    def _frame(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)[None]

    def _vo_delta(self, rgb, depth, observations) -> torch.Tensor:
        prev_rgb, prev_depth = self._prev_obs
        if self.vo_fn is not None:
            delta, _std = self.vo_fn(prev_rgb, prev_depth, rgb, depth,
                                     self._prev_action[:, 0], observations)
            return torch.as_tensor(delta, dtype=torch.float32, device=self.device)
        actions_np = self._prev_action_np
        if self._feats is None:  # the first VO step: the previous frame's, once
            self._feats = frame_features_packed(prev_rgb, prev_depth, self.vo.cfg)
        if self.vo.cfg.mode == "det":
            delta, self._feats = self.vo.predict_step_cached(self._feats, rgb, depth,
                                                             actions_np)
            return delta
        cur = frame_features_packed(rgb, depth, self.vo.cfg)
        delta, _std = self.vo.predict_rnd_packed(torch.cat([self._feats, cur], dim=-1),
                                                 actions_np, self.generator)
        self._feats = cur
        return delta

    @torch.no_grad()
    def act(self, observations: Dict[str, np.ndarray]) -> Dict[str, int]:
        if self._stopped:
            return {"action": STOP}
        rgb = self._frame(observations["rgb"])
        depth = self._frame(np.asarray(observations["depth"], np.float32))
        if self._prev_obs is None:
            # episode start: the goal from the raw pointgoal reading
            polar = torch.as_tensor(np.asarray(observations[self.goal_sensor], np.float32),
                                    device=self.device)[None]
            self._goal_cart = geo.pointgoal_polar2cartesian(polar)
        else:
            delta = self._vo_delta(rgb, depth, observations)
            self._goal_cart, _ = propagate_goal(
                self._goal_cart, delta, torch.zeros((1, 1), device=self.device),
                self._goal_polar(self._goal_cart))
        policy_obs = {"depth": depth, "rgb": rgb, GOAL_KEY: self._goal_polar(self._goal_cart)}
        _v, action, _lp, self._hidden = act_step(
            self.model, policy_obs, self._hidden, self._prev_action, self._mask,
            None if self.deterministic else self.generator)
        self._prev_obs = (rgb, depth)
        self._prev_action = action
        self._mask = torch.ones((1, 1), device=self.device)
        act_id = int(action[0, 0])  # the step's one read-back
        self._prev_action_np = np.asarray([act_id], np.int64)
        if act_id == STOP:
            self._stopped = True
        return {"action": act_id}

    @property
    def goal_cartesian(self) -> Optional[np.ndarray]:
        """The dead-reckoned goal ``[3]`` (host copy), None before the
        first step."""
        return None if self._goal_cart is None else self._goal_cart[0].cpu().numpy()


def submit_to_challenge(agent: PointNavVOAgent, phase: str = "local") -> None:
    """EvalAI submission hook; needs habitat, imported here only."""
    import habitat

    challenge = habitat.Challenge(eval_remote=(phase == "remote"))
    challenge.submit(agent)
