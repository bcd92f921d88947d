"""DD-PPO trainer with VO in the loop, one process (counterpart of
``rl/trainer.py``): the policy act step, VO goal propagation and
:class:`DDPPOTrainer`.

A rollout step acts for all envs at once on the device (the action drawn
from the trainer's device generator), reads the actions back once to step
the envs on the host, and, with VO in the loop (the reference's
``TUNE_WITH_VO``), dead-reckons the goal the policy sees through the VO
ensemble instead of reading the GPS sensor: each new frame's features are
computed once and paired with the previous frame's, which the last step
left in a cache, so a det step runs ``bin_counts`` once.  Episode resets
re-seed the goal from the new episode's sensor.  A policy with whitening
buffers (the rgb policies) folds each rollout step's frames into them, as
the JAX trainer's ``act_step_update_stats``; the update's bootstrap act and
the PPO update read them as they stand.  An update computes the returns and
runs :func:`rl.ppo.ppo_update`.  Across processes
(``torch.distributed``) is not ported yet.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from pointnav_vo_tpu_torch.common import resolve_device
from pointnav_vo_tpu_torch.io.checkpoint import generator_state, restore_generator
from pointnav_vo_tpu_torch.io.weights import (
    POLICY_PREFIX,
    policy_state_dict_from_container,
    seeded_init_,
)
from pointnav_vo_tpu_torch.models.policy import action_log_prob, mode_action, sample_action
from pointnav_vo_tpu_torch.models.running_mean_var import RunningMeanAndVar
from pointnav_vo_tpu_torch.ops import geometry as geo
from pointnav_vo_tpu_torch.rl.ppo import PPOConfig, make_optimizer, ppo_update
from pointnav_vo_tpu_torch.rl.rollout import RolloutStorage
from pointnav_vo_tpu_torch.vo.ensemble import frame_features_packed

GOAL_KEY = "pointgoal_with_gps_compass"


@torch.no_grad()
def act_step(model, observations, hidden, prev_actions, masks, generator=None,
             update_stats=False):
    """One policy step -> (value, action ``[N, 1]``, logp, hidden'): the
    mode action, or one drawn from ``generator`` where it is given.  With
    ``update_stats`` the step first folds its frames into the policy's
    whitening buffers."""
    if update_stats:
        logits, value, new_hidden = model(observations, hidden, prev_actions, masks,
                                           update_stats=True)
    else:
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


class DDPPOTrainer:
    """PPO over a VectorEnv with optional VO in the loop.

    ``state_dict`` loads the policy's weights; without it they are drawn
    from ``init_generator`` (a CPU generator, by ``io.weights.seeded_init_``).
    ``generator`` (on the device; seeded 0 where not given) draws the
    actions, the minibatch order and rnd-mode VO dropout.  ``vo_ensemble``
    (det or rnd) or ``vo_fn(prev_obs, new_obs, actions_np, infos) -> delta
    [N, 3]`` puts VO in the loop.  ``device=None`` means the card.
    """

    def __init__(self, *, model, ppo_cfg: PPOConfig, envs, device=None,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 init_generator: Optional[torch.Generator] = None,
                 generator: Optional[torch.Generator] = None, vo_ensemble=None,
                 vo_fn=None, total_updates: Optional[int] = None):
        self.device = resolve_device(device)
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        else:
            seeded_init_(model, init_generator or torch.Generator().manual_seed(0))
        # training mode throughout: the policy has no layer that acts
        # differently in it, and cuDNN's LSTM backward needs it
        self.model = model.to(self.device).train()
        self.cfg = ppo_cfg
        self.envs = envs
        self.vo = vo_ensemble
        self.vo_fn = vo_fn
        # rollout steps advance the whitening buffers where the policy has them
        self.update_stats = any(isinstance(m, RunningMeanAndVar) for m in model.modules())
        if self.vo is not None and self.vo.device != self.device:
            raise ValueError(f"VO ensemble on {self.vo.device}, trainer on {self.device}")
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, trainer on {self.device}")
        self.generator = generator
        self.total_updates = total_updates

        self._last_obs = self._to_device(envs.reset())
        n = envs.num_envs
        if self.vo is not None or self.vo_fn is not None:
            # the policy's goal is dead-reckoned from here on, never the sensor
            self.goal_cart = geo.pointgoal_polar2cartesian(self._last_obs[GOAL_KEY])
        self._vo_feats = None  # the previous frame's VO features

        self.optimizer = make_optimizer(self.model.parameters(), ppo_cfg, total_updates)
        self.hidden = self.model.initial_hidden(n, device=self.device)
        self.prev_actions = torch.zeros((n, 1), dtype=torch.int64, device=self.device)
        self.masks = torch.zeros((n, 1), device=self.device)

        self.rollouts = RolloutStorage.create(
            ppo_cfg.num_steps, n, {k: tuple(v.shape[1:]) for k, v in self._last_obs.items()},
            self.model.num_packed_hidden, ppo_cfg.hidden_size, device=self.device)
        for k, v in self._last_obs.items():
            self.rollouts.observations[k][0].copy_(v)

        self.reward_window = deque(maxlen=ppo_cfg.reward_window_size)
        self.episode_reward = np.zeros(n)
        self.count_steps = 0
        self.update_idx = 0
        self.timing = {"env": 0.0, "act": 0.0, "vo": 0.0, "update": 0.0}

    def _to_device(self, obs: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.asarray(v)).to(self.device) for k, v in obs.items()}

    # -- rollout collection ----------------------------------------------------

    def _vo_update_goal(self, prev_obs, new_obs_np, new_obs, actions_np, reset, infos):
        """The VO-propagated goal in polar form ``[N, 2]`` after one step;
        ``reset`` ``[N, 1]`` is 1 where an episode just began."""
        t0 = time.perf_counter()
        if self.vo_fn is not None:
            delta = torch.as_tensor(self.vo_fn(prev_obs, new_obs_np, actions_np, infos),
                                    dtype=torch.float32, device=self.device)
        else:
            if self._vo_feats is None:  # the first frame's, once
                self._vo_feats = frame_features_packed(prev_obs["rgb"], prev_obs["depth"],
                                                       self.vo.cfg)
            if self.vo.cfg.mode == "det":
                delta, self._vo_feats = self.vo.predict_step_cached(
                    self._vo_feats, new_obs["rgb"], new_obs["depth"], actions_np)
            else:
                cur = frame_features_packed(new_obs["rgb"], new_obs["depth"], self.vo.cfg)
                delta, _std = self.vo.predict_rnd_packed(
                    torch.cat([self._vo_feats, cur], dim=-1), actions_np, self.generator)
                self._vo_feats = cur
        self.goal_cart, polar = propagate_goal(self.goal_cart, delta, reset, new_obs[GOAL_KEY])
        self.timing["vo"] += time.perf_counter() - t0
        return polar

    def collect_rollout(self) -> None:
        """``num_steps`` steps of every env into the rollout storage."""
        rollouts = self.rollouts
        for step in range(self.cfg.num_steps):
            t0 = time.perf_counter()
            value, action, logp, new_hidden = act_step(
                self.model, self._last_obs, self.hidden, self.prev_actions, self.masks,
                self.generator, update_stats=self.update_stats)
            actions_np = action[:, 0].cpu().numpy()  # the step's one read-back
            self.timing["act"] += time.perf_counter() - t0

            t0 = time.perf_counter()
            obs, rewards, dones, infos = self.envs.step(actions_np)
            self.timing["env"] += time.perf_counter() - t0

            self.episode_reward += rewards
            for i, d in enumerate(dones):
                if d:
                    self.reward_window.append(self.episode_reward[i])
                    self.episode_reward[i] = 0.0

            # every upload before the VO work is queued: a copy from pageable
            # host memory waits for the work queued ahead of it
            new_obs = self._to_device(obs)
            masks = torch.from_numpy(1.0 - dones.astype(np.float32))[:, None].to(self.device)
            rewards_t = torch.from_numpy(np.asarray(rewards, np.float32))[:, None].to(self.device)
            if self.vo is not None or self.vo_fn is not None:
                new_obs[GOAL_KEY] = self._vo_update_goal(self._last_obs, obs, new_obs,
                                                         actions_np, 1.0 - masks, infos)
            rollouts.insert_step(step, new_obs, new_hidden, action, logp, value, rewards_t,
                                 masks)
            self._last_obs = new_obs
            self.hidden = new_hidden
            self.prev_actions = action
            self.masks = masks
            self.count_steps += len(dones)

    def update_agent(self, order: Optional[torch.Tensor] = None) -> Dict[str, float]:
        """Returns, one PPO update (in ``order``, see ``ppo_update``, or an
        order drawn from the generator) and the roll to the next rollout.
        Neither the bootstrap act nor the update moves the whitening
        buffers."""
        t0 = time.perf_counter()
        next_value, _, _, _ = act_step(self.model, self._last_obs, self.hidden,
                                       self.prev_actions, self.masks)
        self.rollouts.compute_returns(next_value, self.cfg.use_gae, self.cfg.gamma,
                                      self.cfg.tau)
        clip = self.cfg.clip_param
        if self.cfg.use_linear_clip_decay and self.total_updates:
            clip = clip * max(0.0, 1.0 - self.update_idx / self.total_updates)
        stats = ppo_update(self.model, self.cfg, self.optimizer, self.rollouts, order=order,
                           generator=self.generator, clip_param=clip)
        stats = {k: float(v) for k, v in stats.items()}
        self.rollouts.after_update()
        self.timing["update"] += time.perf_counter() - t0
        self.update_idx += 1
        return stats

    # -- checkpoint state ------------------------------------------------------

    def checkpoint_state(self) -> Dict:
        """The resumable state in the reference's RL ``.pth`` container:
        ``state_dict`` (``actor_critic.`` keys), ``optimizer``, the
        generator's state, ``count_steps`` and ``update_idx``."""
        return {
            "state_dict": {POLICY_PREFIX + k: v for k, v in self.model.state_dict().items()},
            "optimizer": self.optimizer.state_dict(),
            "generator": generator_state(self.generator),
            "count_steps": self.count_steps,
            "update_idx": self.update_idx,
        }

    def load_checkpoint_state(self, state: Mapping, seed: int) -> None:
        """Restore :meth:`checkpoint_state` on any device type; a generator
        state saved on another type seeds the generator afresh from
        ``seed`` (``io.checkpoint.restore_generator``)."""
        self.model.load_state_dict(policy_state_dict_from_container(state), strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        restore_generator(self.generator, state["generator"], seed)
        self.count_steps = int(state["count_steps"])
        self.update_idx = int(state["update_idx"])

    def train(self, num_updates: int, log_fn=None):
        """``num_updates`` rounds of rollout and update; returns each
        update's stats with the mean episode reward of the window and the
        env steps so far."""
        history = []
        for _ in range(num_updates):
            self.collect_rollout()
            stats = self.update_agent()
            stats["mean_episode_reward"] = (
                float(np.mean(self.reward_window)) if self.reward_window else 0.0)
            stats["count_steps"] = self.count_steps
            history.append(stats)
            if log_fn:
                log_fn(self.update_idx, stats, dict(self.timing))
        return history
