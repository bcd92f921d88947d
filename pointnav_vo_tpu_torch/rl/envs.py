"""Scripted PointNav environments, host numpy (the port's own copy of the
scripted world of ``rl/envs.py``; the habitat and shared-memory backends
are not ported yet).

- :class:`ScriptedPointNavEnv`: a habitat-free PointNav world.  The agent
  lives in a circular room with textured walls; depth is closed-form ray
  casting, RGB a wall-angle-keyed stripe texture.  0.25 m forward steps,
  30 deg turns, optional Gaussian actuation, RGB and depth noise.  Each
  step reports the navigation metrics and the ground-truth local delta.
- :class:`VectorEnv`: synchronous fan-out over N envs with batched numpy
  observations and auto-reset on done.

Reward: ``SLACK + (prev_dist - cur_dist) + SUCCESS_REWARD * success``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pointnav_vo_tpu_torch.common import MOVE_FORWARD, STOP, TURN_LEFT, TURN_RIGHT


@dataclasses.dataclass
class EnvConfig:
    image_h: int = 192
    image_w: int = 341
    hfov_deg: float = 70.0
    min_depth: float = 0.1
    max_depth: float = 10.0
    forward_step: float = 0.25
    turn_angle_deg: float = 30.0
    max_episode_steps: int = 500
    success_distance: float = 0.36
    slack_reward: float = -0.01
    success_reward: float = 2.5
    # noise (0 disables)
    actuation_noise_multiplier: float = 0.5
    rgb_noise_intensity: float = 0.1
    depth_noise_multiplier: float = 1.0
    room_radius_range: Tuple[float, float] = (3.0, 8.0)


def _polar_goal(agent_pos, agent_yaw, goal_pos) -> np.ndarray:
    """Habitat pointgoal_with_gps_compass encoding [rho, -phi].

    World frame: (x, z) with the agent facing -z at yaw 0; yaw rotates about
    +y.  local = R_y(-yaw) @ [dx, 0, dz]; phi = atan2(local_x, -local_z).
    """
    rel = goal_pos - agent_pos
    ca, sa = np.cos(-agent_yaw), np.sin(-agent_yaw)
    local_x = ca * rel[0] + sa * rel[1]
    local_z = -sa * rel[0] + ca * rel[1]
    rho = float(np.hypot(local_x, local_z))
    phi = float(np.arctan2(local_x, -local_z))
    return np.asarray([rho, -phi], np.float32)


class ScriptedPointNavEnv:
    """Single scripted PointNav episode generator."""

    def __init__(self, cfg: EnvConfig, seed: int = 0):
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self._episode_id = -1
        self._col_angles = None
        self.reset()

    def _ray_depth(self) -> np.ndarray:
        """Per image column, the distance along the ray to the wall |p + t d| = R."""
        cfg = self.cfg
        if self._col_angles is None:
            half = np.radians(cfg.hfov_deg) / 2.0
            f = (cfg.image_w / 2.0) / np.tan(half)
            u = np.arange(cfg.image_w) + 0.5 - cfg.image_w / 2.0
            self._col_angles = np.arctan2(u, f)
        ang = self.yaw + self._col_angles  # world heading per column
        d = np.stack([-np.sin(ang), -np.cos(ang)], -1)  # forward = -z at yaw 0
        p = self.pos
        b = 2 * (d @ p)
        c = p @ p - self.room_radius ** 2
        disc = np.maximum(b * b - 4 * c, 0.0)
        t = (-b + np.sqrt(disc)) / 2.0
        return np.maximum(t, cfg.min_depth)

    def _render(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        t = self._ray_depth()  # [W]
        # vertical foreshortening: rows away from the horizon see floor/ceiling
        rows = (np.arange(cfg.image_h) + 0.5) / cfg.image_h - 0.5
        vert = 1.0 / (1.0 + 2.0 * np.abs(rows))
        depth = t[None, :] * vert[:, None]
        if cfg.depth_noise_multiplier > 0:
            noise = self.rng.normal(0, 0.01, size=depth.shape) * (
                depth * cfg.depth_noise_multiplier)
            depth = depth + noise
        depth_n = np.clip(
            (depth - cfg.min_depth) / (cfg.max_depth - cfg.min_depth), 0.0, 1.0
        ).astype(np.float32)[..., None]

        ang = self.yaw + self._col_angles
        wall_phase = (np.sin(self._texture_freq * ang + self._texture_phase) + 1) / 2
        col = np.stack(
            [
                wall_phase,
                (np.sin(2.3 * self._texture_freq * ang) + 1) / 2,
                np.clip(t / cfg.max_depth, 0, 1),
            ],
            -1,
        )  # [W, 3]
        rgb = np.broadcast_to(col[None], (cfg.image_h, cfg.image_w, 3)).copy()
        rgb *= (0.4 + 0.6 * vert[:, None, None])
        rgb = rgb * 255.0
        if cfg.rgb_noise_intensity > 0:
            rgb = rgb + self.rng.normal(0, cfg.rgb_noise_intensity * 255.0 * 0.1,
                                        size=rgb.shape)
        return {"rgb": np.clip(rgb, 0, 255).astype(np.float32), "depth": depth_n}

    def reset(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        self._episode_id += 1
        lo, hi = cfg.room_radius_range
        self.room_radius = float(self.rng.uniform(lo, hi))
        self._texture_freq = float(self.rng.uniform(3, 9))
        self._texture_phase = float(self.rng.uniform(0, 2 * np.pi))
        r_max = self.room_radius - 0.5
        self.pos = self.rng.uniform(-r_max / 2, r_max / 2, size=2)
        self.yaw = float(self.rng.uniform(-np.pi, np.pi))
        while True:
            goal = self.rng.uniform(-r_max, r_max, size=2)
            if (np.linalg.norm(goal) < r_max
                    and 1.0 < np.linalg.norm(goal - self.pos) < 2 * r_max):
                break
        self.goal = goal
        self.start_pos = self.pos.copy()
        self.start_yaw = self.yaw
        self.start_dist = float(np.linalg.norm(self.goal - self.pos))
        self.path_len = 0.0
        self.steps = 0
        self.collisions = 0
        self.called_stop = False
        self._prev_dist = self.start_dist
        obs = self._render()
        obs["pointgoal_with_gps_compass"] = _polar_goal(self.pos, self.yaw, self.goal)
        return obs

    @property
    def dist_to_goal(self) -> float:
        return float(np.linalg.norm(self.goal - self.pos))

    def global_pose(self) -> Tuple[np.ndarray, np.ndarray]:
        """(position ``[x, y, z]``, rotation quaternion ``[x, y, z, w]``) in
        the world frame."""
        pos = np.asarray([self.pos[0], 0.0, self.pos[1]], np.float64)
        half = self.yaw / 2.0
        return pos, np.asarray([0.0, np.sin(half), 0.0, np.cos(half)], np.float64)

    def goal_position(self) -> np.ndarray:
        return np.asarray([self.goal[0], 0.0, self.goal[1]], np.float32)

    @property
    def episode_over(self) -> bool:
        return self.steps >= self.cfg.max_episode_steps or self.called_stop

    def _apply_action(self, action: int) -> Tuple[float, float, float]:
        """Returns the GT local delta [dx, dz, dyaw] actually executed."""
        cfg = self.cfg
        m = cfg.actuation_noise_multiplier
        if action == MOVE_FORWARD:
            dx = self.rng.normal(0, 0.01) * m
            dz = -cfg.forward_step + self.rng.normal(0, 0.02) * m
            dyaw = self.rng.normal(0, np.radians(1.0)) * m
        elif action == TURN_LEFT:
            dx = self.rng.normal(0, 0.005) * m
            dz = self.rng.normal(0, 0.005) * m
            dyaw = np.radians(cfg.turn_angle_deg) + self.rng.normal(0, np.radians(1.5)) * m
        elif action == TURN_RIGHT:
            dx = self.rng.normal(0, 0.005) * m
            dz = self.rng.normal(0, 0.005) * m
            dyaw = -np.radians(cfg.turn_angle_deg) + self.rng.normal(0, np.radians(1.5)) * m
        else:
            return (0.0, 0.0, 0.0)

        # integrate in world frame: local [dx, 0, dz] rotated by yaw about +y
        ca, sa = np.cos(self.yaw), np.sin(self.yaw)
        wx = ca * dx + sa * dz
        wz = -sa * dx + ca * dz
        new_pos = self.pos + np.asarray([wx, wz])
        # wall collision: stop short (no sliding)
        if np.linalg.norm(new_pos) > self.room_radius - 0.2:
            self.collisions += 1
            new_pos = self.pos
            dx, dz = 0.0, 0.0
        self.path_len += float(np.linalg.norm(new_pos - self.pos))
        self.pos = new_pos
        # yaw stays unwrapped, so per-step delta quaternions never pick up a
        # 2*pi ghost when the global rotation crosses +-pi
        self.yaw = float(self.yaw + dyaw)
        return (dx, dz, dyaw)

    def step(self, action: int):
        if self.episode_over:
            raise RuntimeError("step() called on a finished episode")
        self.steps += 1
        pre_collisions = self.collisions
        if action == STOP:
            self.called_stop = True
            delta = (0.0, 0.0, 0.0)
        else:
            delta = self._apply_action(int(action))
        is_collision = int(self.collisions > pre_collisions)

        cur_dist = self.dist_to_goal
        success = float(self.called_stop and cur_dist < self.cfg.success_distance)
        reward = self.cfg.slack_reward + (self._prev_dist - cur_dist)
        reward += self.cfg.success_reward * success
        self._prev_dist = cur_dist

        done = self.episode_over or success > 0
        obs = self._render()
        obs["pointgoal_with_gps_compass"] = _polar_goal(self.pos, self.yaw, self.goal)

        spl = success * self.start_dist / max(self.path_len, self.start_dist)
        soft_success = max(0.0, 1.0 - cur_dist / max(self.start_dist, 1e-6))
        softspl = soft_success * self.start_dist / max(self.path_len, self.start_dist)
        # episodic pose: position in the episode-start frame (what VO
        # dead-reckoning from identity estimates)
        ca, sa = np.cos(-self.start_yaw), np.sin(-self.start_yaw)
        rel = self.pos - self.start_pos
        ep_x = ca * rel[0] + sa * rel[1]
        ep_z = -sa * rel[0] + ca * rel[1]
        info = {
            "distance_to_goal": cur_dist,
            "success": success,
            "spl": spl,
            "softspl": softspl,
            # is_collision: THIS step hit a wall; on a blocked move the GT
            # translation is exactly 0.0 (above)
            "collisions": {"count": self.collisions, "is_collision": is_collision},
            "gt_delta": np.asarray(delta, np.float32),
            "agent_pos": np.asarray([self.pos[0], 0.0, self.pos[1]], np.float32),
            "agent_pos_episodic": np.asarray([ep_x, 0.0, ep_z], np.float32),
            "agent_yaw": self.yaw,
            "episode_id": self._episode_id,
        }
        return obs, float(reward), bool(done), info


class VectorEnv:
    """Synchronous fan-out with batched numpy observations; an env that
    finishes is reset at once and its reset observation is returned."""

    def __init__(self, make_fns: Sequence):
        self.envs: List = [fn() for fn in make_fns]
        self.num_envs = len(self.envs)

    def reset(self) -> Dict[str, np.ndarray]:
        return _batch_obs([e.reset() for e in self.envs])

    def step(self, actions: Sequence[int]):
        obs, rewards, dones, infos = [], [], [], []
        for env, act in zip(self.envs, actions):
            o, r, d, i = env.step(int(act))
            if d:
                o = env.reset()
            obs.append(o)
            rewards.append(r)
            dones.append(d)
            infos.append(i)
        return (_batch_obs(obs), np.asarray(rewards, np.float32),
                np.asarray(dones, bool), infos)

    def number_of_episodes(self) -> List[Optional[int]]:
        """Per-env episode counts; ``None`` marks an unbounded generator."""
        return [getattr(e, "number_of_episodes", None) for e in self.envs]


def _batch_obs(obs_list: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack a list of obs dicts into batched arrays."""
    return {k: np.stack([o[k] for o in obs_list]) for k in obs_list[0]}


def make_scripted_vector_env(cfg: EnvConfig, num_envs: int, seed: int = 0) -> VectorEnv:
    return VectorEnv([(lambda s=seed + i: ScriptedPointNavEnv(cfg, seed=s))
                      for i in range(num_envs)])
