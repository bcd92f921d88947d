"""PointNav environments, host numpy (counterpart of ``rl/envs.py``).

- :class:`ScriptedPointNavEnv`: a habitat-free PointNav world.  The agent
  lives in a circular room with textured walls; depth is closed-form ray
  casting, RGB a wall-angle-keyed stripe texture.  0.25 m forward steps,
  30 deg turns, optional Gaussian actuation, RGB and depth noise.  Each
  step reports the navigation metrics and the ground-truth local delta.
- :class:`VectorEnv`: synchronous fan-out over N envs with batched numpy
  observations and auto-reset on done.  ``native/shm_env.py::ShmVectorEnv``
  is the same interface over process workers.
- :class:`HabitatNavEnv` and :func:`make_habitat_vector_env`: a habitat
  simulator behind the scripted env's interface (``habitat`` is imported
  inside them: habitat-sim is a separate CPU-side install).

Reward: ``SLACK + (prev_dist - cur_dist) + SUCCESS_REWARD * success``.
"""

from __future__ import annotations

import dataclasses
import logging
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pointnav_vo_tpu_torch.common import (
    MOVE_FORWARD,
    STOP,
    TURN_LEFT,
    TURN_RIGHT,
    quat_canonical,
    quat_inverse,
    quat_multiply,
    quat_rotate,
)


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
    seed: int = 0


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
        self._base_seed = seed
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

    def reset_to_episode(self, episode_id: int) -> Dict[str, np.ndarray]:
        """Replay episode ``episode_id``: episodes are a pure function of
        (seed, episode index)."""
        self.rng = np.random.default_rng(self._base_seed)
        self._episode_id = -1
        obs = self.reset()
        while self._episode_id < episode_id:
            obs = self.reset()
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
            "goal_world": self.goal_position(),
            "episode_id": self._episode_id,
        }
        return obs, float(reward), bool(done), info


class VectorEnv:
    """Synchronous fan-out with batched numpy observations; an env that
    finishes is reset at once and its reset observation is returned."""

    def __init__(self, make_fns: Sequence):
        self.envs: List = [fn() for fn in make_fns]
        self.num_envs = len(self.envs)
        self._paused: List[Tuple[int, object]] = []
        self._pending_actions = None

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

    def step_async(self, actions: Sequence[int]) -> None:
        """The interface of ``ShmVectorEnv``'s split step.  In-process envs
        have no worker to hand the step to: the actions are kept and the
        step runs in ``step_wait``, inside the caller's env clock."""
        self._pending_actions = list(actions)

    def step_wait(self):
        actions, self._pending_actions = self._pending_actions, None
        return self.step(actions)

    def current_episodes(self) -> List[int]:
        return [getattr(e, "_episode_id", 0) for e in self.envs]

    def number_of_episodes(self) -> List[Optional[int]]:
        """Per-env episode counts; ``None`` marks an unbounded generator."""
        return [getattr(e, "number_of_episodes", None) for e in self.envs]

    def pause_at(self, idx: int) -> None:
        """Take env ``idx`` out of stepping, habitat's ``VectorEnv``
        semantics: later envs shift down one index; :meth:`resume_all`
        restores the order.  (The evaluator masks finished envs instead.)"""
        self._paused.append((idx, self.envs.pop(idx)))
        self.num_envs -= 1

    def resume_all(self) -> None:
        """Put every paused env back at its own index."""
        for idx, env in reversed(self._paused):
            self.envs.insert(idx, env)
        self._paused = []
        self.num_envs = len(self.envs)

    def close(self) -> None:
        """Resume the paused envs, then close every env that can be closed
        (a simulator holds its scene assets; scripted envs hold nothing)."""
        self.resume_all()
        for e in self.envs:
            fn = getattr(e, "close", None)
            if callable(fn):
                fn()


def _batch_obs(obs_list: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack a list of obs dicts into batched arrays."""
    return {k: np.stack([o[k] for o in obs_list]) for k in obs_list[0]}


def make_scripted_vector_env(cfg: EnvConfig, num_envs: int, seed: int = 0) -> VectorEnv:
    return VectorEnv([(lambda s=seed + i: ScriptedPointNavEnv(cfg, seed=s))
                      for i in range(num_envs)])


def split_scenes(scenes: Sequence[str], n_workers: int) -> List[List[str]]:
    """Round-robin split of the scenes over the simulator workers."""
    if n_workers <= 0:
        raise ValueError(f"n_workers must be positive, got {n_workers}")
    if len(scenes) == 0:
        return [[] for _ in range(n_workers)]
    if len(scenes) < n_workers:
        raise ValueError(f"reduce workers: {n_workers} workers but only {len(scenes)} scenes")
    out: List[List[str]] = [[] for _ in range(n_workers)]
    for i, s in enumerate(scenes):
        out[i % n_workers].append(s)
    return out


def env_config_from_task(config, noisy: bool = True, seed: int = 0) -> EnvConfig:
    """The EnvConfig of an experiment config tree (the task keys the
    reference forwards into each env worker)."""
    task = config.TASK_CONFIG
    sim = task.SIMULATOR
    return EnvConfig(
        image_h=sim.DEPTH_SENSOR.HEIGHT,
        image_w=sim.DEPTH_SENSOR.WIDTH,
        hfov_deg=sim.DEPTH_SENSOR.HFOV,
        min_depth=sim.DEPTH_SENSOR.MIN_DEPTH,
        max_depth=sim.DEPTH_SENSOR.MAX_DEPTH,
        forward_step=sim.get("FORWARD_STEP_SIZE", 0.25),
        turn_angle_deg=sim.TURN_ANGLE,
        max_episode_steps=task.ENVIRONMENT.MAX_EPISODE_STEPS,
        success_distance=task.TASK.SUCCESS_DISTANCE,
        slack_reward=config.RL.SLACK_REWARD,
        success_reward=config.RL.SUCCESS_REWARD,
        actuation_noise_multiplier=(sim.NOISE_MODEL.NOISE_MULTIPLIER if noisy else 0.0),
        rgb_noise_intensity=(
            sim.RGB_SENSOR.NOISE_MODEL_KWARGS.intensity_constant if noisy else 0.0),
        depth_noise_multiplier=1.0 if noisy else 0.0,
        seed=seed,
    )


# -- the habitat backend --------------------------------------------------------


def _as_xyzw(rotation) -> np.ndarray:
    """habitat's ``np.quaternion`` (w, x, y, z attributes) or an ``[x, y, z,
    w]`` array, as an ``[x, y, z, w]`` float64 array."""
    if hasattr(rotation, "w"):
        return np.asarray([rotation.x, rotation.y, rotation.z, rotation.w], np.float64)
    return np.asarray(rotation, np.float64)


def agent_state_delta(prev_pos, prev_rot, cur_pos, cur_rot) -> np.ndarray:
    """Local ``[dx, dz, dyaw]`` of the current pose in the previous pose's
    frame: ``dpos = R(prev)^-1 (cur - prev)``, ``dyaw = 2 atan2(qy, qw)`` of
    the canonical delta quaternion (no 2 pi ghost)."""
    q_prev = _as_xyzw(prev_rot)
    q_cur = _as_xyzw(cur_rot)
    dpos = quat_rotate(quat_inverse(q_prev),
                       np.asarray(cur_pos, np.float64) - np.asarray(prev_pos, np.float64))
    dq = quat_canonical(quat_multiply(quat_inverse(q_prev), q_cur))
    dyaw = 2.0 * np.arctan2(dq[1], dq[3])
    return np.asarray([dpos[0], dpos[2], dyaw], np.float32)


# leaves whose silent loss would make a Challenge-2020 run noise-free (the
# LoCoBot actuation noise, the Redwood depth noise, the Gaussian rgb noise)
NOISE_CRITICAL_KEYS = (
    "SIMULATOR.NOISE_MODEL.NOISE_MULTIPLIER",
    "SIMULATOR.RGB_SENSOR.NOISE_MODEL",
    "SIMULATOR.RGB_SENSOR.NOISE_MODEL_KWARGS.intensity_constant",
    "SIMULATOR.DEPTH_SENSOR.NOISE_MODEL",
    "SIMULATOR.ACTION_SPACE_CONFIG",
)


def _leaves(node: dict, prefix: str) -> List[str]:
    """The dotted paths of every leaf under a nested dict."""
    out = []
    for k, v in node.items():
        out.extend(_leaves(v, prefix + k + ".") if isinstance(v, dict) else [prefix + k])
    return out


def _overlay_config(dst, src: dict, _path: str = "") -> List[str]:
    """Copy the keys of ``src`` onto a yacs-style config node, recursing
    into existing nodes.  Returns the dotted paths of the leaves the target
    rejected (every leaf under a rejected subtree), so a caller can refuse
    to run without :data:`NOISE_CRITICAL_KEYS`."""
    dropped: List[str] = []
    for k, v in src.items():
        if isinstance(v, dict) and hasattr(dst, k) and not isinstance(
                getattr(dst, k), (int, float, str, bool, list, tuple, type(None))):
            dropped.extend(_overlay_config(getattr(dst, k), v, _path + k + "."))
            continue
        try:
            setattr(dst, k, list(v) if isinstance(v, tuple) else v)
        except Exception:  # the config class's own refusal, whatever its type
            dropped.extend(_leaves(v, _path + k + ".") if isinstance(v, dict)
                           else [_path + k])
    return dropped


class HabitatNavEnv:
    """One habitat PointNav env behind the scripted env's interface: the
    reward shaping of the reference's ``NavRLEnv`` and the ground-truth
    local delta and episodic pose from the simulator's agent states
    (:func:`agent_state_delta`), so the evaluator's VO error and drift work
    alike over both worlds.

    The habitat API it uses: ``habitat.get_config``, ``habitat.make_dataset``,
    ``habitat.Env`` and its ``seed``/``reset``/``step``/``episode_over``/
    ``get_metrics``/``current_episode``/``sim.get_agent_state``."""

    def __init__(self, cfg: EnvConfig, seed: int = 0, task_config: Optional[dict] = None,
                 content_scenes: Optional[List[str]] = None,
                 reward_measure: str = "distance_to_goal",
                 success_measure: str = "success"):
        import habitat

        self.cfg = cfg
        self._reward_measure = reward_measure
        self._success_measure = success_measure
        hab_cfg = habitat.get_config()
        if hasattr(hab_cfg, "defrost"):
            hab_cfg.defrost()
        if task_config:
            dropped = _overlay_config(hab_cfg, task_config)
            if dropped:
                logging.getLogger(__name__).warning(
                    "habitat config rejected %d overlay key(s): %s",
                    len(dropped), ", ".join(sorted(dropped)))
                bad = sorted(set(dropped) & set(NOISE_CRITICAL_KEYS))
                if bad:
                    raise ValueError(
                        f"habitat config rejected noise-critical keys {bad}: the "
                        "Challenge-2020 noise settings would not take effect and the "
                        "run would evaluate noise-free")
        hab_cfg.SEED = seed
        if content_scenes is not None:
            hab_cfg.DATASET.CONTENT_SCENES = list(content_scenes)
        if hasattr(hab_cfg, "freeze"):
            hab_cfg.freeze()
        dataset = habitat.make_dataset(hab_cfg.DATASET.TYPE, config=hab_cfg.DATASET)
        self._env = habitat.Env(config=hab_cfg, dataset=dataset)
        self._env.seed(seed)
        self._episode_id = -1
        # a finite episode count budgets the exact-set eval
        eps = getattr(dataset, "episodes", None)
        self.number_of_episodes = len(eps) if eps is not None else None

    def _agent_state(self):
        sim = getattr(self._env, "sim", None) or getattr(self._env, "_sim")
        return sim.get_agent_state()

    def global_pose(self) -> Tuple[np.ndarray, np.ndarray]:
        """(position ``[x, y, z]``, rotation quaternion ``[x, y, z, w]``)."""
        s = self._agent_state()
        return np.asarray(s.position, np.float64), _as_xyzw(s.rotation)

    def goal_position(self) -> np.ndarray:
        return np.asarray(self._env.current_episode.goals[0].position, np.float32)

    @property
    def dist_to_goal(self) -> float:
        return float(self._env.get_metrics().get("distance_to_goal", np.inf))

    @staticmethod
    def _convert_obs(obs) -> Dict[str, np.ndarray]:
        out = {k: np.asarray(obs[k], np.float32) for k in ("rgb", "depth") if k in obs}
        out["pointgoal_with_gps_compass"] = np.asarray(obs["pointgoal_with_gps_compass"],
                                                       np.float32)
        return out

    def reset(self) -> Dict[str, np.ndarray]:
        self._episode_id += 1
        obs = self._env.reset()
        self._prev_measure = float(self._env.get_metrics()[self._reward_measure])
        self._prev_state = self._start_state = self.global_pose()
        return self._convert_obs(obs)

    def step(self, action: int):
        obs = self._env.step(int(action))
        metrics = self._env.get_metrics()
        success = float(metrics[self._success_measure])
        cur_measure = float(metrics[self._reward_measure])
        reward = self.cfg.slack_reward + (self._prev_measure - cur_measure)
        reward += self.cfg.success_reward * success
        self._prev_measure = cur_measure
        done = bool(self._env.episode_over or success > 0)

        cur_state = self.global_pose()
        gt_delta = agent_state_delta(*self._prev_state, *cur_state)
        # the current position in the episode-start frame
        dstart = quat_rotate(quat_inverse(self._start_state[1]),
                             cur_state[0] - self._start_state[0])
        self._prev_state = cur_state
        collisions = metrics.get("collisions") or {"count": 0}
        info = {
            "distance_to_goal": float(metrics.get("distance_to_goal", 0.0)),
            "success": success,
            "spl": float(metrics.get("spl", 0.0)),
            "softspl": float(metrics.get("softspl", 0.0)),
            # is_collision: this step collided (the stuck counters read it)
            "collisions": {"count": int(collisions["count"]),
                           "is_collision": int(collisions.get("is_collision", 0))},
            "gt_delta": gt_delta,
            "agent_pos": np.asarray(cur_state[0], np.float32),
            "agent_pos_episodic": np.asarray(dstart, np.float32),
            "agent_yaw": float(2.0 * np.arctan2(cur_state[1][1], cur_state[1][3])),
            "goal_world": self.goal_position(),
            "episode_id": self._episode_id,
            # the dataset-level identity of the episode just stepped: the
            # exact-set eval keys its counted episodes by it
            "episode_key": self._episode_key(),
        }
        return self._convert_obs(obs), float(reward), done, info

    def _episode_key(self):
        ep = getattr(self._env, "current_episode", None)
        if ep is None:
            return None
        return (str(getattr(ep, "scene_id", "")),
                str(getattr(ep, "episode_id", self._episode_id)))


def make_habitat_vector_env(config, num_envs: int, seed: int = 0, noisy: bool = True,
                            backend: str = "shm", block: slice = slice(None)):
    """Habitat-backed vector env (the reference's ``construct_envs``): the
    scenes found through ``make_dataset``, shuffled by ``seed``, split round
    robin over the workers, worker i seeded ``seed + i``; over shm process
    workers (each imports habitat-sim in its own process) or, with
    ``backend="sync"``, an in-process loop.  ``block`` builds only those
    of the ``num_envs`` workers (a data-parallel rank's)."""
    try:
        import habitat
    except ImportError as e:
        raise ImportError(
            "habitat-lab is not installed; use the scripted backends (ENV_BACKEND "
            "sync | shm)") from e

    task = config.TASK_CONFIG
    scenes = list(task.DATASET.get("CONTENT_SCENES", ["*"]))
    if "*" in scenes:
        scenes = list(habitat.make_dataset(task.DATASET.TYPE).get_scenes_to_load(task.DATASET))
    if num_envs > 1:
        if not scenes:
            raise RuntimeError("no scenes to load; the multi-process split needs scenes")
        random.Random(seed).shuffle(scenes)
    splits = split_scenes(scenes, num_envs) if scenes else [None] * num_envs

    env_cfg = env_config_from_task(config, noisy=noisy, seed=seed)
    task_dict = task.to_dict() if hasattr(task, "to_dict") else dict(task)
    per_kwargs = [{"task_config": task_dict, "content_scenes": splits[i],
                   "reward_measure": config.RL.get("REWARD_MEASURE", "distance_to_goal"),
                   "success_measure": config.RL.get("SUCCESS_MEASURE", "success")}
                  for i in range(num_envs)]
    workers = range(num_envs)[block]
    if backend == "shm":
        from pointnav_vo_tpu_torch.native.shm_env import ShmVectorEnv

        return ShmVectorEnv(env_cfg, len(workers), seed=seed + workers.start,
                            env_factory="pointnav_vo_tpu_torch.rl.envs:HabitatNavEnv",
                            factory_kwargs=[per_kwargs[i] for i in workers])
    if backend != "sync":
        raise ValueError(f"unknown habitat backend {backend!r} (shm | sync)")
    return VectorEnv([(lambda i=i: HabitatNavEnv(env_cfg, seed=seed + i, **per_kwargs[i]))
                      for i in workers])
