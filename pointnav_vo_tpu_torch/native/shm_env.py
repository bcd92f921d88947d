"""Process-parallel vector env over the shared-memory rings (counterpart of
``native/shm_env.py``).

Each worker process steps one env and writes a fixed-layout float32
payload (observations, reward, done and the metrics) straight into shared
memory; the evaluator pops all N payloads into preallocated batch arrays:
one memcpy per env per step, no pickling.  :class:`ShmVectorEnv` has the
interface of ``rl/envs.py::VectorEnv``, so the trainer and the evaluator
run over either.

Workers are forked.  They step numpy only and never touch torch or CUDA,
so a farm created after the card is in use is sound: the child inherits
the parent's CUDA context without using it.  The env is pluggable as a
``"module:callable"`` spec resolved inside the worker (a simulator is
imported in its own process); the factory is ``f(cfg, seed, **kwargs)``
and returns an object with the scripted env's duck type: ``reset() ->
obs``, ``step(a) -> (obs, reward, done, info)`` with rgb, depth and
pointgoal observations.

The rings are unlinked from ``/dev/shm`` as soon as every worker has
attached, so no segment outlives the farm's processes.
"""

from __future__ import annotations

import importlib
import itertools
import multiprocessing as mp
import os
import secrets
from typing import Dict, List, Optional, Sequence

import numpy as np

from pointnav_vo_tpu_torch.native import ShmRing
from pointnav_vo_tpu_torch.rl.envs import EnvConfig

# pointgoal 2, reward, done, success, spl, softspl, distance_to_goal,
# collisions, gt_delta 3, agent_pos_episodic 3, agent_yaw, agent_pos 3,
# goal_world 3, episodes available (the worker env's number_of_episodes,
# -1 for unbounded), is_collision
_N_META = 24
_STARTUP_S = 600.0  # a habitat worker may load scenes for minutes
_STEP_S = 10.0  # one step of every worker
_POLL_MS = 1000  # a dead worker surfaces within this
_FARM_IDS = itertools.count()


def payload_floats(cfg: EnvConfig) -> int:
    return cfg.image_h * cfg.image_w * 4 + _N_META


def ring_bytes(cfg: EnvConfig, num_envs: int, slots: int) -> int:
    """Bytes of ring slots a farm backs in ``/dev/shm`` (headers aside)."""
    return num_envs * slots * (payload_floats(cfg) * 4 + 8)


def _encode(buf: np.ndarray, cfg: EnvConfig, obs, reward, done, info,
            n_eps: Optional[int] = None) -> None:
    hw = cfg.image_h * cfg.image_w
    buf[: hw * 3] = obs["rgb"].reshape(-1)
    buf[hw * 3: hw * 4] = obs["depth"].reshape(-1)
    m = buf[hw * 4:]
    m[0:2] = obs["pointgoal_with_gps_compass"]
    m[2] = reward
    m[3] = float(done)
    m[4] = info.get("success", 0.0)
    m[5] = info.get("spl", 0.0)
    m[6] = info.get("softspl", 0.0)
    m[7] = info.get("distance_to_goal", 0.0)
    m[8] = float(info.get("collisions", {"count": 0})["count"])
    m[9:12] = info.get("gt_delta", np.zeros(3, np.float32))
    m[12:15] = info.get("agent_pos_episodic", np.zeros(3, np.float32))
    m[15] = info.get("agent_yaw", 0.0)
    m[16:19] = info.get("agent_pos", np.zeros(3, np.float32))
    m[19:22] = info.get("goal_world", np.zeros(3, np.float32))
    m[22] = -1.0 if n_eps is None else float(n_eps)
    m[23] = float(info.get("collisions", {}).get("is_collision", 0))


def _decode(payload: np.ndarray, cfg: EnvConfig):
    """``(obs, rewards, dones, infos)`` of a ``[N, payload_floats]`` batch.
    The infos carry no ``episode_id``: the evaluator keys a worker's
    episodes by its own count."""
    n = payload.shape[0]
    hw = cfg.image_h * cfg.image_w
    m = payload[:, hw * 4:]
    obs = {
        "rgb": payload[:, : hw * 3].reshape(n, cfg.image_h, cfg.image_w, 3).copy(),
        "depth": payload[:, hw * 3: hw * 4].reshape(n, cfg.image_h, cfg.image_w, 1).copy(),
        "pointgoal_with_gps_compass": m[:, 0:2].copy(),
    }
    rewards = m[:, 2].copy()
    dones = m[:, 3] > 0.5
    infos = [
        {
            "success": float(m[i, 4]),
            "spl": float(m[i, 5]),
            "softspl": float(m[i, 6]),
            "distance_to_goal": float(m[i, 7]),
            "collisions": {"count": int(m[i, 8]), "is_collision": int(m[i, 23] > 0.5)},
            "gt_delta": m[i, 9:12].copy(),
            "agent_pos_episodic": m[i, 12:15].copy(),
            "agent_yaw": float(m[i, 15]),
            "agent_pos": m[i, 16:19].copy(),
            "goal_world": m[i, 19:22].copy(),
        }
        for i in range(n)
    ]
    return obs, rewards, dones, infos


def resolve_env_factory(spec: str):
    """The callable of a ``"module:callable"`` env-factory spec."""
    mod_name, _, attr = spec.partition(":")
    if not attr:
        raise ValueError(f"env factory spec must be 'module:callable', got {spec!r}")
    return getattr(importlib.import_module(mod_name), attr)


DEFAULT_ENV_FACTORY = "pointnav_vo_tpu_torch.rl.envs:ScriptedPointNavEnv"


def _worker_main(prefix: str, idx: int, cfg: EnvConfig, seed: int,
                 env_factory: str = DEFAULT_ENV_FACTORY,
                 factory_kwargs: Optional[dict] = None) -> None:
    act_ring = ShmRing(f"{prefix}_a{idx}")
    obs_ring = ShmRing(f"{prefix}_o{idx}")
    try:
        env = resolve_env_factory(env_factory)(cfg, seed=seed, **(factory_kwargs or {}))
        buf = np.zeros(payload_floats(cfg), np.float32)
        act = np.zeros(1, np.float32)
        n_eps = getattr(env, "number_of_episodes", None)
        _encode(buf, cfg, env.reset(), 0.0, False, {}, n_eps)
        obs_ring.push(buf)
        while True:
            act_ring.pop_into(act, timeout_ms=600000)
            a = int(act[0])
            if a < 0:
                break
            obs, reward, done, info = env.step(a)
            if done:
                obs = env.reset()
            _encode(buf, cfg, obs, reward, done, info, n_eps)
            obs_ring.push(buf)
    finally:
        act_ring.close()
        obs_ring.close()


class ShmVectorEnv:
    """VectorEnv over forked process workers and shared-memory rings;
    ``slots`` payloads of each worker can wait in its ring.  A failed
    build, a ring that cannot be created or a dead worker raises; the farm
    never falls back to in-process envs."""

    def __init__(self, cfg: EnvConfig, num_envs: int, seed: int = 0, slots: int = 4,
                 env_factory: str = DEFAULT_ENV_FACTORY,
                 factory_kwargs=None):
        # fail here on a bad spec, not silently in every worker
        resolve_env_factory(env_factory)
        if isinstance(factory_kwargs, (list, tuple)):
            if len(factory_kwargs) != num_envs:
                raise ValueError(f"{len(factory_kwargs)} factory kwargs for {num_envs} workers")
            per_kwargs = list(factory_kwargs)
        else:
            per_kwargs = [factory_kwargs] * num_envs
        self.cfg = cfg
        self.num_envs = num_envs
        # unique in the process and across processes: rb_create refuses a name in use
        self._prefix = f"/pnvo_{os.getpid()}_{next(_FARM_IDS)}_{secrets.token_hex(4)}"
        n_floats = payload_floats(cfg)
        self._payload = np.zeros((num_envs, n_floats), np.float32)
        self._act = np.zeros(1, np.float32)
        self._act_rings: List[ShmRing] = []
        self._obs_rings: List[ShmRing] = []
        self._procs: list = []
        try:
            for i in range(num_envs):
                self._act_rings.append(ShmRing(f"{self._prefix}_a{i}", slots, 8, create=True))
                self._obs_rings.append(
                    ShmRing(f"{self._prefix}_o{i}", slots, n_floats * 4, create=True))
            ctx = mp.get_context("fork")
            self._procs = [
                ctx.Process(target=_worker_main,
                            args=(self._prefix, i, cfg, seed + i, env_factory, per_kwargs[i]),
                            daemon=True)
                for i in range(num_envs)]
            for p in self._procs:
                p.start()
        except BaseException:
            self.close()
            raise
        self._first = True
        self._reset_called = False
        # the workers auto-reset: a done transition starts a worker's next episode
        self._episode_ids = [0] * num_envs

    def current_episodes(self) -> List[int]:
        return list(self._episode_ids)

    def number_of_episodes(self) -> List[Optional[int]]:
        """Each worker env's ``number_of_episodes`` (None: unbounded), read
        from its first payload; asked before ``reset()``, the payload is
        popped here and ``reset()`` decodes it later."""
        self._pop_first_payload()
        vals = self._payload[:, self.cfg.image_h * self.cfg.image_w * 4 + 22]
        return [None if v < 0 else int(v) for v in vals]

    def _pop_all(self, limit_s: float) -> None:
        """Pop one payload of every worker into ``self._payload``, waiting
        up to ``limit_s`` for each; the wait polls the worker's liveness, so
        a dead worker raises within ``_POLL_MS``."""
        for i, ring in enumerate(self._obs_rings):
            waited = 0.0
            while True:
                try:
                    ring.pop_into(self._payload[i], timeout_ms=_POLL_MS)
                    break
                except TimeoutError as e:
                    waited += _POLL_MS / 1000
                    if waited >= limit_s or not self._procs[i].is_alive():
                        self._check_workers(e)

    def _pop_first_payload(self) -> None:
        """Collect each worker's startup payload (scene loads may take
        minutes).  Idempotent."""
        if not self._first:
            return
        self._pop_all(_STARTUP_S)
        self._first = False
        # every worker has attached both rings: their names can go now
        for ring in self._act_rings + self._obs_rings:
            ring.unlink()

    def reset(self) -> Dict[str, np.ndarray]:
        """The workers' first observations; the workers auto-reset, so a
        farm is reset once."""
        if self._reset_called:
            raise RuntimeError("shm workers auto-reset; call reset() once")
        self._pop_first_payload()
        self._reset_called = True
        return _decode(self._payload, self.cfg)[0]

    def _check_workers(self, cause: Exception) -> None:
        """Turn a ring timeout into a report of the dead workers; re-raise
        it where none died."""
        dead = [(i, p.exitcode) for i, p in enumerate(self._procs) if not p.is_alive()]
        if dead:
            raise RuntimeError(
                f"shm env worker(s) died: {dead} (index, exitcode); see the worker's "
                "stderr (a habitat worker typically dies on a scene-load error or a "
                "missing dataset)") from cause
        raise cause

    def step_async(self, actions: Sequence[int]) -> None:
        """Push the actions and return at once: the workers simulate while
        the caller works.  One outstanding step at most; ``step_wait``
        collects it.  A step pushed and never collected is harmless: its
        payload waits in a ring slot and ``close()`` still proceeds."""
        for ring, a in zip(self._act_rings, actions):
            self._act[0] = float(a)
            ring.push(self._act)

    def step_wait(self):
        self._pop_all(_STEP_S)
        out = _decode(self._payload, self.cfg)
        for i, done in enumerate(out[2]):
            if done:
                self._episode_ids[i] += 1
        return out

    def step(self, actions: Sequence[int]):
        self.step_async(actions)
        return self.step_wait()

    def close(self) -> None:
        """Stop every worker (a stop message, then terminate after 5 s) and
        release the rings."""
        for ring in self._act_rings:
            try:
                self._act[0] = -1.0
                ring.push(self._act, timeout_ms=1000)
            except TimeoutError:
                pass  # a full ring: its worker is stuck or dead, terminated below
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        for ring in self._act_rings + self._obs_rings:
            ring.close()
        self._procs, self._act_rings, self._obs_rings = [], [], []
