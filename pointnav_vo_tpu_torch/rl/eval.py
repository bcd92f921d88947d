"""Policy + VO evaluation (counterpart of ``rl/eval.py``).

Each step of :meth:`Evaluator.run` steps the envs on the host, then runs
:func:`fused_vo_act_step` on the device for all envs at once: features of
the new frame (the previous frame's are cached), each sample's own VO
expert, goal dead-reckoning, the next policy act and the drift pose.  One
packed read brings back what the host bookkeeping needs.

Tracked diagnostics follow the reference's accounting: navigation metrics
on episode end, per-step VO L2 error against the env's ground-truth delta,
dead-reckoned drift against the true episodic pose, and the collision-gated
stuck counters.  The VO ensemble runs in det or rnd mode (rnd: the mean
and std over dropout passes, the std reported as ``vo_pred_std_mean``);
the policy acts by its mode or, with ``deterministic=False``, samples.
Both draw from one ``torch.Generator`` on the device.  Video, ranked error
images, tensorboard and the unfused / multi-device paths are not ported
yet.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from pointnav_vo_tpu_torch.common import MOVE_FORWARD, resolve_device
from pointnav_vo_tpu_torch.models.policy import action_log_prob, mode_action, sample_action
from pointnav_vo_tpu_torch.ops import geometry as geo
from pointnav_vo_tpu_torch.rl.trainer import act_step, propagate_goal
from pointnav_vo_tpu_torch.vo.ensemble import frame_features_packed


STUCK_THRESH = 0.01  # m: a predicted translation below this is "near zero"


@torch.no_grad()
def fused_vo_act_step(policy, vo, prev_feats, cur_rgb, cur_depth, actions_np,
                      goal_cart, reset_mask, sensor_polar, hidden, prev_actions,
                      masks, est_rot, est_pos, est_seed_rot, est_seed_pos, *,
                      deterministic=True, generator=None, vo_masks=None):
    """One eval step for all envs.

    ``prev_feats`` is the previous call's ``cur_feats`` (or
    ``frame_features_packed`` of the start frame); ``actions_np`` are the
    host actions just taken, which pick each sample's expert.  In rnd mode
    the VO's dropout keep masks are ``vo_masks`` or drawn from
    ``generator``; with ``deterministic=False`` the action is drawn from
    ``generator`` after them.  The drift pose ``(est_rot, est_pos)`` is
    integrated through the delta and re-seeded where ``reset_mask`` fires.
    Returns ``(goal_cart, polar, delta, std, value, action, logp, hidden,
    cur_feats, est_rot, est_pos)``; ``std`` is zero in det mode.
    """
    cur_feats = frame_features_packed(cur_rgb, cur_depth, vo.cfg)
    obs = torch.cat([prev_feats, cur_feats], dim=-1)
    if vo.cfg.mode == "det":
        delta = vo.predict_packed(obs, actions_np)
        std = torch.zeros_like(delta)
    else:
        delta, std = vo.predict_rnd_packed(obs, actions_np, generator, vo_masks)
    goal_cart, polar = propagate_goal(goal_cart, delta, reset_mask, sensor_polar)
    policy_obs = {"rgb": cur_rgb, "depth": cur_depth,
                  "pointgoal_with_gps_compass": polar}
    logits, value, new_hidden = policy(policy_obs, hidden, prev_actions, masks)
    action = mode_action(logits) if deterministic else sample_action(generator, logits)
    new_rot, new_pos = geo.compute_global_state(est_rot, est_pos, delta)
    new_rot = torch.where(reset_mask > 0, est_seed_rot, new_rot)
    new_pos = torch.where(reset_mask > 0, est_seed_pos, new_pos)
    return (goal_cart, polar, delta, std, value, action, action_log_prob(logits, action),
            new_hidden, cur_feats, new_rot, new_pos)


@dataclasses.dataclass
class EpisodeResult:
    """One finished episode's record; the VO diagnostics are means over the
    episode's live steps (nan when none ran)."""

    success: float
    spl: float
    softspl: float
    distance_to_goal: float
    reward: float
    collisions: float
    steps: int
    vo_l2_mean: float = float("nan")
    vo_pred_std_mean: float = float("nan")
    drift_mean: float = float("nan")
    episode_id: int = -1
    # completely-stuck counters: counted only on collision steps of
    # continuing episodes, testing the ground-truth delta for exact 0.0
    dx_stuck: int = 0
    dz_stuck: int = 0
    both_stuck: int = 0


def episode_budgets(num_episodes: int, n_envs: int,
                    available: Optional[List[Optional[int]]] = None):
    """Split the eval quota into a fixed per-env episode budget: env i
    contributes exactly its first ``budget[i]`` episodes, a deterministic
    distinct set.  ``available`` holds per-env episode counts (None =
    unbounded); the quota is clamped to the total with a warning, then
    round-robin waterfilled.  Returns ``(budgets, clamped_num_episodes)``."""
    caps = [(c if c is not None else num_episodes)
            for c in (available if available is not None else [None] * n_envs)]
    total_cap = sum(caps)
    if total_cap < num_episodes:
        logging.getLogger(__name__).warning(
            "requested %d eval episodes but envs only hold %d; evaluating all %d",
            num_episodes, total_cap, total_cap)
        num_episodes = total_cap
    budgets = [0] * n_envs
    remaining = num_episodes
    while remaining > 0:
        progressed = False
        for i in range(n_envs):
            if remaining == 0:
                break
            if budgets[i] < caps[i]:
                budgets[i] += 1
                remaining -= 1
                progressed = True
        if not progressed:
            raise RuntimeError("waterfill stalled despite clamped quota")
    return budgets, num_episodes


class Evaluator:
    """Batched eval loop over a VectorEnv.  ``device=None`` means the card,
    and raises where there is none.  ``generator`` (on the device; seeded 0
    when not given) feeds the VO's rnd-mode dropout and, with
    ``deterministic=False``, the policy's action draws."""

    def __init__(self, *, model, envs, vo_ensemble, device=None, deterministic=True,
                 generator: Optional[torch.Generator] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.envs = envs
        self.vo = vo_ensemble
        if self.vo.device != self.device:
            raise ValueError(f"VO ensemble on {self.vo.device}, evaluator on {self.device}")
        self.deterministic = deterministic
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, evaluator on {self.device}")
        self.generator = generator
        self.results: List[EpisodeResult] = []

    def _to_device(self, obs: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in obs.items():
            a = np.asarray(v)
            if k == "rgb" and a.dtype != np.uint8:
                # ship rgb as uint8: 4x fewer host->device bytes per step
                # (every consumer casts before /255; the scripted env's rgb
                # is clipped to [0, 255])
                a = a.astype(np.uint8)
            out[k] = torch.from_numpy(a).to(self.device)
        return out

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    @torch.no_grad()
    def run(self, num_episodes: int) -> Dict[str, float]:
        """Evaluate an EXACT set of ``num_episodes`` distinct episodes; env i
        contributes precisely its first ``budget[i]`` episodes, and envs whose
        budget is met keep stepping but are masked out of every metric."""
        envs, dev = self.envs, self.device
        n = envs.num_envs
        obs = envs.reset()
        budgets_l, num_episodes = episode_budgets(num_episodes, n,
                                                  envs.number_of_episodes())
        budgets = np.asarray(budgets_l, np.int64)
        ep_counted = np.zeros(n, np.int64)
        active = budgets > 0
        counted_keys: set = set()

        hidden = self.model.initial_hidden(n, device=dev)
        prev_actions = torch.zeros((n, 1), dtype=torch.long, device=dev)
        masks = torch.zeros((n, 1), device=dev)

        goal_cart = geo.pointgoal_polar2cartesian(
            self._tensor(obs["pointgoal_with_gps_compass"]))
        est_seed_rot = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev).repeat(n, 1)
        est_seed_pos = torch.zeros((n, 3), device=dev)
        est_rot, est_pos = est_seed_rot, est_seed_pos

        obs_dev = self._to_device(obs)
        episode_rewards = np.zeros(n)
        results: List[EpisodeResult] = []
        vo_l2: List[np.ndarray] = []
        vo_std: List[np.ndarray] = []
        drift: List[float] = []
        # live MOVE_FORWARD steps whose PREDICTED translation is under
        # STUCK_THRESH (not the reference's collision-gated stuck metric)
        vo_near_zero = {"dx": 0, "dz": 0, "both": 0}
        timing = {"env": 0.0, "device": 0.0, "transfer": 0.0}
        steps = 0
        ep_steps = np.zeros(n, np.int64)
        ep_vo_sum = np.zeros(n)
        ep_vo_cnt = np.zeros(n)
        ep_std_sum = np.zeros(n)
        ep_drift_sum = np.zeros(n)
        ep_drift_cnt = np.zeros(n)
        ep_dx_stuck = np.zeros(n, np.int64)
        ep_dz_stuck = np.zeros(n, np.int64)
        ep_both_stuck = np.zeros(n, np.int64)

        act_gen = None if self.deterministic else self.generator
        _v, action, _lp, hidden = act_step(self.model, obs_dev, hidden,
                                           prev_actions, masks, act_gen)
        # every frame's features are computed once and carried to the next
        # step (envs auto-reset, so the cache always matches the returned obs)
        feats_cache = frame_features_packed(obs_dev["rgb"], obs_dev["depth"],
                                            self.vo.cfg)
        actions_np = action[:, 0].cpu().numpy()

        while active.any():
            t0 = time.perf_counter()
            new_obs, rewards, dones, infos = envs.step(actions_np)
            timing["env"] += time.perf_counter() - t0
            # only steps of counted episodes
            steps += int(active.sum())
            ep_steps += 1
            episode_rewards += rewards
            for i, info in enumerate(infos):
                if active[i] and not dones[i] and info["collisions"]["is_collision"]:
                    g = info["gt_delta"]
                    dx0 = float(g[0]) == 0.0
                    dz0 = float(g[1]) == 0.0
                    ep_dx_stuck[i] += dx0
                    ep_dz_stuck[i] += dz0
                    ep_both_stuck[i] += dx0 and dz0

            t0 = time.perf_counter()
            new_obs_dev = self._to_device(new_obs)
            timing["transfer"] += time.perf_counter() - t0

            t0 = time.perf_counter()
            reset = self._tensor(dones)[:, None]
            (goal_cart, _polar, delta, std, _value, next_action, _lp, hidden,
             feats_cache, est_rot, est_pos) = fused_vo_act_step(
                self.model, self.vo, feats_cache, new_obs_dev["rgb"],
                new_obs_dev["depth"], actions_np, goal_cart, reset,
                new_obs_dev["pointgoal_with_gps_compass"], hidden, action,
                1.0 - reset, est_rot, est_pos, est_seed_rot, est_seed_pos,
                deterministic=self.deterministic, generator=self.generator)
            # one packed read-back per step: delta, std, next action, drift pose
            fetched = torch.cat([delta, std, next_action.float(), est_pos],
                                dim=1).cpu().numpy()
            delta_np = fetched[:, :3]
            std_np = fetched[:, 3:6]
            next_actions_np = fetched[:, 6].astype(np.int64)
            est = fetched[:, 7:10]

            gt = np.stack([i["gt_delta"] for i in infos])
            live = ~dones & active
            if live.any():
                errs_all = np.linalg.norm(delta_np - gt, axis=-1)
                vo_l2.append(errs_all[live])
                vo_std.append(std_np[live])
                ep_vo_sum += np.where(live, errs_all, 0.0)
                ep_std_sum += np.where(live, std_np.mean(-1), 0.0)
                ep_vo_cnt += live
                fwd = live & (actions_np == MOVE_FORWARD)
                dx_small = np.abs(delta_np[:, 0]) < STUCK_THRESH
                dz_small = np.abs(delta_np[:, 1]) < STUCK_THRESH
                vo_near_zero["dx"] += int((fwd & dx_small & ~dz_small).sum())
                vo_near_zero["dz"] += int((fwd & dz_small & ~dx_small).sum())
                vo_near_zero["both"] += int((fwd & dx_small & dz_small).sum())
            # dead-reckoned drift against the true episodic pose
            for i, info in enumerate(infos):
                if active[i] and not dones[i]:
                    d_i = float(np.linalg.norm(est[i] - info["agent_pos_episodic"]))
                    drift.append(d_i)
                    ep_drift_sum[i] += d_i
                    ep_drift_cnt[i] += 1
            timing["device"] += time.perf_counter() - t0

            for i, d in enumerate(dones):
                if not d:
                    continue
                if active[i]:
                    info = infos[i]
                    # distinct-set guarantee: per-env monotonic episode ids
                    key = (i, int(info["episode_id"]))
                    if key in counted_keys:
                        raise RuntimeError(
                            f"episode {key} finished twice during exact-set eval "
                            f"(env {i}, {ep_counted[i]}/{budgets[i]} counted): the "
                            "env iterator cycled before its budget was met")
                    counted_keys.add(key)
                    nan = float("nan")
                    results.append(EpisodeResult(
                        success=info["success"],
                        spl=info["spl"],
                        softspl=info["softspl"],
                        distance_to_goal=info["distance_to_goal"],
                        reward=float(episode_rewards[i]),
                        collisions=float(info["collisions"]["count"]),
                        steps=int(ep_steps[i]),
                        vo_l2_mean=(float(ep_vo_sum[i] / ep_vo_cnt[i])
                                    if ep_vo_cnt[i] else nan),
                        vo_pred_std_mean=(float(ep_std_sum[i] / ep_vo_cnt[i])
                                          if ep_vo_cnt[i] else nan),
                        drift_mean=(float(ep_drift_sum[i] / ep_drift_cnt[i])
                                    if ep_drift_cnt[i] else nan),
                        episode_id=int(info["episode_id"]),
                        dx_stuck=int(ep_dx_stuck[i]),
                        dz_stuck=int(ep_dz_stuck[i]),
                        both_stuck=int(ep_both_stuck[i]),
                    ))
                    ep_counted[i] += 1
                    if ep_counted[i] >= budgets[i]:
                        active[i] = False
                episode_rewards[i] = 0.0
                ep_steps[i] = 0
                ep_vo_sum[i] = ep_std_sum[i] = ep_vo_cnt[i] = 0
                ep_drift_sum[i] = ep_drift_cnt[i] = 0
                ep_dx_stuck[i] = ep_dz_stuck[i] = ep_both_stuck[i] = 0

            action = next_action
            actions_np = next_actions_np

        if len(results) != num_episodes:
            raise RuntimeError(f"counted {len(results)} episodes, expected {num_episodes}")
        if len(counted_keys) != num_episodes:
            raise RuntimeError("episode keys not distinct")

        agg = {
            "episodes": float(len(results)),
            "success": float(np.mean([r.success for r in results])),
            "spl": float(np.mean([r.spl for r in results])),
            "softspl": float(np.mean([r.softspl for r in results])),
            "distance_to_goal": float(np.mean([r.distance_to_goal for r in results])),
            "reward": float(np.mean([r.reward for r in results])),
            "collisions": float(np.mean([r.collisions for r in results])),
            "total_env_steps": float(steps),
            # act and vo run in one fused step: their time is time_device_s
            "time_act_s": 0.0,
            "time_env_s": timing["env"],
            "time_vo_s": 0.0,
            "time_device_s": timing["device"],
            "time_transfer_s": timing["transfer"],
            "stuck_dx": float(sum(r.dx_stuck for r in results)),
            "stuck_dz": float(sum(r.dz_stuck for r in results)),
            "stuck_both": float(sum(r.both_stuck for r in results)),
        }
        self.results = results
        if vo_l2:
            cat = np.concatenate(vo_l2)
            agg["vo_l2_mean"] = float(cat.mean())
            agg["vo_l2_max"] = float(cat.max())
            agg["vo_pred_std_mean"] = float(np.concatenate(vo_std).mean())
            agg["vo_near_zero_dx"] = float(vo_near_zero["dx"])
            agg["vo_near_zero_dz"] = float(vo_near_zero["dz"])
            agg["vo_near_zero_both"] = float(vo_near_zero["both"])
        if drift:
            agg["global_drift_mean"] = float(np.mean(drift))
        return agg
