"""Policy + VO evaluation (counterpart of ``rl/eval.py``).

:meth:`Evaluator.run` evaluates an exact set of distinct episodes over a
vector env (in process, or the shm farm of ``native/shm_env.py``) in one
of three loops:

- fused (a VO ensemble, the default): each step steps the envs on the
  host, then runs :func:`fused_vo_act_step` on the device for all envs at
  once: features of the new frame (the previous frame's are cached), each
  sample's own VO expert, goal dead-reckoning, the next policy act and the
  drift pose; one packed read brings back what the host bookkeeping needs.
  With ``PNVO_EVAL_ASYNC=1`` and an env with ``step_async``, the next
  step's actions go to the envs right after that read, and the host
  bookkeeping overlaps their simulation;
- unfused (``fused=False``, or a ``vo_fn`` hook): the policy acts, the envs
  step, then the VO delta of both frames (:meth:`VOEnsemble.compute_local_
  delta_states_from_vo`, or ``vo_fn``), the goal update and the drift
  integration, each its own call;
- GPS-only (no ensemble, no hook): the policy reads the env's own goal
  sensor; no VO, no drift.

Tracked diagnostics follow the reference's accounting: navigation metrics
on episode end, per-step VO L2 error against the env's ground-truth delta,
dead-reckoned drift against the true episodic pose (where the env reports
``agent_pos``), and the collision-gated stuck counters.  The VO runs in
det or rnd mode (rnd: the mean and std over dropout passes, the std
reported as ``vo_pred_std_mean``); the policy acts by its mode or, with
``deterministic=False``, samples.  Both draw from one ``torch.Generator``
on the device, in the same order on every loop.  ``run`` also writes eval
videos (``vis/maps.py``) and the worst VO errors as ranked images.  The
multi-device path is not ported.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from pointnav_vo_tpu_torch.common import MOVE_FORWARD, resolve_device
from pointnav_vo_tpu_torch.models.policy import action_log_prob, mode_action, sample_action
from pointnav_vo_tpu_torch.ops import geometry as geo
from pointnav_vo_tpu_torch.rl.trainer import act_step, propagate_goal
from pointnav_vo_tpu_torch.vo.ensemble import frame_features_packed


def _integrate_global(est_rot, est_pos, delta, reset_mask, seed_rot, seed_pos):
    """Dead-reckon a global pose through VO deltas, re-seeded where
    ``reset_mask`` marks a new episode."""
    new_rot, new_pos = geo.compute_global_state(est_rot, est_pos, delta)
    return (torch.where(reset_mask > 0, seed_rot, new_rot),
            torch.where(reset_mask > 0, seed_pos, new_pos))


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
    new_rot, new_pos = _integrate_global(est_rot, est_pos, delta, reset_mask, est_seed_rot,
                                         est_seed_pos)
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
    """Batched eval loop over a vector env.

    ``vo_ensemble`` (det or rnd) dead-reckons the goal, fused by default;
    ``fused=False`` runs the unfused loop.  ``vo_fn(prev_obs, new_obs,
    actions_np, infos) -> (delta, std)``, both ``[N, 3]`` tensors on the
    device, takes the ensemble's place (the obs are the device copies).
    With neither, the policy navigates by the env's goal sensor.
    ``device=None`` means the card, and raises where there is none.
    ``generator`` (on the device; seeded 0 when not given) feeds the rnd
    dropout and, with ``deterministic=False``, the action draws.  A
    predicted forward translation under ``stuck_thresh`` m counts as near
    zero."""

    def __init__(self, *, model, envs, vo_ensemble=None, vo_fn: Optional[Callable] = None,
                 device=None, deterministic=True,
                 generator: Optional[torch.Generator] = None, stuck_thresh: float = 0.01,
                 fused: Optional[bool] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.envs = envs
        self.vo = vo_ensemble
        self.vo_fn = vo_fn
        if self.vo is not None and self.vo.device != self.device:
            raise ValueError(f"VO ensemble on {self.vo.device}, evaluator on {self.device}")
        self.deterministic = deterministic
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, evaluator on {self.device}")
        self.generator = generator
        self.stuck_thresh = stuck_thresh
        self.force_fused = fused
        self.results: List[EpisodeResult] = []
        self.episode_keys: list = []

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

    def _vo_delta(self, prev_obs, new_obs, actions_np, infos):
        """(delta, std) of the unfused loop from the device copies of both
        frames; ``actions_np`` (host) picks each sample's expert."""
        if self.vo_fn is not None:
            return self.vo_fn(prev_obs, new_obs, actions_np, infos)
        delta, std, _ = self.vo.compute_local_delta_states_from_vo(
            prev_obs["rgb"], prev_obs["depth"], new_obs["rgb"], new_obs["depth"],
            actions_np, generator=self.generator)
        return delta, std

    @torch.no_grad()
    def run(self, num_episodes: int, log_fn=None, video_dir: Optional[str] = None,
            video_episodes: int = 0, ranked_img_dir: Optional[str] = None,
            rank_top_k: int = 20, tb_writer=None) -> Dict[str, float]:
        """Evaluate an EXACT set of ``num_episodes`` distinct episodes; env i
        contributes precisely its first ``budget[i]`` episodes, and envs whose
        budget is met keep stepping but are masked out of every metric.

        ``log_fn(k, result)`` sees each counted episode.  The first
        ``video_episodes`` episodes of env 0 become ``video_dir/episode_<k>.mp4``
        (and/or go to ``tb_writer``), each frame ``[rgb | top-down map]``
        where the env reports poses; ``ranked_img_dir`` receives the
        ``rank_top_k`` worst VO steps as images and a manifest.  The counted
        episodes' keys stay in ``episode_keys``, their records in
        ``results``."""
        envs, dev = self.envs, self.device
        n = envs.num_envs
        # reset first: the shm farm learns its workers' episode counts from
        # their first payloads
        obs = envs.reset()
        budgets_l, num_episodes = episode_budgets(num_episodes, n,
                                                  envs.number_of_episodes())
        budgets = np.asarray(budgets_l, np.int64)
        ep_counted = np.zeros(n, np.int64)
        active = budgets > 0
        counted_keys: dict = {}  # an ordered set
        frames: List[np.ndarray] = []
        map_renderer = None
        videos_done = 0
        ranked_records: List[dict] = []

        hidden = self.model.initial_hidden(n, device=dev)
        prev_actions = torch.zeros((n, 1), dtype=torch.long, device=dev)
        masks = torch.zeros((n, 1), device=dev)

        use_vo = self.vo is not None or self.vo_fn is not None
        fused = self.vo is not None and self.vo_fn is None
        if self.force_fused is not None:
            fused = fused and self.force_fused
        can_async = (fused and hasattr(envs, "step_async")
                     and os.environ.get("PNVO_EVAL_ASYNC", "0") == "1")
        pending_step = False
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
        # stuck_thresh (not the reference's collision-gated stuck metric)
        vo_near_zero = {"dx": 0, "dz": 0, "both": 0}
        # fused, act and vo run in one step: their time is "device"
        timing = {"act": 0.0, "env": 0.0, "vo": 0.0, "device": 0.0, "transfer": 0.0}
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
        if fused:
            _v, action, _lp, hidden = act_step(self.model, obs_dev, hidden, prev_actions,
                                               masks, act_gen)
            # every frame's features are computed once and carried to the
            # next step (envs auto-reset, so the cache matches the returned obs)
            feats_cache = frame_features_packed(obs_dev["rgb"], obs_dev["depth"],
                                                self.vo.cfg)
            actions_np = action[:, 0].cpu().numpy()

        while active.any():
            if not fused:
                t0 = time.perf_counter()
                _v, action, _lp, hidden = act_step(self.model, obs_dev, hidden,
                                                   prev_actions, masks, act_gen)
                actions_np = action[:, 0].cpu().numpy()
                timing["act"] += time.perf_counter() - t0

            t0 = time.perf_counter()
            if pending_step:
                # pushed before the last step's bookkeeping: collect it
                new_obs, rewards, dones, infos = envs.step_wait()
                pending_step = False
            else:
                new_obs, rewards, dones, infos = envs.step(actions_np)
            timing["env"] += time.perf_counter() - t0
            # only steps of counted episodes
            steps += int(active.sum())
            ep_steps += 1
            episode_rewards += rewards
            # completely stuck: collision steps of continuing episodes whose
            # ground-truth translation is exactly 0 (independent of the VO)
            for i, info in enumerate(infos):
                if (active[i] and not dones[i]
                        and int(info.get("collisions", {}).get("is_collision", 0))
                        and "gt_delta" in info):
                    g = info["gt_delta"]
                    dx0 = float(g[0]) == 0.0
                    dz0 = float(g[1]) == 0.0
                    ep_dx_stuck[i] += dx0
                    ep_dz_stuck[i] += dz0
                    ep_both_stuck[i] += dx0 and dz0

            t0 = time.perf_counter()
            new_obs_dev = self._to_device(new_obs)
            timing["transfer"] += time.perf_counter() - t0

            drift_on = "agent_pos" in infos[0]
            if use_vo:
                t0 = time.perf_counter()
                reset = self._tensor(dones)[:, None]
                sensor = new_obs_dev["pointgoal_with_gps_compass"]
                if fused:
                    (goal_cart, polar, delta, std, _value, next_action, _lp, hidden,
                     feats_cache, est_rot, est_pos) = fused_vo_act_step(
                        self.model, self.vo, feats_cache, new_obs_dev["rgb"],
                        new_obs_dev["depth"], actions_np, goal_cart, reset, sensor, hidden,
                        action, 1.0 - reset, est_rot, est_pos, est_seed_rot, est_seed_pos,
                        deterministic=self.deterministic, generator=self.generator)
                    # one packed read-back: delta, std, next action, drift pose
                    fetched = torch.cat([delta, std, next_action.float(), est_pos],
                                        dim=1).cpu().numpy()
                    delta_np, std_np = fetched[:, :3], fetched[:, 3:6]
                    next_actions_np = fetched[:, 6].astype(np.int64)
                    est = fetched[:, 7:10]
                    if can_async:
                        # the envs simulate the next step during the
                        # bookkeeping below; if the loop ends now, the
                        # pushed step is left uncollected (harmless)
                        envs.step_async(next_actions_np)
                        pending_step = True
                else:
                    delta, std = self._vo_delta(obs_dev, new_obs_dev, actions_np, infos)
                    goal_cart, polar = propagate_goal(goal_cart, delta, reset, sensor)
                    delta_np = delta.cpu().numpy()
                    std_np = std.cpu().numpy()
                    if drift_on:
                        est_rot, est_pos = _integrate_global(est_rot, est_pos, delta, reset,
                                                             est_seed_rot, est_seed_pos)
                        est = est_pos.cpu().numpy()
                new_obs_dev["pointgoal_with_gps_compass"] = polar
                gt = np.stack([i["gt_delta"] for i in infos])
                live = ~dones & active
                errs_all = np.linalg.norm(delta_np - gt, axis=-1)
                if ranked_img_dir and live.any() and "rgb" in new_obs:
                    worst = int(np.argmax(np.where(live, errs_all, -1)))
                    ranked_records.append({
                        "vo_l2": float(errs_all[worst]),
                        # the previous frame's device copy, as the VO saw it
                        "prev_rgb": obs_dev["rgb"][worst].cpu().numpy(),
                        "cur_rgb": np.asarray(new_obs["rgb"][worst]),
                        "action": int(actions_np[worst]),
                    })
                    ranked_records = sorted(ranked_records,
                                            key=lambda r: -r["vo_l2"])[: 4 * rank_top_k]
                if live.any():
                    vo_l2.append(errs_all[live])
                    vo_std.append(std_np[live])
                    ep_vo_sum += np.where(live, errs_all, 0.0)
                    ep_std_sum += np.where(live, std_np.mean(-1), 0.0)
                    ep_vo_cnt += live
                    fwd = live & (actions_np == MOVE_FORWARD)
                    dx_small = np.abs(delta_np[:, 0]) < self.stuck_thresh
                    dz_small = np.abs(delta_np[:, 1]) < self.stuck_thresh
                    vo_near_zero["dx"] += int((fwd & dx_small & ~dz_small).sum())
                    vo_near_zero["dz"] += int((fwd & dz_small & ~dx_small).sum())
                    vo_near_zero["both"] += int((fwd & dx_small & dz_small).sum())
                # dead-reckoned drift against the true episodic pose
                if drift_on:
                    for i, info in enumerate(infos):
                        if active[i] and not dones[i]:
                            d_i = float(np.linalg.norm(est[i] - info["agent_pos_episodic"]))
                            drift.append(d_i)
                            ep_drift_sum[i] += d_i
                            ep_drift_cnt[i] += 1
                timing["device" if fused else "vo"] += time.perf_counter() - t0

            if videos_done < video_episodes and "rgb" in new_obs:
                from pointnav_vo_tpu_torch.vis.maps import (
                    TrajectoryMapRenderer,
                    compose_map_frame,
                    generate_video,
                )

                frame = np.asarray(new_obs["rgb"][0]).astype(np.uint8)
                info0 = infos[0]
                if "agent_pos" in info0 and "goal_world" in info0:
                    if map_renderer is None:
                        map_renderer = TrajectoryMapRenderer(info0["agent_pos"],
                                                             info0["goal_world"])
                    map_renderer.add(info0["agent_pos"], info0["agent_yaw"])
                    frame = compose_map_frame(frame, map_renderer.render())
                frames.append(frame)
                if dones[0]:
                    generate_video(frames, video_dir, f"episode_{videos_done}",
                                   tb_writer=tb_writer, tb_step=videos_done)
                    frames = []
                    map_renderer = None
                    videos_done += 1

            for i, d in enumerate(dones):
                if not d:
                    continue
                if active[i]:
                    info = infos[i]
                    # distinct-set guarantee: a dataset-level key (habitat's
                    # scene and episode ids) is global, so two envs finishing
                    # one episode collide; else the env's own episode count
                    key = info.get("episode_key")
                    key = ((i, int(info.get("episode_id", ep_counted[i])))
                           if key is None else tuple(key))
                    if key in counted_keys:
                        raise RuntimeError(
                            f"episode {key} finished twice during exact-set eval "
                            f"(env {i}, {ep_counted[i]}/{budgets[i]} counted): the env "
                            "iterator cycled before its budget was met; check the "
                            "backend's number_of_episodes")
                    counted_keys[key] = None
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
                        episode_id=int(info.get("episode_id", -1)),
                        dx_stuck=int(ep_dx_stuck[i]),
                        dz_stuck=int(ep_dz_stuck[i]),
                        both_stuck=int(ep_both_stuck[i]),
                    ))
                    if log_fn:
                        log_fn(len(results), results[-1])
                    ep_counted[i] += 1
                    if ep_counted[i] >= budgets[i]:
                        active[i] = False
                episode_rewards[i] = 0.0
                ep_steps[i] = 0
                ep_vo_sum[i] = ep_std_sum[i] = ep_vo_cnt[i] = 0
                ep_drift_sum[i] = ep_drift_cnt[i] = 0
                ep_dx_stuck[i] = ep_dz_stuck[i] = ep_both_stuck[i] = 0

            obs_dev = new_obs_dev
            if fused:  # the fused step takes its action and masks itself
                action = next_action
                actions_np = next_actions_np
            else:
                prev_actions = action
                masks = self._tensor(~dones)[:, None]

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
            "time_act_s": timing["act"],
            "time_env_s": timing["env"],
            "time_vo_s": timing["vo"],
            "time_device_s": timing["device"],
            "time_transfer_s": timing["transfer"],
            "stuck_dx": float(sum(r.dx_stuck for r in results)),
            "stuck_dz": float(sum(r.dz_stuck for r in results)),
            "stuck_both": float(sum(r.both_stuck for r in results)),
        }
        self.results = results
        self.episode_keys = list(counted_keys)
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
        if ranked_img_dir and ranked_records:
            from pointnav_vo_tpu_torch.vis.maps import save_ranked_error_images

            save_ranked_error_images(ranked_records, ranked_img_dir, top_k=rank_top_k)
        return agg
