"""Trajectory maps of replayed episodes (counterpart of
``examples/vis_trajectory.py``, the reference notebook
``vis_top_down_map.ipynb`` as a script).

    python -m pointnav_vo_tpu_torch.examples.vis_trajectory --episodes 0 3 7 --out traj
    python -m pointnav_vo_tpu_torch.examples.vis_trajectory --vo-ckpt ckpt_epoch_6.pt --video

Replays episodes of the scripted world by id (``reset_to_episode``), drives
them with the oracle goal follower, and draws each one's top-down map: the
ground-truth path, the dead-reckoned path (through a trained VO ensemble
with ``--vo-ckpt``, else through the ground-truth deltas, where it is the
ground-truth path) in blue, and the goal, as ``episode_<id>.png`` (``.npy``
where ``cv2`` is missing), with ``--video`` also an MP4 of the map growing.
``--vo-ckpt`` is one of the port's VO checkpoints (``VORegressionEngine.
save_ckpt``) holding the three experts, forward, left and right.  Each
episode's steps, distance to goal and final drift go to
``<out>/trajectories.json`` with both paths.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from pointnav_vo_tpu_torch.common import VO_EXPERT_ACTIONS, resolve_device
from pointnav_vo_tpu_torch.io.checkpoint import load_checkpoint
from pointnav_vo_tpu_torch.rl.envs import EnvConfig, ScriptedPointNavEnv
from pointnav_vo_tpu_torch.vis.maps import draw_top_down_map, generate_video
from pointnav_vo_tpu_torch.vo.dataset import oracle_goal_follower
from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble, VOInferenceConfig

VO_PATH_COLOR = (40, 80, 220)


def load_vo(ckpt_path: str, size: int, device) -> VOEnsemble:
    """The det ensemble of a VO checkpoint's three experts at ``size``
    (its stored inference config otherwise); a checkpoint of another
    number of experts (one training stage) is refused."""
    state = load_checkpoint(ckpt_path)
    experts = state["experts"]
    if len(experts) != len(VO_EXPERT_ACTIONS):
        raise SystemExit(
            f"{ckpt_path} holds {len(experts)} expert(s) (a single-stage training "
            f"checkpoint); dead-reckoning needs the full {len(VO_EXPERT_ACTIONS)}-expert "
            "ensemble: finish the 3-stage recipe (TRAIN.md) or pass a checkpoint whose "
            "VO.TRAIN.action_type covered forward+left+right.")
    stored = {k: tuple(v) if isinstance(v, list) else v
              for k, v in state.get("inference_config", {}).items()}
    icfg = VOInferenceConfig(**{**stored, "vis_size_w": size, "vis_size_h": size,
                                "mode": "det"})
    models = []
    for sd in experts:
        m = icfg.make_model()
        m.load_state_dict(sd, strict=True)
        models.append(m)
    return VOEnsemble(icfg, experts=models, device=device)


def run_episode(env: ScriptedPointNavEnv, episode_id: int, follower,
                vo: Optional[VOEnsemble] = None):
    """Returns (gt_path, vo_path, goal, room_radius, steps)."""
    obs = env.reset_to_episode(episode_id)
    gt_path = [tuple(env.pos)]
    vo_path = [tuple(env.pos)]
    est = np.asarray([env.pos[0], env.pos[1]], np.float64)
    est_yaw = env.yaw
    prev_obs = obs
    steps = 0
    while True:
        action = follower(env, obs)
        if action == 0 or env.episode_over:
            break
        obs, _r, done, info = env.step(action)
        steps += 1
        gt_path.append(tuple(env.pos))
        if vo is not None:
            dev = vo.device

            def t(a):
                return torch.from_numpy(np.asarray(a)[None]).to(dev)

            delta, _std, _ = vo.compute_local_delta_states_from_vo(
                t(prev_obs["rgb"]), t(prev_obs["depth"]), t(obs["rgb"]), t(obs["depth"]),
                np.asarray([action], np.int32))
            dx, dz, dyaw = delta[0].float().cpu().numpy()
        else:
            dx, dz, dyaw = info["gt_delta"]
        ca, sa = np.cos(est_yaw), np.sin(est_yaw)
        est = est + np.asarray([ca * dx + sa * dz, -sa * dx + ca * dz])
        est_yaw += dyaw
        vo_path.append((float(est[0]), float(est[1])))
        prev_obs = obs
        if done:
            break
    return gt_path, vo_path, np.asarray(env.goal), env.room_radius, steps


def draw(gt_path, vo_path, goal, radius) -> np.ndarray:
    """The GT path's map with the dead-reckoned path over it in blue
    (identical to the GT path when drawn from GT deltas)."""
    img = draw_top_down_map(gt_path, tuple(goal), radius)
    overlay = draw_top_down_map(vo_path, tuple(goal), radius)
    img[(overlay != 255).any(-1) & (img == 255).all(-1)] = VO_PATH_COLOR
    return img


def run(episodes=(0, 1, 2), seed: int = 0, size: int = 96, out: str = "trajectory_vis",
        vo_ckpt: Optional[str] = None, video: bool = False, device=None, log=print) -> Dict:
    os.makedirs(out, exist_ok=True)
    env_cfg = EnvConfig(image_h=size, image_w=size)
    env = ScriptedPointNavEnv(env_cfg, seed=seed)
    follower = oracle_goal_follower(env_cfg.turn_angle_deg, env_cfg.success_distance)
    vo = load_vo(vo_ckpt, size, resolve_device(device)) if vo_ckpt else None
    try:
        import cv2
    except ImportError:
        cv2 = None
    record = {"seed": seed, "size": size, "vo_ckpt": vo_ckpt, "episodes": {}}
    for ep in episodes:
        gt_path, vo_path, goal, radius, steps = run_episode(env, ep, follower, vo)
        img = draw(gt_path, vo_path, goal, radius)
        if cv2 is not None:
            image = os.path.join(out, f"episode_{ep}.png")
            cv2.imwrite(image, img[..., ::-1])
        else:
            image = os.path.join(out, f"episode_{ep}.npy")
            np.save(image, img)
        drift = float(np.hypot(gt_path[-1][0] - vo_path[-1][0], gt_path[-1][1] - vo_path[-1][1]))
        log(f"episode {ep}: {steps} steps, dist_to_goal={env.dist_to_goal:.2f} m, "
            f"dead-reckoning drift={drift:.3f} m")
        rec = {"steps": steps, "dist_to_goal": float(env.dist_to_goal), "drift_m": drift,
               "image": image, "goal": [float(x) for x in goal], "room_radius": float(radius),
               "gt_path": [[float(x) for x in p] for p in gt_path],
               "vo_path": [[float(x) for x in p] for p in vo_path]}
        if video:
            frames = [draw_top_down_map(gt_path[: i + 2], tuple(goal), radius)
                      for i in range(len(gt_path) - 1)]
            rec["video"] = generate_video(frames, out, f"episode_{ep}_map", fps=5)
        record["episodes"][str(ep)] = rec
    with open(os.path.join(out, "trajectories.json"), "w") as f:
        json.dump(record, f, indent=2)
    return record


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--episodes", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--out", default="trajectory_vis")
    ap.add_argument("--vo-ckpt", default=None,
                    help="the port's VO checkpoint: dead-reckon the drawn path through the "
                         "trained ensemble instead of GT deltas")
    ap.add_argument("--video", action="store_true",
                    help="also write an evolving-map mp4 per episode")
    ap.add_argument("--device", default=None,
                    help="the VO's device (default: the card; only --vo-ckpt uses one)")
    args = ap.parse_args(argv)
    return run(args.episodes, args.seed, args.size, args.out, args.vo_ckpt, args.video,
               args.device, log=lambda m: print(m, flush=True))


if __name__ == "__main__":
    main()
