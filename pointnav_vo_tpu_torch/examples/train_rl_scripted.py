"""DD-PPO learning demo on the scripted world (counterpart of
``examples/train_rl_scripted.py``).

    python -m pointnav_vo_tpu_torch.examples.train_rl_scripted [--updates 150] [--envs 8]
    python -m pointnav_vo_tpu_torch.examples.train_rl_scripted --device cpu --updates 2 \\
        --envs 2 --size 32 --steps 8 --out rl.json                     # smoke size

Trains the deployed ``PointNavActorCritic`` (ResNet18 + 2-layer LSTM, bf16
compute over float32 parameters) with PPO on GPS-goal episodes (no VO: the
RL machinery alone) and prints the reward trend every 10 updates.  The task
is easy by construction (greedy goal following solves it), so a reward that
climbs toward solved checks rollout collection, GAE, the clipped update and
the recurrent policy end to end.  ``--out`` writes the trend as JSON.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List

import numpy as np
import torch

from pointnav_vo_tpu_torch.common import resolve_device
from pointnav_vo_tpu_torch.models.policy import GOAL_KEY, PointNavActorCritic
from pointnav_vo_tpu_torch.rl.envs import EnvConfig, make_scripted_vector_env
from pointnav_vo_tpu_torch.rl.ppo import PPOConfig
from pointnav_vo_tpu_torch.rl.trainer import DDPPOTrainer


class DepthGoalEnvs:
    """A vector env whose observations keep only what the depth policy
    reads (depth and the point goal): no rollout memory spent on rgb."""

    KEYS = ("depth", GOAL_KEY)

    def __init__(self, inner):
        self.inner = inner
        self.num_envs = inner.num_envs

    def reset(self):
        return self._f(self.inner.reset())

    def step(self, actions):
        obs, rewards, dones, infos = self.inner.step(actions)
        return self._f(obs), rewards, dones, infos

    def close(self):
        self.inner.close()

    @classmethod
    def _f(cls, obs):
        return {k: obs[k] for k in cls.KEYS}


def mean_reward(trainer: DDPPOTrainer) -> float:
    """The mean reward of the trainer's window of finished episodes (nan
    before the first)."""
    return float(np.mean(trainer.reward_window)) if trainer.reward_window else float("nan")


def run(updates: int = 150, n_envs: int = 8, size: int = 64, steps: int = 64, device=None,
        log=print) -> Dict:
    """The demo; returns its record (the trend every 10 updates and the
    final mean episode reward)."""
    dev = resolve_device(device)
    env_cfg = EnvConfig(image_h=size, image_w=size, max_episode_steps=60,
                        actuation_noise_multiplier=0.0, rgb_noise_intensity=0.0,
                        depth_noise_multiplier=0.0, room_radius_range=(3.0, 5.0))
    envs = DepthGoalEnvs(make_scripted_vector_env(env_cfg, n_envs, seed=0))
    policy = PointNavActorCritic(image_size=(size, size), compute_dtype=torch.bfloat16)
    cfg = PPOConfig(num_steps=steps, num_mini_batch=2, ppo_epoch=2, lr=2.5e-4,
                    entropy_coef=0.01, use_normalized_advantage=True)
    trainer = DDPPOTrainer(model=policy, ppo_cfg=cfg, envs=envs, device=dev,
                           total_updates=updates)
    trend: List[Dict] = []
    for update in range(1, updates + 1):
        trainer.collect_rollout()
        stats = trainer.update_agent()
        if update % 10 == 0 or update == 1:
            r = mean_reward(trainer)
            trend.append({"update": update, "mean_ep_reward": r, **stats,
                          "count_steps": trainer.count_steps})
            log(f"update {update:4d}: mean_ep_reward {r:7.3f} | "
                f"value_loss {stats['value_loss']:.4f} | "
                f"entropy {stats['dist_entropy']:.3f} | steps {trainer.count_steps}")
    envs.close()
    final = mean_reward(trainer)
    log(f"final mean episode reward: {final}")
    return {"updates": updates, "envs": n_envs, "resolution": [size, size], "num_steps": steps,
            "policy": "PointNavActorCritic resnet18+LSTMx2, bf16 compute",
            "device": str(dev), "reward_trend": trend, "final_mean_ep_reward": final,
            "count_steps": trainer.count_steps}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--updates", type=int, default=150)
    ap.add_argument("--envs", type=int, default=8)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--out", default=None, help="the JSON record's path (none by default)")
    args = ap.parse_args(argv)
    out = run(args.updates, args.envs, args.size, args.steps, args.device,
              log=lambda m: print(m, flush=True))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
