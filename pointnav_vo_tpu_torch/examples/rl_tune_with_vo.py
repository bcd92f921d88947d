"""The reference's four-stage pipeline on the scripted world, rl_tune_vo end
to end (counterpart of ``examples/rl_tune_with_vo.py``).

    python -m pointnav_vo_tpu_torch.examples.rl_tune_with_vo [--pairs 3000] \\
        [--gps-updates 60] [--tune-updates 40] [--out RL_TUNE_VO_torch.json]
    python -m pointnav_vo_tpu_torch.examples.rl_tune_with_vo --device cpu --pairs 300 \\
        --epochs 1 --size 64 --gps-updates 1 --tune-updates 1 --episodes 2 --envs 2  # smoke

TRAIN.md's stages on the scripted world:

1. the three VO experts on the oracle follower's frame pairs (the JAX
   package's HDF5 entries held in memory, ``eval_994.scripted_pairs``),
   stages 1-3 condensed, bf16 mixed precision, batch 128;
2. a navigation policy (``PointNavActorCritic``, bf16 compute) trained
   with GPS goals (the reference's ``rl_no_tune``);
3. that policy evaluated with the ground-truth goal (the GPS-oracle row,
   the bound any VO can reach) and with goals dead-reckoned through the
   trained VO (the deployment condition);
4. the policy fine-tuned with the VO in the loop (``rl_tune_vo``, the
   reference's ``TUNE_WITH_VO``) and evaluated under the same VO.

Every eval runs ``--episodes`` episodes over 8 scripted envs seeded 555.
The record, with the fields of the JAX package's ``RL_TUNE_VO.json`` and
the card's name and power limit, goes to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional

import torch

from pointnav_vo_tpu_torch.common import resolve_device
from pointnav_vo_tpu_torch.examples.eval_994 import card_line, train_experts
from pointnav_vo_tpu_torch.examples.train_rl_scripted import mean_reward
from pointnav_vo_tpu_torch.models.policy import PointNavActorCritic
from pointnav_vo_tpu_torch.rl.envs import EnvConfig, make_scripted_vector_env
from pointnav_vo_tpu_torch.rl.eval import Evaluator
from pointnav_vo_tpu_torch.rl.ppo import PPOConfig
from pointnav_vo_tpu_torch.rl.trainer import DDPPOTrainer
from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble, VOInferenceConfig

EVAL_ENVS = 8  # the JAX script's evaluate()
NUM_STEPS = 64  # the JAX script's rollout length
KEYS = ("success", "softspl", "spl", "distance_to_goal", "vo_l2_mean")


def make_policy(size: int) -> PointNavActorCritic:
    return PointNavActorCritic(image_size=(size, size), compute_dtype=torch.bfloat16)


def evaluate(state_dict, ensemble: Optional[VOEnsemble], env_cfg: EnvConfig, episodes: int,
             seed: int, device) -> Dict[str, float]:
    """``episodes`` episodes of the policy holding ``state_dict`` over
    EVAL_ENVS scripted envs seeded ``seed``, the goal dead-reckoned through
    ``ensemble`` (the ground truth where it is None)."""
    policy = make_policy(env_cfg.image_h)
    policy.load_state_dict(state_dict, strict=True)
    envs = make_scripted_vector_env(env_cfg, EVAL_ENVS, seed=seed)
    ev = Evaluator(model=policy, envs=envs, vo_ensemble=ensemble, device=device,
                   generator=torch.Generator(device=device).manual_seed(9))
    return {k: float(v) for k, v in ev.run(episodes).items()}


def train_stage(tag: str, trainer: DDPPOTrainer, updates: int, log) -> None:
    for update in range(1, updates + 1):
        trainer.collect_rollout()
        trainer.update_agent()
        if update % 10 == 0:
            log(f"  [{tag} {update:3d}] mean_ep_reward {mean_reward(trainer):7.3f}")


def _state(trainer: DDPPOTrainer) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}


def run(pairs: int = 3000, epochs: int = 4, size: int = 64, gps_updates: int = 60,
        tune_updates: int = 40, episodes: int = 48, n_envs: int = 8, device=None,
        log=print) -> Dict:
    dev = resolve_device(device)
    t_pipeline = time.perf_counter()
    env_cfg = EnvConfig(image_h=size, image_w=size, max_episode_steps=60,
                        actuation_noise_multiplier=0.5, room_radius_range=(3.0, 5.0))

    # -- stages 1-3: the VO experts
    icfg = VOInferenceConfig(vis_size_w=size, vis_size_h=size, precision="bf16")
    log(f"generating {pairs} pairs at {size}x{size} ...")
    experts, vo_record = train_experts(icfg, env_cfg, pairs, 0, epochs, 128, dev, log=log)
    ensemble = VOEnsemble(icfg, experts=experts, device=dev)

    # -- the GPS policy (rl_no_tune)
    cfg = PPOConfig(num_steps=NUM_STEPS, num_mini_batch=2, ppo_epoch=2, lr=2.5e-4,
                    entropy_coef=0.01, use_normalized_advantage=True)
    envs = make_scripted_vector_env(env_cfg, n_envs, seed=0)
    trainer = DDPPOTrainer(model=make_policy(size), ppo_cfg=cfg, envs=envs, device=dev,
                           total_updates=gps_updates)
    log(f"training GPS policy: {gps_updates} updates ...")
    train_stage("gps", trainer, gps_updates, log)
    gps_state = _state(trainer)

    # -- the GPS oracle (the same policy, the ground-truth goal), then the trained VO
    log("evaluating GPS-trained policy under GPS oracle ...")
    gps_oracle = evaluate(gps_state, None, env_cfg, episodes, 555, dev)
    log("evaluating GPS-trained policy under trained VO ...")
    no_tune = evaluate(gps_state, ensemble, env_cfg, episodes, 555, dev)

    # -- tune with the VO in the loop (rl_tune_vo)
    log(f"tuning with VO in the loop: {tune_updates} updates ...")
    envs2 = make_scripted_vector_env(env_cfg, n_envs, seed=100)
    tuner = DDPPOTrainer(model=make_policy(size), ppo_cfg=cfg, envs=envs2, device=dev,
                         state_dict=gps_state, vo_ensemble=ensemble,
                         generator=torch.Generator(device=dev).manual_seed(1),
                         total_updates=tune_updates)
    train_stage("tune", tuner, tune_updates, log)
    log("evaluating tuned policy under the same VO ...")
    tuned = evaluate(_state(tuner), ensemble, env_cfg, episodes, 555, dev)

    nan = float("nan")
    log("=== GPS oracle | rl_no_tune (VO-evaluated) | rl_tune_vo ===")
    for k in KEYS:
        log(f"  {k:18s}: {gps_oracle.get(k, nan):7.3f} | {no_tune.get(k, nan):7.3f} -> "
            f"{tuned.get(k, nan):7.3f}")
    return {
        "protocol": ("3-row quality ladder, shared seeds/episodes: "
                     "(i) GPS-trained policy + GPS oracle goal, "
                     "(ii) same policy + trained-VO goal (rl_no_tune), "
                     "(iii) VO-in-the-loop fine-tuned policy + same VO "
                     "(rl_tune_vo) - reference TRAIN.md stage 4, "
                     "ppo_trainer.py:206-239"),
        "world": "scripted (habitat-free), PointNavActorCritic (bf16 compute)",
        "resolution": [size, size],
        "episodes": episodes,
        "envs": n_envs,
        "vo_pairs": pairs,
        "gps_updates": gps_updates,
        "tune_updates": tune_updates,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "card": card_line() if dev.type == "cuda" else None,
        "pipeline_wall_clock_min": (time.perf_counter() - t_pipeline) / 60,
        "vo_train": vo_record,
        "gps_oracle": gps_oracle,
        "no_tune": no_tune,
        "tune_vo": tuned,
        "tune_improvement": {k: tuned.get(k, nan) - no_tune.get(k, nan)
                             for k in KEYS if k in tuned and k in no_tune},
        "gps_vs_vo_gap_after_tune": {k: gps_oracle.get(k, nan) - tuned.get(k, nan)
                                     for k in ("success", "softspl", "spl") if k in tuned},
    }


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=3000)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--gps-updates", type=int, default=60)
    ap.add_argument("--tune-updates", type=int, default=40)
    ap.add_argument("--episodes", type=int, default=48)
    ap.add_argument("--envs", type=int, default=8)
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--out", default="RL_TUNE_VO_torch.json")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":  # the port's parity convention; bf16 is untouched
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    out = run(args.pairs, args.epochs, args.size, args.gps_updates, args.tune_updates,
              args.episodes, args.envs, dev, log=lambda m: print(m, flush=True))
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {args.out}", flush=True)
    return out


if __name__ == "__main__":
    main()
