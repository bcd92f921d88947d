"""The PointNav-VO loop on the scripted world (counterpart of
``examples/end_to_end_scripted.py``): train the VO, then navigate by the VO
alone.

    python -m pointnav_vo_tpu_torch.examples.end_to_end_scripted [--pairs 4000] [--epochs 6]
    python -m pointnav_vo_tpu_torch.examples.end_to_end_scripted --device cpu --pairs 64 \\
        --eval-pairs 32 --epochs 1 --batch 16 --size 32 --episodes 4 --envs 2   # smoke size

Trains the three action-conditioned experts on the oracle follower's frame
pairs (``examples/eval_994.py::train_experts``: stage 1 forward and the
joint left/right stage with the inverse loss, bf16 mixed precision), puts
them in the ensemble, then runs ``Evaluator.run`` with the goal-greedy
policy (``eval_994.GreedyGoalPolicy``) reading only the goal dead-reckoned
through the trained VO (no GPS, no ground truth), and reports success,
SPL, the VO's error and the drift.  ``--out`` writes the record as JSON.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import torch

from pointnav_vo_tpu_torch.common import resolve_device
from pointnav_vo_tpu_torch.examples.eval_994 import GreedyGoalPolicy, train_experts
from pointnav_vo_tpu_torch.rl.envs import EnvConfig, make_scripted_vector_env
from pointnav_vo_tpu_torch.rl.eval import Evaluator
from pointnav_vo_tpu_torch.vo.ensemble import VOEnsemble, VOInferenceConfig


def run(pairs: int = 4000, eval_pairs: int = 384, epochs: int = 6, batch: int = 128,
        size: int = 96, episodes: int = 50, n_envs: int = 8, device=None, log=print) -> Dict:
    dev = resolve_device(device)
    env_cfg = EnvConfig(image_h=size, image_w=size, max_episode_steps=120,
                        actuation_noise_multiplier=0.5)
    icfg = VOInferenceConfig(vis_size_w=size, vis_size_h=size, precision="bf16")
    experts, vo_record = train_experts(icfg, env_cfg, pairs, eval_pairs, epochs, batch, dev,
                                       log=log)
    ensemble = VOEnsemble(icfg, experts=experts, device=dev)
    log(f"navigating {episodes} episodes by VO dead-reckoning alone ...")
    envs = make_scripted_vector_env(env_cfg, n_envs, seed=777)
    policy = GreedyGoalPolicy(env_cfg.turn_angle_deg, env_cfg.success_distance)
    ev = Evaluator(model=policy, envs=envs, vo_ensemble=ensemble, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(3))
    agg = {k: float(v) for k, v in ev.run(episodes).items()}
    log(f"success {agg['success']:.3f} | spl {agg['spl']:.3f} | softspl {agg['softspl']:.3f} "
        f"| dist_to_goal {agg['distance_to_goal']:.3f} m")
    log(f"vo_l2 {agg['vo_l2_mean']:.4f} | drift {agg.get('global_drift_mean', float('nan')):.4f}"
        f" m | steps {agg['total_env_steps']:.0f}")
    return {"pairs": pairs, "eval_pairs": eval_pairs, "epochs": epochs, "batch": batch,
            "resolution": [size, size], "episodes": episodes, "envs": n_envs,
            "device": str(dev), "vo": "3 trained experts, bf16", "vo_train": vo_record,
            "metrics": agg}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=4000)
    ap.add_argument("--eval-pairs", type=int, default=384)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--episodes", type=int, default=50)
    ap.add_argument("--envs", type=int, default=8)
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--out", default=None, help="the JSON record's path (none by default)")
    args = ap.parse_args(argv)
    out = run(args.pairs, args.eval_pairs, args.epochs, args.batch, args.size, args.episodes,
              args.envs, args.device, log=lambda m: print(m, flush=True))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
